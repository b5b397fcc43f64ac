"""Multi-process runtime: one process per card (``tpu3dsis/parallel/distributed.py``).

The JAX package starts ``jax.distributed`` so that every process sees one
global device list, and shard_maps its step over a mesh of them. The port
uses PyTorch's idiom instead: one process per card, joined in a
``torch.distributed`` process group; the train step averages its
gradients over the group (``train/trainstep.py``).

The launch is read from the environment, the JAX package's variables or
torchrun's:
  TPU3DSIS_COORDINATOR   host:port of process 0
  TPU3DSIS_NUM_PROCESSES total process count
  TPU3DSIS_PROCESS_ID    this process's rank
  TPU3DSIS_DIST=1        the launcher's own variables (torchrun's RANK,
                         WORLD_SIZE, MASTER_ADDR, MASTER_PORT), which are
                         also taken whenever RANK and WORLD_SIZE are set
Each rank runs on ``cuda:{LOCAL_RANK}`` (the rank itself without
LOCAL_RANK), over NCCL; a CPU run joins over gloo.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def _launch_from_env():
    """(init_method, world size, rank) of the launch the environment
    describes, or None for a single-process run."""
    coord = os.environ.get("TPU3DSIS_COORDINATOR", "")
    if coord:
        return (f"tcp://{coord}", int(os.environ["TPU3DSIS_NUM_PROCESSES"]),
                int(os.environ["TPU3DSIS_PROCESS_ID"]))
    if os.environ.get("TPU3DSIS_DIST", "") == "1" or ("RANK" in os.environ and "WORLD_SIZE" in os.environ):
        return "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    return None


def local_device(device: torch.device | str = "cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` for a CUDA device named
    without an index (the rank where LOCAL_RANK is unset), else ``device``."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    launch = _launch_from_env()
    rank = 0 if launch is None else launch[2]
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))


def initialize_from_env(device: torch.device | str = "cuda") -> bool:
    """Join the process group the environment describes (idempotent).

    Returns True in a distributed run (after joining), False for a plain
    single-process run. ``device`` picks the backend: NCCL for CUDA, after
    pinning this rank to its card (``local_device``), gloo for the CPU.
    """
    if dist.is_initialized():
        return True
    launch = _launch_from_env()
    if launch is None:
        return False
    init_method, world, rank = launch
    device = local_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=init_method,
                            world_size=world, rank=rank)
    return True


def card_count(device: torch.device | str = "cuda") -> int | None:
    """The cards a data-parallel batch may spread over, the counterpart of
    the JAX package's ``len(jax.devices())``: on CUDA the larger of the
    ranks launched and the cards this process sees; None on the CPU, which
    takes a batch of any size."""
    if torch.device(device).type != "cuda":
        return None
    return max(process_info()[1], torch.cuda.device_count())


def process_info(group=None) -> tuple[int, int]:
    """(rank, world size) in ``group`` (the default group), (0, 1) when not
    distributed."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


@torch.no_grad()
def replicate(module: torch.nn.Module, opt=None, group=None, src: int = 0) -> None:
    """Broadcast the parameters and buffers of global rank ``src``, and the
    solver's momentum and update count, to every rank of ``group``
    (``replicate_to_mesh``): after it every rank holds the same state."""
    if not dist.is_initialized():
        return
    tensors = list(module.parameters()) + list(module.buffers())
    if opt is not None:
        tensors += [opt.momentum[k] for k in sorted(opt.momentum)] + [opt.step]
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():  # one flat broadcast a dtype
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.broadcast(flat, src=src, group=group)
        for t, part in zip(same, flat.split([t.numel() for t in same])):
            t.copy_(part.view(t.shape))


def shard_batch(batch: dict, rank: int, world: int) -> dict:
    """This rank's contiguous share of a global batch (every array's leading
    axis cut into ``world`` equal parts; ``shard_batch_to_mesh``). A
    multi-process trainer loads only its own share instead."""
    out = {}
    for k, v in batch.items():
        n = np.shape(v)[0]
        if n % world:
            raise ValueError(f"batch {k!r} of {n} does not split over {world} ranks")
        per = n // world
        out[k] = v[rank * per:(rank + 1) * per]
    return out
