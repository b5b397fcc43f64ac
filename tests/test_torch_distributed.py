"""The port's data-parallel training against the JAX package's, on the CPU.

(a) Two processes joined over gloo by ``initialize_from_env`` (the JAX
package's ``TPU3DSIS_*`` variables) take two steps of ``build_train_step``
with the process group, each on its half of a batch of four 16^3 chunks
with its own draws (the JAX mesh step's, ``fold_in(key, rank)``), against
the JAX package's step over a 2-device mesh on the whole batch: every
metric within 1e-4 relative, the parameters within 1e-4 of each one's
largest magnitude, both ranks' parameters equal; rank 1 starts from other
weights, which ``replicate`` replaces with rank 0's. (b) The launch
variables and ``shard_batch``; a torchrun-style launch of one process.
(c) Two ``Trainer`` processes with ``TPU_DATA_PARALLEL: 2`` take two steps;
only rank 0 writes a snapshot or logs. Every subprocess has its own port and
time limit.
"""

import json
import os
import pickle
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec
from test_torch_train import tiny_cfg, write_chunks

from tpu3dsis.config import default_config as jax_default_config
from tpu3dsis.models import Detector as JaxDetector
from tpu3dsis.train.trainstep import TrainState
from tpu3dsis.train.trainstep import build_train_step as jax_build_train_step
from tpu3dsis_torch import checkpoint as ckpt
from tpu3dsis_torch.config import DetectorConfig, default_config
from tpu3dsis_torch.models.detector import Detector
from tpu3dsis_torch.parallel import distributed as pdist
from tpu3dsis_torch.train.trainstep import anchor_count

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (16, 16, 16)
BATCH, WORLD, STEPS = 4, 2, 2
TIMEOUT = 240  # seconds a subprocess may take

_STEP_WORKER = """
import pickle, sys
import torch
import torch.distributed as dist
from tpu3dsis_torch import checkpoint as ckpt
from tpu3dsis_torch.config import DetectorConfig
from tpu3dsis_torch.models.detector import Detector
from tpu3dsis_torch.parallel import distributed as pdist
from tpu3dsis_torch.train.trainstep import build_train_step

torch.set_num_threads(2)
with open(sys.argv[1], "rb") as f:
    job = pickle.load(f)
assert pdist.initialize_from_env("cpu") and pdist.initialize_from_env("cpu")  # idempotent
rank, world = pdist.process_info()
assert world == 2 and dist.get_backend() == "gloo"
det = Detector(DetectorConfig.from_cfg(job["cfg"]), device="cpu", param_dtype=torch.float32)
det.init_params(torch.Generator().manual_seed(1))
if rank == 0:
    ckpt.load_jax_params(det, job["init"])
opt_init, step = build_train_step(det, job["cfg"], job["shape"], group=dist.group.WORLD)
opt = opt_init()
pdist.replicate(det, opt)
metrics = []
for batch, draws in zip(job["batches"], job["draws"]):
    m = step(opt, pdist.shard_batch(batch, rank, world), draws=draws[rank])
    metrics.append({k: float(v) for k, v in m.items()})
with open(sys.argv[2], "wb") as f:
    pickle.dump({"metrics": metrics, "params": ckpt.module_params(det), "opt_step": int(opt.step)}, f)
dist.destroy_process_group()
"""

_TRAINER_WORKER = """
import json, os, pickle, sys
sys.modules["torch.utils.tensorboard"] = None  # TensorBoard imports TensorFlow where installed, and it JAX
import torch
import torch.distributed as dist
from tpu3dsis_torch.train.loop import Trainer

torch.set_num_threads(2)
with open(sys.argv[1], "rb") as f:
    cfg = pickle.load(f)
rank = int(os.environ["TPU3DSIS_PROCESS_ID"])
trainer = Trainer(cfg, os.path.join(sys.argv[2], f"rank{rank}"), device="cpu")
opt, step = trainer.train(epochs=4, max_steps=2)
total = sum(float(p.double().sum()) for p in trainer.detector.parameters())
print("RESULT", json.dumps({"rank": trainer.process_id, "world": trainer.process_count, "n_dp": trainer.n_dp,
                            "step": step, "opt_step": int(opt.step), "params_sum": total,
                            "snapshot": trainer._snapshot(opt, step)}), flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(tmp_path, script: str, args, n=WORLD) -> list:
    """``script`` in n processes joined by the TPU3DSIS_* variables; their
    stdout, each checked for exit code 0."""
    worker = tmp_path / "worker.py"
    worker.write_text(script)
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, PYTHONPATH=ROOT, TPU3DSIS_COORDINATOR=f"127.0.0.1:{port}",
                   TPU3DSIS_NUM_PROCESSES=str(n), TPU3DSIS_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, str(worker), *[a.format(rank=rank) for a in args]], cwd=ROOT,
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for rank, proc in enumerate(procs):
            out, _ = proc.communicate(timeout=TIMEOUT)
            assert proc.returncode == 0, f"rank {rank} failed:\n{out}"
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def _batch(seed):
    """Four 16^3 chunks of noise, each with one object (its gt box and a
    random mask inside it) and a second one in the first two."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((BATCH, 4, 7), np.float32)
    gt[..., :3] = -1e4
    gt[..., 3:6] = -1e4 + 1
    valid = np.zeros((BATCH, 4), bool)
    data = rng.randn(BATCH, *SHAPE, 2).astype(np.float32) * 0.5
    canvas = np.zeros((BATCH, *SHAPE), np.float32)
    for b in range(BATCH):
        boxes = [[2 + b, 2, 3, 10 + b, 9, 11, 3 + b]] + ([[9, 6, 1, 15, 14, 8, 7]] if b < 2 else [])
        for j, box in enumerate(boxes):
            gt[b, j], valid[b, j] = box, True
            x0, y0, z0, x1, y1, z1 = box[:6]
            canvas[b, x0:x1, y0:y1, z0:z1] = rng.rand(x1 - x0, y1 - y0, z1 - z0) > 0.3
            data[b, x0:x1, y0:y1, z0:z1, 0] += 1.5
    return {"data": data, "gt_box": gt, "gt_valid": valid, "mask_canvas": canvas}


def jax_rank_draws(key, rank, n_local, n_anchor, n_cand):
    """The draws of the JAX mesh step's shard ``rank``: its key folded by
    the shard's index (``trainstep.py:435``), split over its samples, each
    into (k_anchor, k_prop), each split again into the fg and the bg draw."""
    out = {"anchor": [], "proposal": []}
    for k in jax.random.split(jax.random.fold_in(key, rank), n_local):
        ka, kp = jax.random.split(k)
        out["anchor"].append([np.asarray(jax.random.uniform(kk, (n_anchor,))) for kk in jax.random.split(ka)])
        out["proposal"].append([np.asarray(jax.random.uniform(kk, (n_cand,))) for kk in jax.random.split(kp)])
    return {k: np.asarray(v) for k, v in out.items()}


def test_two_process_step_matches_jax_mesh_step(tmp_path):
    jcfg, tcfg = tiny_cfg(jax_default_config()), tiny_cfg(default_config())
    det = Detector(DetectorConfig.from_cfg(tcfg), device="cpu", param_dtype=torch.float32)
    det.init_params(torch.Generator().manual_seed(0))
    init = {k: v.copy() for k, v in ckpt.module_params(det).items()}
    n_anchor = anchor_count(det, SHAPE)
    keys = [jax.random.PRNGKey(20 + i) for i in range(STEPS)]
    batches = [_batch(i) for i in range(STEPS)]
    draws = [[jax_rank_draws(k, r, BATCH // WORLD, n_anchor, 8 + 4) for r in range(WORLD)] for k in keys]
    with open(tmp_path / "job.pkl", "wb") as f:
        pickle.dump({"cfg": tcfg, "shape": SHAPE, "init": init, "batches": batches, "draws": draws}, f)
    procs_out = str(tmp_path / "rank{rank}.pkl")

    # the JAX package's step over a 2-device mesh, compiled without XLA's
    # fusion pass (test_torch_train.py's way to a cheaper CPU compile)
    jdet = JaxDetector(jcfg, anchor_dir="experiments/anchors")
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    jinit, jstep = jax_build_train_step(jdet, jcfg, SHAPE, mesh=mesh)
    params = {k: jax.numpy.asarray(v) for k, v in init.items()}
    state = TrainState(params=params, opt=jinit(params))
    sharding = NamedSharding(mesh, PartitionSpec("data"))
    jm = []
    for i, (batch, key) in enumerate(zip(batches, keys)):
        batch = {k: jax.device_put(v, sharding) for k, v in batch.items()}
        if i == 0:
            jstep = jstep.lower(state, batch, key).compile(compiler_options={"xla_disable_hlo_passes": "fusion"})
        state, m = jstep(state, batch, key)
        jm.append({k: float(v) for k, v in m.items()})
    want = {k: np.asarray(v) for k, v in state.params.items()}

    _run_ranks(tmp_path, _STEP_WORKER, [str(tmp_path / "job.pkl"), procs_out])
    ranks = []
    for r in range(WORLD):
        with open(procs_out.format(rank=r), "rb") as f:
            ranks.append(pickle.load(f))
    for got in ranks:
        assert got["opt_step"] == STEPS and len(got["metrics"]) == STEPS
        for w, g in zip(jm, got["metrics"]):
            assert set(g) == set(w) and w["step_finite"] == 1.0 and w["loss_mask"] > 0
            for k, v in w.items():
                assert abs(g[k] - v) <= 1e-4 * max(abs(v), 1e-6), (k, g[k], v)
        assert set(got["params"]) == set(want)
        for k, w in want.items():
            assert np.abs(got["params"][k] - w).max() <= 1e-4 * np.abs(w).max(), k
    for k in want:
        assert np.array_equal(ranks[0]["params"][k], ranks[1]["params"][k]), k
    assert any(not np.array_equal(ranks[0]["params"][k], init[k]) for k in init)


_LAUNCH = """
import os
import torch.distributed as dist
from tpu3dsis_torch.parallel import distributed as pdist
assert pdist.initialize_from_env("cpu")
assert pdist.process_info() == (0, 1) and dist.get_backend() == "gloo"
dist.destroy_process_group()
print("JOINED")
"""


def test_initialize_from_env_reads_both_launches(monkeypatch, tmp_path):
    """No launch variables: a single process, (0, 1). The JAX package's
    variables and torchrun's name the rendezvous, the world and the rank;
    a CUDA device without an index is cuda:LOCAL_RANK (else the rank's).
    A torchrun-style launch of one process joins over gloo on the CPU.
    ``shard_batch`` takes each rank's contiguous share."""
    for k in ("TPU3DSIS_COORDINATOR", "TPU3DSIS_DIST", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not pdist.initialize_from_env("cpu") and pdist.process_info() == (0, 1)
    monkeypatch.setenv("TPU3DSIS_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("TPU3DSIS_NUM_PROCESSES", "4")
    monkeypatch.setenv("TPU3DSIS_PROCESS_ID", "3")
    assert pdist._launch_from_env() == ("tcp://10.0.0.1:1234", 4, 3)
    assert pdist.local_device("cuda") == torch.device("cuda", 3) and pdist.local_device("cpu").type == "cpu"
    monkeypatch.delenv("TPU3DSIS_COORDINATOR")
    monkeypatch.setenv("TPU3DSIS_DIST", "1")
    monkeypatch.setenv("RANK", "5")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert pdist._launch_from_env() == ("env://", 8, 5)
    assert pdist.local_device("cuda") == torch.device("cuda", 1)
    assert pdist.local_device("cuda:0") == torch.device("cuda", 0)
    batch = {"data": np.arange(8).reshape(4, 2), "gt_valid": np.ones((4, 3), bool)}
    assert np.array_equal(pdist.shard_batch(batch, 1, 2)["data"], [[4, 5], [6, 7]])
    with pytest.raises(ValueError, match="split"):
        pdist.shard_batch(batch, 0, 3)

    env = {k: v for k, v in os.environ.items() if not k.startswith("TPU3DSIS_")}
    env.update(PYTHONPATH=ROOT, RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    res = subprocess.run([sys.executable, "-c", _LAUNCH], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=TIMEOUT)
    assert res.returncode == 0 and "JOINED" in res.stdout, res.stderr


def test_two_process_trainer_takes_steps_and_rank0_writes(tmp_path):
    cfg = tiny_cfg(default_config())
    filelist = write_chunks(tmp_path, n=4)
    cfg.update(TRAIN_FILELIST=filelist, VAL_FILELIST="", TRAINVAL_FILELIST="", TPU_DATA_PARALLEL=2, VAL_TIME=0.0,
               DISPLAY=1, TPU_TILE_SIZE=[32, 16, 32])
    with open(tmp_path / "cfg.pkl", "wb") as f:
        pickle.dump(cfg, f)
    outs = _run_ranks(tmp_path, _TRAINER_WORKER, [str(tmp_path / "cfg.pkl"), str(tmp_path / "runs")])
    res = [json.loads(next(l for l in out.splitlines() if l.startswith("RESULT"))[len("RESULT"):]) for out in outs]
    for r, got in enumerate(res):
        assert (got["rank"], got["world"], got["n_dp"], got["step"], got["opt_step"]) == (r, 2, 2, 2, 2)
    assert res[0]["params_sum"] == res[1]["params_sum"]
    assert res[0]["snapshot"].endswith("step_2.npz") and res[1]["snapshot"] is None
    assert os.listdir(tmp_path / "runs" / "rank0" / "checkpoints") == ["step_2.npz"]
    assert os.listdir(tmp_path / "runs" / "rank1" / "checkpoints") == []
    assert not os.path.exists(tmp_path / "runs" / "rank1" / "logs")
    assert "epoch 0 step 2 total" in outs[0] and "epoch 0 step" not in outs[1]
