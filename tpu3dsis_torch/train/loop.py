"""The training driver: epochs, the wall-clock validation cadence, snapshots
(``tpu3dsis/train/loop.py``; the reference's ``SolverWrapper.train_model``,
``lib/model/trainval.py:286-432``), on one card or data parallel over
several.

  - resume from the newest usable snapshot (skipping stepsize+1 files);
  - validation every VAL_TIME hours of wall clock on the val and trainval
    lists, then a snapshot, keeping SNAPSHOT_KEPT;
  - the loss metrics every DISPLAY steps under the reference's tags.

As in the JAX package, a card takes one chunk a step. Data parallelism is
one process a card (``torchrun``, or the JAX package's ``TPU3DSIS_*``
variables; ``parallel/distributed.py``). ``TPU_DATA_PARALLEL`` (0: the
ranks launched) is the global batch, clamped to the cards present
(``card_count``), and each rank loads its own ``TPU_DATA_PARALLEL //
world`` chunks a step from a stream seeded by its rank: one process given
several cards' batch computes the same mean on its one card. The step
averages the gradients over the ranks. Every rank resumes from the
same snapshot and starts from rank 0's state; only rank 0 logs, validates
and writes snapshots.
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

from tpu3dsis_torch import checkpoint as ckpt
from tpu3dsis_torch.config import DetectorConfig
from tpu3dsis_torch.infer.validate import ChunkValidator
from tpu3dsis_torch.io.dataset import SceneDataset
from tpu3dsis_torch.io.pipeline import PrefetchLoader
from tpu3dsis_torch.models.detector import Detector
from tpu3dsis_torch.parallel import distributed as pdist
from tpu3dsis_torch.train.trainstep import build_train_step
from tpu3dsis_torch.utils.logger import Logger


class Trainer:
    def __init__(self, cfg, output_dir: str, chunk_shape=None, device: torch.device | str = "cuda"):
        if chunk_shape is None:
            chunk_shape = tuple(int(t) for t in cfg.TPU_TILE_SIZE)
        self.cfg = cfg
        self.output_dir = output_dir
        self.checkpoint_dir = os.path.join(output_dir, "checkpoints")
        self.log_dir = os.path.join(output_dir, "logs")
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        # a distributed launch is joined before the first use of the card,
        # which is then this rank's (cuda:LOCAL_RANK)
        self.group = dist.group.WORLD if pdist.initialize_from_env(device) else None
        self.process_id, self.process_count = pdist.process_info()
        n_dp = int(cfg.TPU_DATA_PARALLEL) or self.process_count
        cards = pdist.card_count(device)
        if cards is not None and n_dp > cards:
            if self.process_id == 0:
                print(f"TPU_DATA_PARALLEL={n_dp} clamped to the {cards} card(s) present")
            n_dp = cards
        if n_dp % self.process_count:
            raise ValueError(f"TPU_DATA_PARALLEL={n_dp} not divisible by process_count={self.process_count}")
        self.n_dp = n_dp
        self.local_batch = n_dp // self.process_count  # the chunks this rank loads a step
        if self.group is not None and self.process_id == 0:
            print(f"data parallel: {self.process_count} process(es), {n_dp} chunk(s) a step, "
                  f"backend {dist.get_backend()}")
        if self.process_id == 0:
            self.logger_train = Logger(os.path.join(self.log_dir, "train"))
            self.logger_val = Logger(os.path.join(self.log_dir, "val"))
            self.logger_trainval = Logger(os.path.join(self.log_dir, "trainval"))
        self.detector = Detector(DetectorConfig.from_cfg(cfg), anchor_dir="experiments/anchors",
                                 device=pdist.local_device(device), param_dtype=torch.float32)
        self.chunk_shape = tuple(int(s) for s in chunk_shape)
        self.opt_init, self.step_fn = build_train_step(self.detector, cfg, self.chunk_shape, group=self.group)
        self.generator = torch.Generator(device=self.detector.device)

    # --- state ----------------------------------------------------------------
    def init_state(self, seed: int = 0, pretrained: str | None = None):
        """Weights from a seeded ``torch.Generator``, then a pretrained
        ``.pth`` or ``.npz`` through ``partial_update``; a fresh solver."""
        self.detector.init_params(torch.Generator().manual_seed(seed))
        if pretrained:
            pre = ckpt.load_pth(pretrained) if pretrained.endswith(".pth") else ckpt.load_snapshot(pretrained)[0]
            ckpt.load_jax_params(self.detector,
                                 ckpt.partial_update(ckpt.module_params(self.detector), pre, self.cfg))
        return self.opt_init()

    def restore_or_init(self, seed: int = 0, pretrained: str | None = None):
        """(solver, update count) from the newest snapshot, or a fresh start."""
        files = ckpt.find_previous(self.checkpoint_dir, self.cfg.STEPSIZE)
        if files:
            path = files[-1]
            params, momentum, opt_step = ckpt.load_snapshot(path)
            ckpt.load_jax_params(self.detector, params)
            opt = self.opt_init()
            opt.load_state(ckpt.params_to_torch_state_dict(momentum), opt_step)
            print(f"restored from {path} at step {opt_step}")
            return opt, opt_step
        return self.init_state(seed, pretrained), 0

    # --- training ---------------------------------------------------------------
    def train(self, epochs: int, max_steps=None, val_fn=None, seed: int = 0, pretrained=None):
        """Returns (solver, steps run in all, resumed ones included)."""
        cfg = self.cfg
        opt, last_iter = self.restore_or_init(seed, pretrained)
        if self.group is not None:
            pdist.replicate(self.detector, opt, self.group)
        train_ds = SceneDataset(cfg.TRAIN_FILELIST, "chunk", cfg)
        # each rank loads only its own share of the batch, from a stream of its own
        loader = PrefetchLoader(train_ds, cfg, batch_size=self.local_batch,
                                seed=seed + 9973 * self.process_id, pin_memory=self.detector.device.type == "cuda")
        validator = None
        if (self.process_id == 0 and val_fn is None and cfg.VAL_FILELIST
                and os.path.exists(cfg.VAL_FILELIST)):
            validator = ChunkValidator(self.detector, cfg, self.chunk_shape)

        step = last_iter
        last_val = time.time()
        t_iter = time.time()
        for epoch in range(epochs):
            for batch in loader:
                self.generator.manual_seed(seed * 1_000_003 + step)
                metrics = self.step_fn(opt, batch, generator=self.generator)
                step += 1

                if step % cfg.DISPLAY == 0 and self.process_id == 0:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    dt = (time.time() - t_iter) / cfg.DISPLAY
                    t_iter = time.time()
                    print(f"epoch {epoch} step {step} total {metrics['total_loss']:.4f} {dt:.3f}s/iter")
                    for tag, v in metrics.items():
                        self.logger_train.scalar_summary(tag, v, step)

                # VAL_TIME-hours cadence (trainval.py:368-384)
                if cfg.VAL_TIME > 0 and (time.time() - last_val) / 3600.0 > cfg.VAL_TIME:
                    last_val = time.time()
                    self._validate_and_snapshot(opt, step, validator, val_fn)

                if max_steps is not None and step - last_iter >= max_steps:
                    self._snapshot(opt, step)
                    return opt, step
        self._snapshot(opt, step)
        return opt, step

    def _validate_and_snapshot(self, opt, step, validator, val_fn):
        if self.process_id != 0:
            return  # rank 0 validates; the others go on to the next step's all-reduce
        cfg = self.cfg
        if val_fn is not None:
            val_fn(ckpt.module_params(self.detector), step)
        elif validator is not None:
            for mode, filelist, logger in (("val", cfg.VAL_FILELIST, self.logger_val),
                                           ("trainval", cfg.TRAINVAL_FILELIST, self.logger_trainval)):
                if not filelist or not os.path.exists(filelist):
                    continue
                ds = SceneDataset(filelist, "chunk", cfg)
                res = validator.run(ds, max_samples=cfg.VAL_NUM, save_dir=cfg.VAL_SAVE_DIR or None, logger=logger,
                                    step=step)
                print(f"[{mode}] step {step}: {res}")
        self._snapshot(opt, step)

    def _snapshot(self, opt, step) -> str | None:
        """Rank 0 writes the snapshot (every rank holds the same state) and
        returns its path; the other ranks return None."""
        if self.process_id != 0:
            return None
        # the solver keeps a momentum for every parameter, the ENet's
        # BatchNorm statistics included, as the JAX package keeps one for
        # every entry of its param dict
        path = ckpt.save_snapshot(self.checkpoint_dir, step, ckpt.module_params(self.detector),
                                  ckpt.tensors_to_params(opt.momentum), int(opt.step))
        ckpt.prune_snapshots(self.checkpoint_dir, self.cfg.SNAPSHOT_KEPT)
        print(f"snapshot -> {path}")
        return path
