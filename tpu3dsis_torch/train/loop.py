"""The training driver: epochs, the wall-clock validation cadence, snapshots
(``tpu3dsis/train/loop.py``; the reference's ``SolverWrapper.train_model``,
``lib/model/trainval.py:286-432``), on one card.

  - resume from the newest usable snapshot (skipping stepsize+1 files);
  - validation every VAL_TIME hours of wall clock on the val and trainval
    lists, then a snapshot, keeping SNAPSHOT_KEPT;
  - the loss metrics every DISPLAY steps under the reference's tags.

As in the JAX package, a card takes one chunk a step (its batch is the
number of data-parallel devices, and the port has one). More than one card
(``TPU_DATA_PARALLEL > 1``, or the JAX package's distributed environment)
raises: multi-GPU training is not ported.
"""

from __future__ import annotations

import os
import time

import torch

from tpu3dsis_torch import checkpoint as ckpt
from tpu3dsis_torch.config import DetectorConfig
from tpu3dsis_torch.infer.validate import ChunkValidator
from tpu3dsis_torch.io.dataset import SceneDataset
from tpu3dsis_torch.io.pipeline import PrefetchLoader
from tpu3dsis_torch.models.detector import Detector
from tpu3dsis_torch.train.trainstep import build_train_step
from tpu3dsis_torch.utils.logger import Logger

_DIST_ENV = ("TPU3DSIS_COORDINATOR", "TPU3DSIS_DIST")  # the JAX package's multi-process launch


class Trainer:
    def __init__(self, cfg, output_dir: str, chunk_shape=None, device: torch.device | str = "cuda"):
        if int(cfg.TPU_DATA_PARALLEL) > 1:
            raise NotImplementedError(f"TPU_DATA_PARALLEL={cfg.TPU_DATA_PARALLEL}: the port trains on one card")
        set_env = [k for k in _DIST_ENV if os.environ.get(k)]
        if set_env:
            raise NotImplementedError(f"{set_env} set: multi-process training is not ported")
        if chunk_shape is None:
            chunk_shape = tuple(int(t) for t in cfg.TPU_TILE_SIZE)
        self.cfg = cfg
        self.output_dir = output_dir
        self.checkpoint_dir = os.path.join(output_dir, "checkpoints")
        self.log_dir = os.path.join(output_dir, "logs")
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        self.logger_train = Logger(os.path.join(self.log_dir, "train"))
        self.logger_val = Logger(os.path.join(self.log_dir, "val"))
        self.logger_trainval = Logger(os.path.join(self.log_dir, "trainval"))
        self.detector = Detector(DetectorConfig.from_cfg(cfg), anchor_dir="experiments/anchors", device=device,
                                 param_dtype=torch.float32)
        self.chunk_shape = tuple(int(s) for s in chunk_shape)
        self.opt_init, self.step_fn = build_train_step(self.detector, cfg, self.chunk_shape)
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
        train_ds = SceneDataset(cfg.TRAIN_FILELIST, "chunk", cfg)
        loader = PrefetchLoader(train_ds, cfg, batch_size=1, seed=seed,
                                pin_memory=self.detector.device.type == "cuda")
        validator = None
        if val_fn is None and cfg.VAL_FILELIST and os.path.exists(cfg.VAL_FILELIST):
            validator = ChunkValidator(self.detector, cfg, self.chunk_shape)

        step = last_iter
        last_val = time.time()
        t_iter = time.time()
        for epoch in range(epochs):
            for batch in loader:
                self.generator.manual_seed(seed * 1_000_003 + step)
                metrics = self.step_fn(opt, batch, generator=self.generator)
                step += 1

                if step % cfg.DISPLAY == 0:
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

    def _snapshot(self, opt, step) -> str:
        # the solver keeps a momentum for every parameter, the ENet's
        # BatchNorm statistics included, as the JAX package keeps one for
        # every entry of its param dict
        path = ckpt.save_snapshot(self.checkpoint_dir, step, ckpt.module_params(self.detector),
                                  ckpt.tensors_to_params(opt.momentum), int(opt.step))
        ckpt.prune_snapshots(self.checkpoint_dir, self.cfg.SNAPSHOT_KEPT)
        print(f"snapshot -> {path}")
        return path
