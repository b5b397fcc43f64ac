"""Training steps: the port's ``build_train_step`` on batches of chunks cut
from generated rooms, each batch's rows uploaded from a seeded pool in
pinned host memory at the step, as a loader would hand them over.

Set-up builds the one step object, drives it through its first
``checked_steps`` steps on batches whose rows all differ (they warm every
shape and are what the reference checks), and hands it to the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import harness, judge, traffic, weights
from portbench.reference import nets
from portbench.reference.train import TrainReference, frozen

DEVICE_KEYS = ("data", "gt_box", "gt_valid", "mask_canvas", "images", "depths", "view_valid")
HOST_KEYS = ("poses", "world_to_grid")


class TrainStep:
    def __init__(self, cfg: dict, mix: dict, seed: int, device="cuda"):
        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.train_cfg = cfg["train"]
        self.device = torch.device(device)
        self.batch = int(mix["batch"])
        self.failed = 0
        self.steps_done = 0
        self.window_batches = []
        self.finite = []
        self.timer = None

    def setup(self) -> None:
        from tpu3dsis_torch.config import DetectorConfig, default_config
        from tpu3dsis_torch.models.detector import Detector
        from tpu3dsis_torch.train.trainstep import build_train_step

        pcfg = default_config()
        for k, v in self.train_cfg.items():  # every key as the configuration's file holds it
            if isinstance(v, dict):
                pcfg[k].update(v)
            else:
                pcfg[k] = v
        self.pcfg = pcfg
        self.params = weights.make(self.cfg["model"], self.cfg["train_weights"], self.seed, self.device)
        det = Detector(DetectorConfig.from_cfg(pcfg), device=self.device, param_dtype=torch.float32)
        det.load_state_dict(self.params, strict=True)
        self.det = det
        shape = tuple(self.train_cfg["TPU_TILE_SIZE"])
        opt_init, self.step = build_train_step(det, pcfg, shape)
        self.opt = opt_init()
        harness.note("program built")
        chunks = traffic.train_pool(self.mix, self.seed, self.train_cfg["INTRINSIC"], self.cfg["kind_labels"],
                                    int(self.train_cfg["TPU_MAX_GT"]), self.device)
        harness.note(f"{len(chunks)} chunks made")
        pin = self.device.type == "cuda"
        self.pool = {k: [torch.from_numpy(np.ascontiguousarray(c[k])) for c in chunks] for k in DEVICE_KEYS}
        self.pool = {k: [t.pin_memory() if pin else t for t in v] for k, v in self.pool.items()}
        self.host = {k: [c[k] for c in chunks] for k in HOST_KEYS}
        self.gt = [c["gt_box"][c["gt_valid"]] for c in chunks]
        self.order = traffic.batch_order(len(chunks), self.batch, 1 << 14, self.seed)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(self.seed % (2**63))
        self.n_anchors = sum(self._anchors(lvl) for lvl in (1, 2))
        self.n_cand = int(self.train_cfg["TRAIN"]["RPN_POST_NMS_TOP_N"]) + int(self.train_cfg["TPU_MAX_GT"])
        # the first steps: the reference follows them
        n = int(self.mix["checked_steps"])
        names = [k for k in self.opt.params if not frozen(k, self.train_cfg)]
        self.p0 = {k: self.opt.params[k].detach().clone() for k in names}
        self.checked = {"batches": [], "draws": [], "losses": []}
        for s in range(n):
            idx = self.order[s]
            batch, draws = self.make_batch(idx), self.make_draws()
            metrics = self.step(self.opt, batch, draws=draws)
            self.checked["batches"].append(idx)
            self.checked["draws"].append({k: v.clone() for k, v in draws.items()})
            self.checked["losses"].append(metrics["total_loss"])
            if s == 0:
                self.m1 = {k: self.opt.momentum[k].detach().clone() for k in names}
        self.change = {k: self.opt.params[k].detach() - self.p0[k] for k in names}
        self.checked["losses"] = [float(x) for x in self.checked["losses"]]
        self.next = n
        harness.note(f"{n} steps checked")
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def _anchors(self, lvl):
        s = [d // 4 for d in self.train_cfg["TPU_TILE_SIZE"]]
        return s[0] * s[1] * s[2] * int(self.cfg["model"][f"NUM_ANCHORS_LEVEL{lvl}"])

    def make_draws(self) -> dict:
        b = self.batch
        return {"anchor": torch.rand((b, 2, self.n_anchors), generator=self.gen, device=self.device),
                "proposal": torch.rand((b, 2, self.n_cand), generator=self.gen, device=self.device)}

    def make_batch(self, idx) -> dict:
        """The rows ``idx`` of the pool: uploaded from pinned memory now (the
        pose matrices stay on the host, as the loader hands them)."""
        out = {}
        for k in DEVICE_KEYS:
            rows = [self.pool[k][i] for i in idx]
            dst = torch.empty((len(rows), *rows[0].shape), dtype=rows[0].dtype, device=self.device)
            for j, r in enumerate(rows):
                dst[j].copy_(r, non_blocking=True)
            out[k] = dst
        for k in HOST_KEYS:
            out[k] = np.stack([self.host[k][i] for i in idx])
        return out

    def window(self, seconds: float) -> dict:
        t_start = time.perf_counter()
        while True:
            idx = self.order[self.next]
            self.next += 1
            metrics = self.step(self.opt, self.make_batch(idx), draws=self.make_draws(), timer=self.timer)
            self.finite.append(metrics["step_finite"])
            self.steps_done += 1
            self.window_batches.append(idx)
            if time.perf_counter() - t_start >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t_end = time.perf_counter()
        self.failed = int((torch.stack(self.finite) == 0).sum())  # steps the non-finite guard skipped
        return {"t_start": t_start, "t_end": t_end}

    def end_to_end(self, w: dict) -> dict:
        return {"train_chunks_per_s": self.steps_done * self.batch / (w["t_end"] - w["t_start"])}

    @property
    def attempted(self) -> int:
        return self.steps_done

    def counters(self) -> dict:
        return {"steps": self.steps_done}

    def window_steps(self) -> list:
        """Each window step's batch as its samples' valid gt boxes."""
        return [[self.gt[i] for i in idx] for idx in self.window_batches]

    def stage_ms(self) -> dict:
        if self.timer is None or not self.steps_done:
            return {}
        return {k: v / self.steps_done for k, v in self.timer.ms().items()}

    def trace_on(self) -> None:
        from tpu3dsis_torch.train.trainstep import StageTimer

        self.timer = StageTimer(self.device)

    def free(self) -> None:
        self.prog = {"losses": self.checked["losses"], "grad": self.m1, "change": self.change}
        del self.step, self.opt, self.det
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_batches(self):
        out = []
        for idx in self.checked["batches"]:
            b = {k: torch.stack([self.pool[k][i] for i in idx]) for k in DEVICE_KEYS}
            b.update({k: np.stack([self.host[k][i] for i in idx]) for k in HOST_KEYS})
            out.append(b)
        return out

    def reference(self, prec: str = "fp32") -> dict:
        """The reference's three steps from the cell's weights, batches and
        draws, its operands in ``prec``."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ref = TrainReference(self.cfg["model"], self.train_cfg, nets.Precision(prec))
        return ref.steps(self.params, self.reference_batches(), self.checked["draws"])

    def check(self, served=None) -> dict:
        """The comparison's numbers: the program's first steps (or
        ``served``, readings that stand in for them) against the reference's."""
        if not hasattr(self, "ref_out"):
            self.ref_out = self.reference()
        return judge.train_numbers(self.prog if served is None else served, self.ref_out)

    def control(self) -> dict:
        """The reference's steps with its operands cast to float8."""
        return self.reference("fp8_cast")


def make(cfg, mix, seed, device="cuda"):
    return TrainStep(cfg, mix, seed, device)
