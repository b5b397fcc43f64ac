"""Training steps as ``train_step`` drives them, compared with the plain
reference by one more number, ``rpn_loss_gap``: of each checked step's RPN
loss (each level's anchor classification and box losses, the batch's mean
of their sum), the largest relative gap to the reference's.

The RPN's targets are the anchors' and the gt boxes' alone, so its loss
moves with the arithmetic and with nothing discrete. The total loss
(``loss_gap``) does not: where bf16 ranks a proposal otherwise than float32
does, the classifier's and the mask FCN's targets of that step change, and
the loss with them by a step that a limit between the program's readings
and the float8 control's cannot take (``limits/suncg.train-enet.json``).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.kinds.train_step import TrainStep
from portbench.reference import nets
from portbench.reference.train import TrainReference

# the port's step's metrics that make up its RPN loss (train/trainstep.py::build_loss_fn)
RPN_KEYS = tuple(f"rpn_{part}_level{lvl}" for lvl in (1, 2) for part in ("cross_entropy", "loss_box"))


class RecordingReference(TrainReference):
    """The reference, with each step's RPN loss kept: ``steps`` returns it
    under ``rpn_losses``."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.rpn_losses = []

    def loss(self, p, batch, draws):
        total, per = super().loss(p, batch, draws)
        self.rpn_losses.append(float(np.mean([float(sum(v.detach() for k, v in s.items() if k.startswith("rpn_")))
                                              for s in per])))
        return total, per

    def steps(self, params, batches, draws):
        out = super().steps(params, batches, draws)
        out["rpn_losses"] = list(self.rpn_losses)
        return out


def rpn_numbers(prog: list, ref: list) -> dict:
    """``rpn_loss_gap`` from each checked step's RPN loss, the program's (or
    a control's) and the reference's."""
    return {"rpn_loss_gap": max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(prog, ref))}


class TrainStepRPN(TrainStep):
    """``TrainStep``, its checked steps' RPN losses kept: set-up runs them
    through a wrapper of the step, which the window's steps do not pass."""

    @property
    def step(self):
        return self._step

    @step.setter
    def step(self, fn):
        def checked(opt, batch, **kw):
            metrics = fn(opt, batch, **kw)
            self.rpn_losses.append(sum(metrics[k] for k in RPN_KEYS))
            return metrics

        self._step, self._unwrapped = checked, fn

    @step.deleter
    def step(self):
        del self._step, self._unwrapped

    def setup(self) -> None:
        self.rpn_losses = []
        super().setup()
        self._step = self._unwrapped

    def free(self) -> None:
        super().free()
        self.prog["rpn_losses"] = [float(x) for x in self.rpn_losses]

    def reference(self, prec: str = "fp32") -> dict:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ref = RecordingReference(self.cfg["model"], self.train_cfg, nets.Precision(prec))
        return ref.steps(self.params, self.reference_batches(), self.checked["draws"])

    def check(self, served=None) -> dict:
        numbers = super().check(served)
        numbers.update(rpn_numbers((self.prog if served is None else served)["rpn_losses"], self.ref_out["rpn_losses"]))
        return numbers


def make(cfg, mix, seed, device="cuda"):
    return TrainStepRPN(cfg, mix, seed, device)
