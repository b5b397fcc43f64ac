"""SGD with the reference's per-parameter-group rules (``tpu3dsis/train/solver.py``,
``lib/model/trainval.py:176-196, 271-284``).

  - torch-SGD order: grad += weight_decay * param, then the momentum
    buffer, then the step scaled by the learning rate;
  - biases: lr x2 with DOUBLE_BIAS, weight decay only with BIAS_DECAY;
  - FIX_BACKBONE / FIX_RPN / FIX_CLASS / FIX_ENET freeze by name substring,
    NYUV2_FINETUNE unfreezes the classifier's last layers;
  - the step LR schedule LEARNING_RATE * GAMMA^(stepsizes passed), a pure
    function of the count of applied updates, so a resumed run replays it.

``SGD`` keeps one float32 momentum buffer per parameter (the ENet's
BatchNorm statistics are parameters, so with ``FIX_ENET: False`` they take
weight decay and an update, as in the JAX package) and the update
count on the parameters' device, and updates in place with ``torch._foreach``
operations in the JAX package's order, each rounded as it rounds them: on
the same gradients the result equals its update. ``update`` takes a 0-d
``finite`` flag: where it is false, nothing changes, the count included
(the train step's non-finite guard), without a host sync.
"""

from __future__ import annotations

import numpy as np
import torch


def param_groups(param_names, cfg) -> dict:
    """name -> (is_bias, is_frozen), the reference's fix_eval_parts rules."""
    groups = {}
    for name in param_names:
        is_bias = "bias" in name
        frozen = False
        if cfg.FIX_BACKBONE and ("geometry" in name or "color" in name or "combine" in name) \
                and "mask_backbone" not in name:
            frozen = True
        elif cfg.FIX_RPN and "rpn" in name:
            frozen = True
        elif cfg.FIX_CLASS and "classifier" in name:
            frozen = True
        elif cfg.FIX_ENET and "enet" in name:
            frozen = True
        if cfg.NYUV2_FINETUNE and ("classfier_cls" in name or "classifier_bbox" in name
                                   or "classifier.4" in name):
            frozen = False
        groups[name] = (is_bias, frozen)
    return groups


def lr_at_step(step: int, cfg) -> np.float32:
    """The learning rate of update number `step`, in float32 as the JAX
    package computes it (``solver.py:64``)."""
    lr = np.float32(cfg.LEARNING_RATE)
    for s in cfg.STEPSIZE:
        if step > s:
            lr = np.float32(lr * np.float32(cfg.GAMMA))
    return lr


class SGD:
    """The solver over named float32 parameters (a module's
    ``named_parameters()``); frozen parameters are left out of every update
    and keep their momentum."""

    def __init__(self, named_params, cfg):
        named = dict(named_params)
        self.cfg = cfg
        self.groups = param_groups(list(named), cfg)
        self.momentum_coef = float(cfg.MOMENTUM)
        wd = float(cfg.WEIGHT_DECAY)
        self.params = named
        dev = next(iter(named.values())).device
        self.momentum = {k: torch.zeros_like(v, dtype=torch.float32, memory_format=torch.preserve_format)
                         for k, v in named.items()}
        self.step = torch.zeros((), dtype=torch.int64, device=dev)
        # trainable names by (weight decay, lr factor)
        self.buckets = {}
        for k, (is_bias, frozen) in self.groups.items():
            if frozen:
                continue
            decay = wd if (not is_bias or cfg.BIAS_DECAY) else 0.0
            factor = 2.0 if (is_bias and cfg.DOUBLE_BIAS) else 1.0
            self.buckets.setdefault((decay, factor), []).append(k)

    def trainable(self) -> list:
        return [k for k, (_, frozen) in self.groups.items() if not frozen]

    def lr(self) -> torch.Tensor:
        """The learning rate of the next update, a float32 0-d tensor on the
        parameters' device (the schedule of ``lr_at_step``)."""
        nxt = self.step + 1
        lr = torch.full((), float(np.float32(self.cfg.LEARNING_RATE)), dtype=torch.float32, device=self.step.device)
        for s in self.cfg.STEPSIZE:
            lr = torch.where(nxt > s, lr * float(np.float32(self.cfg.GAMMA)), lr)
        return lr

    @torch.no_grad()
    def update(self, grads: dict, finite: torch.Tensor | None = None) -> None:
        """One update from {name: gradient} of the trainable parameters. A
        missing gradient counts as zero."""
        lr = self.lr()
        keep = None if finite is None else ~finite
        for (decay, factor), names in self.buckets.items():
            ps = [self.params[k] for k in names]
            gs = [grads[k].float() if grads.get(k) is not None else torch.zeros_like(self.params[k])
                  for k in names]
            ms = [self.momentum[k] for k in names]
            if decay:
                gs = torch._foreach_add(gs, torch._foreach_mul(ps, decay))
            vs = torch._foreach_add(torch._foreach_mul(ms, self.momentum_coef), gs)
            neg_scale = -(lr * factor) if factor != 1.0 else -lr
            new_ps = torch._foreach_add(ps, torch._foreach_mul(vs, neg_scale))
            if keep is not None:
                vs = [torch.where(keep, m, v) for m, v in zip(ms, vs)]
                new_ps = [torch.where(keep, p, q) for p, q in zip(ps, new_ps)]
            torch._foreach_copy_(ms, vs)
            torch._foreach_copy_(ps, new_ps)
        self.step += 1 if finite is None else finite.to(torch.int64)

    @torch.no_grad()
    def load_state(self, momentum: dict, step: int) -> None:
        """Momentum buffers ({name: array in the torch layout}) and the
        update count, as a snapshot holds them."""
        for k, v in momentum.items():
            if k in self.momentum:
                self.momentum[k].copy_(torch.as_tensor(np.asarray(v)).reshape(self.momentum[k].shape))
        self.step.fill_(int(step))
