"""Faults planted under the timed path, for the runs that show the
comparison fails them: each a context manager that breaks the port while
it is open. Serving: ``stale`` (each room gets the previous room's answer),
``half`` (half of the tiles left out), ``class`` (a served detection's
class altered). Training: ``unchanged`` (the update leaves the state as it
was), ``half`` (half of the batch left out, the mean taken over the rest),
``altered`` (the update takes twice the gradient)."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def serve(kind: str):
    from tpu3dsis_torch.infer.tiling import SceneInference

    if kind == "stale":
        last = {}

        def make(infer):
            def stale(self, scene, frames=None):
                out = infer(self, scene, frames)
                prev = last.get("out", out)
                last["out"] = out
                return prev
            return stale
        return _patched(SceneInference, "infer", make)
    if kind == "half":
        def make(origins):
            def half(self, shape):
                o = origins(self, shape)
                return o[: max(1, o.shape[0] // 2)]
            return half
        stack = contextlib.ExitStack()
        stack.enter_context(_patched(SceneInference, "_origins", make))
        stack.enter_context(_patched(SceneInference, "_origins_np", make))
        return stack
    if kind == "class":
        def make(infer):
            def altered(self, scene, frames=None):
                det, masks = infer(self, scene, frames)
                if len(det["pred_class"]):
                    det["pred_class"] = det["pred_class"].copy()
                    det["pred_class"][0] = det["pred_class"][0] % (self.det.num_classes - 1) + 1
                return det, masks
            return altered
        return _patched(SceneInference, "infer", make)
    raise ValueError(f"no serving fault {kind!r}")


def train(kind: str):
    from tpu3dsis_torch.train import solver, trainstep

    if kind == "unchanged":
        return _patched(solver.SGD, "update", lambda update: lambda self, grads, finite=None: None)
    if kind == "altered":
        def make(update):
            def doubled(self, grads, finite=None):
                return update(self, {k: None if g is None else 2 * g for k, g in grads.items()}, finite)
            return doubled
        return _patched(solver.SGD, "update", make)
    if kind == "half":
        def make(build):
            def halved(*args, **kw):
                opt_init, step = build(*args, **kw)

                def half_step(opt, batch, draws=None, **k):
                    n = len(batch["gt_box"]) // 2
                    batch = {key: v[:n] for key, v in batch.items()}
                    draws = None if draws is None else {key: v[:n] for key, v in draws.items()}
                    return step(opt, batch, draws=draws, **k)
                return opt_init, half_step
            return halved
        return _patched(trainstep, "build_train_step", make)
    raise ValueError(f"no training fault {kind!r}")
