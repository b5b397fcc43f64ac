"""The kernels' calls during a traced window: the port's wrappers of K1
(``roi_pool3d_cuda``), K1b (``roi_pool3d_backward_cuda``) and K3
(``fuse_views_cuda``) wrapped for the window alone, each call recorded as
the shapes and, for the RoI pools, the rois that the byte counts need. A
wrapper that is not there records nothing."""

from __future__ import annotations

import contextlib
import importlib


def _k1(args, kw, names):
    feats, rois, batch_idx, level_idx, scales, pooled = (list(args) + [kw.get(n) for n in names[len(args):]])[:6]
    return {"rois": rois.detach().clone(), "batch_idx": batch_idx.clone(), "level_idx": level_idx.clone(),
            "map_shapes": [tuple(f.shape) for f in feats],
            "scales": [float(s) for s in scales], "pooled": int(pooled), "channels": int(feats[0].shape[-1]),
            "itemsize": feats[0].element_size()}


def _k3(args, kw, names):
    full = dict(zip(names, args), **kw)
    f = full["feats2d"]
    return {"feats_shape": tuple(f.shape), "itemsize": f.element_size(),
            "volume_dims": tuple(int(n) for n in full["volume_dims"])}


WRAPPED = {"k1": ("tpu3dsis_torch.ops.roi_pool3d", "roi_pool3d_cuda", _k1,
                  ("feats", "rois", "batch_idx", "level_idx", "scales", "pooled")),
           "k1b": ("tpu3dsis_torch.ops.roi_pool3d", "roi_pool3d_backward_cuda", _k1,
                   ("feats", "rois", "batch_idx", "level_idx", "scales", "pooled")),
           "k3": ("tpu3dsis_torch.geometry.projection", "fuse_views_cuda", _k3,
                  ("feats2d", "depths", "poses", "world_to_grid", "intrinsic", "volume_dims"))}


def materialize(calls: dict) -> dict:
    """The recorded tensors as numpy, read once the window has closed (a
    copy to the host inside the window would wait for the card)."""
    for records in calls.values():
        for c in records:
            for k, v in c.items():
                if hasattr(v, "cpu"):
                    c[k] = v.float().cpu().numpy() if k == "rois" else v.cpu().numpy()
    return calls


@contextlib.contextmanager
def recording(enabled: bool):
    """Yields {kernel: [call dicts]}, filled within the block when enabled."""
    calls = {k: [] for k in WRAPPED}
    if not enabled:
        yield calls
        return
    restore = []
    for kernel, (module, name, take, names) in WRAPPED.items():
        try:
            mod = importlib.import_module(module)
        except ImportError:
            continue
        fn = getattr(mod, name, None)
        if fn is None:
            continue

        def call(*args, _fn=fn, _take=take, _names=names, _kernel=kernel, **kw):
            calls[_kernel].append(_take(args, kw, _names))
            return _fn(*args, **kw)

        call.__dict__ = fn.__dict__  # the wrapper's launch counters stay its own
        setattr(mod, name, call)
        restore.append((mod, name, fn))
    try:
        yield calls
    finally:
        for mod, name, fn in restore:
            setattr(mod, name, fn)
