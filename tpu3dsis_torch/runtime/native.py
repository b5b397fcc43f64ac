"""ctypes binding of the native chunk decoder (``tpu3dsis/runtime/native.py``).

``csrc/chunk_decoder.cpp`` is host C++ (no CUDA): one pass over a
``.chunk`` file's bytes decodes it, encodes the TSDF channels-last and
paints the mask canvas, where the numpy path reads field by field and makes
a pass for each step. ``_build.build_host`` compiles it with ``g++`` at the
first use into ``_build/`` under a hash of its source and flags; a missing
compiler or a failed build raises (the JAX package's binding quietly falls
back to numpy instead). ``io/dataset.py::load_fast_padded`` is its caller.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from tpu3dsis_torch import _build

SOURCE = _build.CSRC / "chunk_decoder.cpp"
MASK_DIMS_DIFFER = -8  # chunk_decode's code for a mask whose dims are not its box's extent


class _Header(ctypes.Structure):
    _fields_ = [
        ("dim_x", ctypes.c_uint64),
        ("dim_y", ctypes.c_uint64),
        ("dim_z", ctypes.c_uint64),
        ("num_boxes", ctypes.c_uint32),
        ("num_masks", ctypes.c_uint32),
        ("num_images", ctypes.c_uint32),
    ]


@functools.cache
def load_library() -> ctypes.CDLL:
    """The decoder, built if needed, its two functions declared."""
    lib = ctypes.CDLL(str(_build.build_host(SOURCE)))
    lib.chunk_peek.restype = ctypes.c_int
    lib.chunk_peek.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.POINTER(_Header)]
    lib.chunk_decode.restype = ctypes.c_int
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    lib.chunk_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_float, ctypes.c_int,
        f32p, f32p, u32p, f32p, f32p, u32p, ctypes.c_void_p,
    ]
    return lib


def decode_chunk_native(path: str, truncation: float, encode_mode: int = 0, with_canvas: bool = True) -> dict:
    """One-pass decode and encode of a ``.chunk`` file.

    -> dict(data (X,Y,Z,2) f32, boxes (N,6) f32 raw, labels (N,) u32,
       fractions (N,) f32, world2chunk_raw (4,4) f32, frame_ids (M,) u32,
       mask_canvas (X,Y,Z) f32 | None).
    encode_mode: 0 abs(clip(tsdf)), 1 FLIP, 2 LOG. Raises EOFError for a
    malformed file and ValueError for a mask whose dims differ from its
    box's floor/ceil extent (which the paint would read out of bounds).
    """
    lib = load_library()
    with open(path, "rb") as f:
        buf = f.read()
    h = _Header()
    rc = lib.chunk_peek(buf, len(buf), ctypes.byref(h))
    if rc != 0:
        raise EOFError(f"malformed chunk file {path} (rc={rc})")
    dx, dy, dz = int(h.dim_x), int(h.dim_y), int(h.dim_z)
    nb, ni = int(h.num_boxes), int(h.num_images)
    data = np.empty((dx, dy, dz, 2), np.float32)
    boxes = np.empty((max(nb, 1), 6), np.float32)
    labels = np.empty((max(nb, 1),), np.uint32)
    fracs = np.empty((max(nb, 1),), np.float32)
    w2c = np.empty((16,), np.float32)
    fids = np.empty((max(ni, 1),), np.uint32)
    canvas = np.empty((dx, dy, dz), np.float32) if with_canvas else None
    rc = lib.chunk_decode(
        buf, len(buf), ctypes.c_float(truncation), int(encode_mode),
        data, boxes, labels, fracs, w2c, fids,
        canvas.ctypes.data_as(ctypes.c_void_p) if canvas is not None else None,
    )
    if rc == MASK_DIMS_DIFFER:
        raise ValueError(f"{path}: a mask's dims differ from its box's extent")
    if rc != 0:
        raise EOFError(f"malformed chunk file {path} (rc={rc})")
    return {
        "data": data,
        "boxes": boxes[:nb],
        "labels": labels[:nb],
        "fractions": fracs[:nb],
        "world2chunk_raw": w2c.reshape(4, 4),
        "frame_ids": fids[:ni],
        "mask_canvas": canvas,
    }
