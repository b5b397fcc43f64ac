"""Byte-exact `.chunk` / `.scene` binary format reader/writer.

A copy of the JAX package's ``tpu3dsis/io/chunk_format.py`` (held equal to
it, byte for byte in what it reads and writes, by
``tests/test_torch_io.py``). The on-disk layout is the reference datagen's
``saveChunkToFile`` (``datagen/SceneSampler/main.cpp:348-394``):

    uint64[3]                 dimX dimY dimZ
    float32[dimX*dimY*dimZ]   TSDF grid, Fortran order (x fastest)
    uint32                    numBboxes
    repeat numBboxes:
        float32[6]            minx miny minz maxx maxy maxz
        uint32                labelId (nyu40 id)
    uint32                    numMasks (== numBboxes)
    repeat numMasks:
        uint32                labelId (redundant)
        uint64[3]             mask dims
        uint16[...]           mask voxels, Fortran order
    uint32                    numBboxes (redundant)
    float32[numBboxes]        fraction of each box inside the volume
    float32[16]               worldToChunk mat4f
    uint32                    numImages
    uint32[numImages]         nearest-image frame ids

The reader decodes with bulk ``np.frombuffer``; the writer makes test
fixtures and synthetic scenes.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np


@dataclasses.dataclass
class RawChunk:
    """Decoded file contents, unprocessed (no label remap / crop / encode)."""

    sdf: np.ndarray  # (dimX, dimY, dimZ) float32
    boxes: np.ndarray  # (N, 6) float32 raw corner boxes
    labels: np.ndarray  # (N,) uint32 nyu40 label ids
    masks: list  # list of (mx, my, mz) uint16 arrays
    box_in_vol: np.ndarray  # (N,) float32 fraction of box inside the volume
    world_to_grid: np.ndarray  # (4, 4) float32 (already inverted, see below)
    frame_ids: np.ndarray  # (M,) uint32 nearest-image frame ids


class _Cursor:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def take(self, dtype, count):
        dt = np.dtype(dtype)
        n = dt.itemsize * count
        if self.off + n > len(self.buf):
            raise EOFError("not enough bytes in chunk file")
        out = np.frombuffer(self.buf, dtype=dt, count=count, offset=self.off)
        self.off += n
        return out


def read_chunk_file(path: str, with_masks: bool = True) -> RawChunk:
    with open(path, "rb") as f:
        buf = f.read()
    cur = _Cursor(buf)

    dims = cur.take(np.uint64, 3).astype(np.int64)
    dim_x, dim_y, dim_z = int(dims[0]), int(dims[1]), int(dims[2])
    sdf = cur.take(np.float32, dim_x * dim_y * dim_z).reshape(
        (dim_x, dim_y, dim_z), order="F"
    )

    num_box = int(cur.take(np.uint32, 1)[0])
    boxes = np.zeros((num_box, 6), dtype=np.float32)
    labels = np.zeros((num_box,), dtype=np.uint32)
    for i in range(num_box):
        boxes[i] = cur.take(np.float32, 6)
        labels[i] = cur.take(np.uint32, 1)[0]

    masks = []
    num_mask = int(cur.take(np.uint32, 1)[0])
    for _ in range(num_mask):
        cur.take(np.uint32, 1)  # redundant label id
        mdims = cur.take(np.uint64, 3).astype(np.int64)
        mx, my, mz = int(mdims[0]), int(mdims[1]), int(mdims[2])
        mdata = cur.take(np.uint16, mx * my * mz)
        if with_masks:
            masks.append(mdata.reshape((mx, my, mz), order="F"))

    n2 = int(cur.take(np.uint32, 1)[0])
    box_in_vol = cur.take(np.float32, n2).copy()

    # world2grid: the reference reads 16 floats, reshapes Fortran, transposes,
    # inverts (dataset.py:141). reshape-F + transpose == reshape-C.
    w2g_raw = cur.take(np.float32, 16).reshape((4, 4), order="C")
    world_to_grid = np.linalg.inv(w2g_raw.astype(np.float64)).astype(np.float32)

    num_images = int(cur.take(np.uint32, 1)[0])
    frame_ids = cur.take(np.uint32, num_images).copy()

    return RawChunk(
        sdf=sdf,
        boxes=boxes,
        labels=labels,
        masks=masks,
        box_in_vol=box_in_vol,
        world_to_grid=world_to_grid,
        frame_ids=frame_ids,
    )


def write_chunk_file(
    path: str,
    sdf: np.ndarray,
    boxes: np.ndarray,
    labels: np.ndarray,
    masks: list,
    box_in_vol: np.ndarray,
    chunk_to_grid_inv: np.ndarray,
    frame_ids: np.ndarray,
) -> None:
    """Write the byte-exact format (the inverse of :func:`read_chunk_file`).

    ``chunk_to_grid_inv`` is the raw 4x4 written to disk (C-order rows), i.e.
    the matrix whose inverse is the world->grid transform the reader returns.
    """
    num_box = int(boxes.shape[0])
    with open(path, "wb") as f:
        f.write(struct.pack("<QQQ", *[int(d) for d in sdf.shape]))
        f.write(np.asarray(sdf, dtype=np.float32).ravel(order="F").tobytes())
        f.write(struct.pack("<I", num_box))
        for i in range(num_box):
            f.write(np.asarray(boxes[i], dtype=np.float32).tobytes())
            f.write(struct.pack("<I", int(labels[i])))
        f.write(struct.pack("<I", num_box))
        for i in range(num_box):
            f.write(struct.pack("<I", int(labels[i])))
            m = np.asarray(masks[i], dtype=np.uint16)
            f.write(struct.pack("<QQQ", *[int(d) for d in m.shape]))
            f.write(m.ravel(order="F").tobytes())
        f.write(struct.pack("<I", num_box))
        f.write(np.asarray(box_in_vol, dtype=np.float32).tobytes())
        f.write(
            np.asarray(chunk_to_grid_inv, dtype=np.float32).ravel(order="C").tobytes()
        )
        f.write(struct.pack("<I", int(len(frame_ids))))
        f.write(np.asarray(frame_ids, dtype=np.uint32).tobytes())
