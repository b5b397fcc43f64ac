"""TSDF -> triangle mesh extraction (the reference's debug marching cubes).

Capability parity with ``datagen/ScanReal/src/MarchingCubes.h`` (``doMC`` /
``extractIsoSurfaceAtPosition``: isolevel-0 surface of the fused TSDF,
skipping voxels outside the truncation band, emitted as a PLY triangle
soup for visual inspection of datagen output).

Independent design — vectorized marching TETRAHEDRA over the Freudenthal
(Kuhn) 6-tet cube decomposition, not the 256-entry marching-cubes tables:

* The Freudenthal split is translation-invariant (every cube is cut the
  same way, and the cut of a shared face is the same diagonal seen from
  both sides), so the extracted surface is WATERTIGHT across cube borders
  — every interior edge bounds exactly two triangles (pinned by the sphere
  test). Classic MC needs the full case tables to get this right.
* Each tetrahedron's linear interpolant has an exactly-solvable constant
  gradient (the edge matrix is fixed per tet shape), giving exact outward
  triangle orientation instead of winding-order case analysis.
* The 14 non-trivial sign configurations per tet are ENUMERATED in code
  (lone corner -> 1 triangle, split pair -> 2), so there are no opaque
  data tables to transcribe or verify.

Everything is numpy-vectorized over all cells of a tet class at once; a
400x200x400 scene extracts in a few seconds on the host (offline datagen
path, like the reference's OpenMP loop).

A copy of the JAX package's ``tpu3dsis/datagen/marching_tets.py``, numpy on the host as the
original is; ``tests/test_torch_datagen.py`` holds its outputs equal to
the original's.
"""

from __future__ import annotations

import itertools

import numpy as np

# Freudenthal decomposition: one tet per axis-insertion order. Corner k of
# the permutation's tet is the cube corner reached after k steps.
_PERMS = list(itertools.permutations((0, 1, 2)))


def _tet_corner_offsets():
    tets = []
    for perm in _PERMS:
        cur = np.zeros(3, np.int64)
        corners = [cur.copy()]
        for ax in perm:
            cur = cur.copy()
            cur[ax] = 1
            corners.append(cur.copy())
        tets.append(np.stack(corners))  # (4, 3)
    return tets


def _case_triangles():
    """For each 4-bit inside-mask: triangles as lists of (inside, outside)
    corner-index pairs naming the cut edge the vertex lies on."""
    cases = {}
    for code in range(1, 15):
        inside = [i for i in range(4) if code >> i & 1]
        outside = [i for i in range(4) if not code >> i & 1]
        if len(inside) == 1:
            a = inside[0]
            tris = [[(a, outside[0]), (a, outside[1]), (a, outside[2])]]
        elif len(outside) == 1:
            a = outside[0]
            tris = [[(inside[0], a), (inside[1], a), (inside[2], a)]]
        else:
            a, b = inside
            c, d = outside
            # perimeter order: consecutive quad vertices share a tet face
            quad = [(a, c), (a, d), (b, d), (b, c)]
            tris = [
                [quad[0], quad[1], quad[2]],
                [quad[0], quad[2], quad[3]],
            ]
        cases[code] = tris
    return cases


_TETS = _tet_corner_offsets()
_CASES = _case_triangles()


def extract_isosurface(sdf, iso=0.0, band=None, weight=None):
    """Triangle mesh of the ``sdf == iso`` surface, in voxel coordinates.

    sdf: (X, Y, Z) float; non-finite entries mean "never observed" and are
    skipped. band: skip tets touching voxels with ``|sdf| >= band`` (the
    reference uses 10 * voxel_size, MarchingCubes.h:15). weight: optional
    (X, Y, Z); voxels with weight <= 0 are skipped.

    Returns (verts (V, 3) float32, faces (F, 3) int32), vertices welded,
    triangles wound so normals point toward increasing sdf (outward for
    the inside-negative TSDF convention).
    """
    sdf = np.asarray(sdf, np.float32)
    ok = np.isfinite(sdf)
    if band is not None:
        ok &= np.abs(sdf) < band
    if weight is not None:
        ok &= np.asarray(weight) > 0

    cx, cy, cz = (d - 1 for d in sdf.shape)
    if min(cx, cy, cz) < 1:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    base = np.stack(
        np.meshgrid(
            np.arange(cx), np.arange(cy), np.arange(cz), indexing="ij"
        ),
        axis=-1,
    ).reshape(-1, 3)  # (N, 3) cell origins

    def corner(field, off):
        return field[
            off[0] : off[0] + cx, off[1] : off[1] + cy, off[2] : off[2] + cz
        ].reshape(-1)

    tri_pts = []  # list of (n, 3, 3)
    for offs in _TETS:
        d = np.stack([corner(sdf, o) for o in offs])  # (4, N)
        valid = np.logical_and.reduce([corner(ok, o) for o in offs])
        code = (
            (d[0] < iso) * 1
            + (d[1] < iso) * 2
            + (d[2] < iso) * 4
            + (d[3] < iso) * 8
        )
        # exact gradient of the linear interpolant: rows of M are the fixed
        # corner edge vectors, so Minv is a compile-time constant per tet
        # rows of M are (corner_i - corner_0); M @ g = (d_i - d_0)
        minv = np.linalg.inv((offs[1:] - offs[0]).astype(np.float64))
        for c, tris in _CASES.items():
            sel = np.nonzero(valid & (code == c))[0]
            if sel.size == 0:
                continue
            dsel = d[:, sel]
            g = minv @ (dsel[1:] - dsel[0])  # (3, n) d(sdf)/d(voxel)
            p0 = base[sel]  # (n, 3)

            def edge_vertex(i, j):
                t = (iso - dsel[i]) / (dsel[j] - dsel[i])  # (n,)
                pa = p0 + offs[i]
                pb = p0 + offs[j]
                return pa + t[:, None] * (pb - pa)

            for tri in tris:
                v = np.stack([edge_vertex(i, j) for i, j in tri], axis=1)
                n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
                flip = (n * g.T).sum(1) < 0
                v[flip] = v[flip][:, ::-1]
                tri_pts.append(v)

    if not tri_pts:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    soup = np.concatenate(tri_pts).astype(np.float32)  # (F, 3, 3)
    # weld: vertices are exact edge-interpolation results shared between
    # neighboring tets, so quantized equality is the correct merge key
    flat = soup.reshape(-1, 3)
    keys = np.round(flat * 4096.0).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    rep = np.zeros(len(uniq), np.int64)
    rep[inv] = np.arange(len(flat))  # any occurrence per welded vertex
    verts = flat[rep]
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate triangles produced when an iso crossing lands exactly
    # on a shared corner
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts.astype(np.float32), faces[good]


def grid_to_mesh(grid, band=None):
    """Mesh of a ``tsdf_fusion.VoxelGrid`` in WORLD coordinates.

    band defaults to 10.0: ``normalize_sdfs`` leaves the grid in voxel
    units, where the reference's 10 * voxel_size world-unit debug threshold
    (MarchingCubes.h:15) is exactly 10 voxels.
    """
    if band is None:
        band = 10.0
    verts, faces = extract_isosurface(
        grid.sdf, band=band, weight=grid.weight
    )
    homo = np.concatenate([verts, np.ones((len(verts), 1))], 1)
    world = (grid.grid_to_world @ homo.T).T[:, :3]
    return world.astype(np.float32), faces


def scsdf_to_ply(scsdf_path, ply_path, world_to_grid=None, band=None):
    """Debug-export an .scsdf TSDF as a PLY mesh (Fuser debug output path).

    world_to_grid: optional 4x4; otherwise vertices are placed at
    ``bbox_min + voxel_size * p`` from the .scsdf header.
    """
    from tpu3dsis_torch.datagen.tsdf_fusion import load_scsdf
    from tpu3dsis_torch.tools.ply import write_ply

    sdf, voxel_size, bbox_min, _ = load_scsdf(scsdf_path)
    if band is None:
        band = 10.0  # .scsdf grids are normalized to voxel units
    verts, faces = extract_isosurface(sdf, band=band)
    if world_to_grid is not None:
        g2w = np.linalg.inv(np.asarray(world_to_grid, np.float64))
        homo = np.concatenate([verts, np.ones((len(verts), 1))], 1)
        verts = (g2w @ homo.T).T[:, :3].astype(np.float32)
    else:
        verts = (bbox_min[None] + verts * voxel_size).astype(np.float32)
    write_ply(ply_path, verts, faces=faces)
    return verts, faces
