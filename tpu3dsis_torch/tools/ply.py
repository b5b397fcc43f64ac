"""Minimal PLY I/O (no external plyfile dependency).

Reads ascii / binary_little_endian vertex data (the ScanNet
``*_vh_clean_2.ply`` meshes are binary_little_endian); writes ascii or
binary vertex/face files for the visualization tools.

A copy of the JAX package's ``tpu3dsis/tools/ply.py``, held equal to it by
``tests/test_torch_export.py``.
"""

from __future__ import annotations

import numpy as np

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str):
    """Returns {element_name: structured ndarray}; list props are skipped for
    non-face elements, faces return an (F, 3) int array under 'face'."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        elements = []  # (name, count, [(prop_name, dtype) or ('LIST', ...)])
        for line in header:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property" and elements:
                if parts[1] == "list":
                    elements[-1][2].append(
                        ("LIST", _PLY_TYPES[parts[2]], _PLY_TYPES[parts[3]],
                         parts[4])
                    )
                else:
                    elements[-1][2].append((parts[2], _PLY_TYPES[parts[1]]))

        out = {}
        if fmt == "ascii":
            for name, count, props in elements:
                rows = []
                for _ in range(count):
                    rows.append(f.readline().split())
                if any(p[0] == "LIST" for p in props):
                    faces = [
                        [int(x) for x in row[1 : 1 + int(row[0])]] for row in rows
                    ]
                    out[name] = np.asarray(
                        [fc[:3] for fc in faces], dtype=np.int64
                    )
                else:
                    dt = np.dtype([(p[0], "<" + p[1]) for p in props])
                    arr = np.zeros(count, dtype=dt)
                    for i, row in enumerate(rows):
                        for j, p in enumerate(props):
                            arr[i][p[0]] = float(row[j])
                    out[name] = arr
        elif fmt == "binary_little_endian":
            for name, count, props in elements:
                if any(p[0] == "LIST" for p in props):
                    lp = props[0]
                    cnt_dt = np.dtype("<" + lp[1])
                    val_dt = np.dtype("<" + lp[2])
                    faces = []
                    for _ in range(count):
                        n = int(
                            np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)[0]
                        )
                        vals = np.frombuffer(
                            f.read(val_dt.itemsize * n), val_dt
                        )
                        faces.append(vals[:3])
                    out[name] = np.asarray(faces, dtype=np.int64)
                else:
                    dt = np.dtype([(p[0], "<" + p[1]) for p in props])
                    out[name] = np.frombuffer(
                        f.read(dt.itemsize * count), dt
                    ).copy()
        else:
            raise ValueError(f"unsupported ply format {fmt}")
    return out


def read_mesh_vertices(path: str) -> np.ndarray:
    """(N, 3) float32 xyz (utils.py:68-77 equivalent)."""
    data = read_ply(path)
    v = data["vertex"]
    return np.stack(
        [v["x"], v["y"], v["z"]], axis=1
    ).astype(np.float32)


def write_ply(
    path: str, verts: np.ndarray, colors=None, faces=None, comment="tpu3dsis"
):
    """ascii PLY with optional uchar colors and triangle faces."""
    verts = np.asarray(verts, np.float32)
    n = verts.shape[0]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\ncomment {}\n".format(comment))
        f.write("element vertex {}\n".format(n))
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        if faces is not None:
            f.write("element face {}\n".format(len(faces)))
            f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        if colors is not None:
            colors = np.asarray(colors).astype(np.int64)
            for p, c in zip(verts, colors):
                f.write(
                    f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c[0]} {c[1]} {c[2]}\n"
                )
        else:
            for p in verts:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
        if faces is not None:
            for fc in faces:
                f.write("3 {} {} {}\n".format(*[int(i) for i in fc[:3]]))
