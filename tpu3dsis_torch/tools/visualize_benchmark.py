"""CLI: per-vertex colored PLY from benchmark submission files
(``tools/visualize_benchmark.py``; the reference's
``tools/scannet_benchmark/visualize_benchmark.py``): each mesh vertex takes
its predicted instance's class color (the nyu40 palette).

Run from the repository root as ``python -m
tpu3dsis_torch.tools.visualize_benchmark``, with the root script's arguments.
"""
import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pred_path", required=True)
    p.add_argument("--scan_path", required=True)
    p.add_argument("--output_dir", required=True)
    args = p.parse_args(argv)

    from tpu3dsis_torch.tools.ply import read_mesh_vertices, write_ply
    from tpu3dsis_torch.tools.visualization import create_color_palette

    palette = create_color_palette()
    os.makedirs(args.output_dir, exist_ok=True)
    for txt in sorted(os.listdir(args.pred_path)):
        if not txt.endswith(".txt") or txt == "semantic_instance_evaluation.txt":
            continue
        scene = txt[:-4]
        mesh_file = os.path.join(args.scan_path, scene, scene + "_vh_clean_2.ply")
        if not os.path.isfile(mesh_file):
            continue
        verts = read_mesh_vertices(mesh_file)
        colors = np.zeros((len(verts), 3), np.int64) + np.array([64, 64, 96])
        with open(os.path.join(args.pred_path, txt)) as f:
            for line in f:
                mask_rel, label, _ = line.split()
                mask = np.loadtxt(os.path.join(args.pred_path, mask_rel), dtype=np.int64)
                colors[mask != 0] = palette[int(label) % len(palette)]
        write_ply(os.path.join(args.output_dir, scene + ".ply"), verts, colors=colors)
        print(scene)


if __name__ == "__main__":
    main()
