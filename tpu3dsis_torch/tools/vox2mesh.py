"""CLI: voxel predictions -> ScanNet benchmark mesh-vertex instance format.

Equivalent of the reference tools/scannet_benchmark/vox2mesh.py driver.

Run from the repository root as ``python -m tpu3dsis_torch.tools.vox2mesh``, with
the arguments of ``tools/vox2mesh.py``.
"""
import argparse
import os


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--pred_dir", required=True)
    p.add_argument("--output_dir", default="./ScanNet_Benchmark_Result")
    p.add_argument("--scan_path", required=True)
    p.add_argument("--frames", required=True)
    args = p.parse_args()

    from tpu3dsis_torch.eval.scannet_benchmark import export_scene

    scenes = sorted(os.listdir(args.pred_dir))
    for i, scene in enumerate(scenes):
        pred_folder = os.path.join(args.pred_dir, scene)
        mesh_file = os.path.join(args.scan_path, scene, scene + "_vh_clean_2.ply")
        if not os.path.isdir(pred_folder) or not os.path.exists(mesh_file):
            continue
        print(f"{i}/{len(scenes)} {scene}")
        export_scene(
            pred_folder,
            mesh_file,
            os.path.join(args.frames, scene, "world2grid.txt"),
            args.output_dir,
            scene,
        )


if __name__ == "__main__":
    main()
