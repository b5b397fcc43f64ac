"""CLI: export ScanNet gt annotation files for benchmark evaluation.

Equivalent of tools/scannet_benchmark/export_train_mesh_for_evaluation.py.

Run from the repository root as ``python -m tpu3dsis_torch.tools.export_gt``, with
the arguments of ``tools/export_gt.py``.
"""
import argparse


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scan_path", required=True)
    p.add_argument("--filelist", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--label_map_file", required=True,
                   help="scannetv2-labels.combined.tsv")
    p.add_argument("--label_map_file2", required=True,
                   help="nyu40labels_scannet.csv")
    p.add_argument("--type", required=True, choices=["label", "instance"])
    args = p.parse_args()

    from tpu3dsis_torch.eval.gt_export import export_scans

    export_scans(args.scan_path, args.filelist, args.label_map_file,
                 args.label_map_file2, args.type, args.output_dir)


if __name__ == "__main__":
    main()
