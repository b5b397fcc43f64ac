"""CLI: remap consecutive class ids -> nyu40 ids in benchmark .txt files.

Run from the repository root as ``python -m tpu3dsis_torch.tools.proj_label``, with
the arguments of ``tools/proj_label.py``.
"""
import argparse


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--pred_path", default="./ScanNet_Benchmark_Result")
    args = p.parse_args()
    from tpu3dsis_torch.eval.scannet_benchmark import remap_benchmark_labels

    remap_benchmark_labels(args.pred_path)


if __name__ == "__main__":
    main()
