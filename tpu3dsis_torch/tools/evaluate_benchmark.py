"""CLI: official ScanNet semantic-instance evaluation.

Equivalent of the reference tools/scannet_benchmark/evaluate_semantic_instance.py.

Run from the repository root as ``python -m tpu3dsis_torch.tools.evaluate_benchmark``, with
the arguments of ``tools/evaluate_benchmark.py``.
"""
import argparse
import os


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--pred_path", required=True)
    p.add_argument("--gt_path", required=True)
    p.add_argument("--output_file", default="")
    args = p.parse_args()

    from tpu3dsis_torch.eval.scannet_benchmark import evaluate

    out = args.output_file or os.path.join(
        args.pred_path, "semantic_instance_evaluation.txt"
    )
    pred_files = [
        f
        for f in os.listdir(args.pred_path)
        if f.endswith(".txt") and f != "semantic_instance_evaluation.txt"
    ]
    gt_files = [os.path.join(args.gt_path, f) for f in pred_files]
    pred_files = [os.path.join(args.pred_path, f) for f in pred_files]
    evaluate(pred_files, gt_files, output_file=out)


if __name__ == "__main__":
    main()
