"""CLI: PLY visualization of a .chunk file or of saved prediction results
(``tools/visualize.py``; the reference's ``tools/visualization.py:340-505``).

Run from the repository root:

    python -m tpu3dsis_torch.tools.visualize --mode chunk --chunk <file.chunk> --out <dir> [--cfg <yml>]
    python -m tpu3dsis_torch.tools.visualize --mode result --result_dir <TEST_SAVE_DIR/scene> --out <dir>

``--mode data`` is the root script's name for ``chunk``.
"""
import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mode", choices=["chunk", "data", "result"], required=True)
    p.add_argument("--chunk")
    p.add_argument("--result_dir")
    p.add_argument("--out", required=True)
    p.add_argument("--cfg", default=None)
    args = p.parse_args(argv)

    from tpu3dsis_torch.tools.visualization import visualize_chunk, visualize_result

    if args.mode in ("chunk", "data"):
        from tpu3dsis_torch.config import cfg_from_file, default_config

        cfg = cfg_from_file(args.cfg) if args.cfg else default_config()
        visualize_chunk(args.chunk, args.out, cfg)
    else:
        visualize_result(args.result_dir, args.out)


if __name__ == "__main__":
    main()
