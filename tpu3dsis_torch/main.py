"""The port's command line: the JAX package's ``main.py`` for the test and
benchmark modes, on one NVIDIA card.

    python -m tpu3dsis_torch.main --cfg ScanNet/benchmark --mode test|benchmark \
        [--output_dir ... --tag t --step path.npz|path.pth]

Run from the repository root (the config, anchor and label-map paths are
relative to it; an absolute ``--cfg`` path works too). The config is read
from ``experiments/cfgs/<cfg>.yml`` and dumped into the output directory;
the detector is built on the CUDA card (``--device cpu`` is for tests),
initialised from a ``torch.Generator`` seeded with 0, and ``--step`` loads
a torch ``.pth`` or a native ``.npz`` snapshot through the name-partitioned
``partial_update``; then ``run_scenes`` writes each scene's artifacts into
``TEST_SAVE_DIR`` and, in test mode, prints the mAP.

``--mode train`` runs ``train/loop.py::Trainer`` on the card over
``TRAIN_FILELIST`` for ``--epochs`` (or ``--max_steps``), with float32
master weights and the config's compute dtype, into
``<output_dir>/<cfg>/checkpoints`` and ``logs``; it resumes from the newest
snapshot there, else starts from ``--step`` (through ``partial_update``).
Under ``torchrun --nproc_per_node N`` (or the JAX package's ``TPU3DSIS_*``
variables, one process a card) it trains data parallel over the N cards.
"""

from __future__ import annotations

import argparse
import os
import pprint

import torch
import torch.distributed

from tpu3dsis_torch import checkpoint as ckpt
from tpu3dsis_torch.config import DetectorConfig, cfg_from_file, cfg_to_file, finalize_config
from tpu3dsis_torch.infer.driver import run_scenes
from tpu3dsis_torch.models.detector import Detector
from tpu3dsis_torch.train.loop import Trainer


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="tpu3dsis_torch (3D-SIS on an NVIDIA card)")
    parser.add_argument("--output_dir", type=str, default="../checkpoints/")
    parser.add_argument("--epochs", type=int, default=100000)
    parser.add_argument("--cfg", type=str, default="ScanNet/benchmark")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--tag", type=str, default=None)
    parser.add_argument("--mode", type=str, default="train")
    parser.add_argument("--step", type=str, default="0", help="checkpoint to load (.npz snapshot or torch .pth)")
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (the default), or cpu for tests")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Returns what ``run_scenes`` returns (the mAP dict in test mode), or
    in train mode {"step": the last step}."""
    args = parse_args(argv)
    print("Called with args:")
    print(args)

    cfg = cfg_from_file(os.path.join("experiments", "cfgs", args.cfg + ".yml"))
    cfg.DEBUG = args.debug
    finalize_config(cfg)
    print("Using configs:")
    pprint.pprint(dict(cfg))

    out_dir = os.path.join(args.output_dir, f"{args.cfg}-{args.tag}" if args.tag is not None else args.cfg)
    os.makedirs(out_dir, exist_ok=True)
    dump = os.path.join(out_dir, args.cfg.split("/")[-1] + ".yml")
    if not os.path.isfile(dump):
        cfg_to_file(cfg, dump)

    if args.mode not in ("train", "test", "benchmark"):
        raise SystemExit(f"unknown mode {args.mode}")
    cfg.MODE = args.mode
    # a float32 config computes in float32, as the JAX package does; cuDNN
    # would otherwise run float32 convs in TF32 (10-bit mantissas)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.mode == "train":
        try:
            trainer = Trainer(cfg, out_dir, device=args.device)
            pretrained = args.step if args.step not in ("0", "") else None
            _, step = trainer.train(args.epochs, max_steps=args.max_steps, pretrained=pretrained)
        finally:
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
        return {"step": step}
    det = Detector(DetectorConfig.from_cfg(cfg), device=args.device)
    det.init_params(torch.Generator().manual_seed(0))
    if args.step not in ("0", ""):
        pre = ckpt.load_pth(args.step) if args.step.endswith(".pth") else ckpt.load_snapshot(args.step)[0]
        ckpt.load_jax_params(det, ckpt.partial_update(ckpt.module_params(det), pre, cfg))
    return run_scenes(cfg, det, args.mode)


if __name__ == "__main__":
    main()
