"""Metrics logging (``tpu3dsis/utils/logger.py``, a copy): JSONL always;
TensorBoard as well where ``torch.utils.tensorboard`` imports.

The reference's TF1 FileWriter logger (``lib/utils/logger.py:12-70``) with
its three summaries: scalars, images and histograms. Scalar tags mirror the
reference (total_loss, rpn_* per level, cross_entropy, loss_box, loss_mask,
AP_ROI, mAP_CLASSIFICATION, mAP_MASK; trainval.py:387-431, 613-632). Images
and histograms go to TensorBoard where it is there, and always to a sidecar
(png files, JSONL histogram statistics).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


class Logger:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        except Exception:
            pass

    def scalar_summary(self, tag: str, value, step: int):
        self._jsonl.write(
            json.dumps(
                {"ts": time.time(), "step": int(step), tag: float(value)}
            )
            + "\n"
        )
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def image_summary(self, tag: str, images, step: int):
        """Log a list of (H, W) or (H, W, 3) arrays (logger.py:23-44).

        Float inputs are min-max scaled to uint8 like scipy.misc.toimage's
        default; each image i lands under tag/i.
        """
        for i, img in enumerate(images):
            arr = np.asarray(img)
            if arr.dtype != np.uint8:
                lo, hi = float(arr.min()), float(arr.max())
                scale = 255.0 / (hi - lo) if hi > lo else 0.0
                arr = ((arr - lo) * scale).astype(np.uint8)
            if self._tb is not None:
                fmt = "HW" if arr.ndim == 2 else "HWC"
                self._tb.add_image(f"{tag}/{i}", arr, int(step),
                                   dataformats=fmt)
            else:  # sidecar: keep the capability without TensorBoard
                try:
                    from PIL import Image

                    d = os.path.join(self.log_dir, "images")
                    os.makedirs(d, exist_ok=True)
                    Image.fromarray(arr).save(
                        os.path.join(d, f"{tag.replace('/', '_')}"
                                        f"_{i}_{int(step)}.png")
                    )
                except Exception:
                    pass

    def histo_summary(self, tag: str, values, step: int, bins: int = 1000):
        """Log a histogram of a tensor of values (logger.py:46-75)."""
        values = np.asarray(values).reshape(-1)
        if self._tb is not None:
            self._tb.add_histogram(tag, values, int(step), bins=bins)
        counts, edges = np.histogram(values, bins=min(bins, 64))
        self._jsonl.write(
            json.dumps({
                "ts": time.time(), "step": int(step), "histogram": tag,
                "min": float(values.min()), "max": float(values.max()),
                "mean": float(values.mean()), "std": float(values.std()),
                "num": int(values.size),
                "counts": counts.tolist(),
                "edges": [round(float(e), 6) for e in edges],
            }) + "\n"
        )
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
