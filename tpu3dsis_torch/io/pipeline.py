"""Host data pipeline for training: parallel decode and prefetch
(``tpu3dsis/io/pipeline.py``).

A thread pool decodes `.chunk` files and pads them to fixed shapes
(``pad_sample``) while the card runs the previous step, through a bounded
queue. Samples without gt boxes are skipped, as in the reference train loop
(``lib/model/trainval.py:330-331``), and so are files that fail to decode.
Where the JAX loader takes the native decoder (chunk-mode geometry
training, ``io/dataset.py::load_fast_padded``), so does this one, and the
numpy path serves what it declines; ``native=False`` keeps to numpy. The
decoder is built before the first file is read, so that a failed build
raises to the caller rather than dropping every sample.

Batches are dicts of stacked arrays; the volumes and boxes become torch
tensors, in pinned memory with ``pin_memory`` so the train step's upload
does not block, while the poses and world-to-grid matrices stay numpy: the
view fusion reads them on the host. ``TPU_COMPACT_TRANSFERS`` keeps the
mask canvas as uint8 (exact: the step casts each window it crops); the
TSDF stays float32 here and is cast to the compute dtype on the card.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tpu3dsis_torch.io.dataset import SceneDataset, fast_path_applies, load_fast_padded, pad_sample
from tpu3dsis_torch.runtime import native as native_decoder

_HOST_KEYS = ("poses", "world_to_grid")  # read on the host by the view fusion


class PrefetchLoader:
    """Iterable over stacked fixed-shape batches."""

    def __init__(self, dataset: SceneDataset, cfg, batch_size: int, shuffle: bool = True, seed: int = 0,
                 num_workers: int = 4, prefetch: int = 2, pin_memory: bool = False, native: bool = True):
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self.native = native and fast_path_applies(dataset, cfg)

    def __len__(self):
        return max(1, len(self.dataset) // self.batch_size)

    def _load_one(self, idx):
        try:
            padded = load_fast_padded(self.dataset, self.dataset.scenes[idx], self.cfg) if self.native else None
            if padded is None:
                sample = self.dataset[idx]
                if sample.gt_box.shape[0] == 0:
                    return None
                padded = pad_sample(sample, self.cfg)
        except Exception:  # corrupt file: skip (the reference crashes)
            return None
        if bool(self.cfg.get("TPU_COMPACT_TRANSFERS", False)):
            padded["mask_canvas"] = padded["mask_canvas"].astype(np.uint8)
        return padded

    def _stack(self, batch: list) -> dict:
        out = {}
        for k in batch[0]:
            arr = np.stack([b[k] for b in batch])
            if k in _HOST_KEYS:
                out[k] = arr
                continue
            t = torch.from_numpy(arr)
            out[k] = t.pin_memory() if self.pin_memory else t
        return out

    def __iter__(self):
        if self.native:
            native_decoder.load_library()
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                batch = []
                # a bounded window of files in flight (the JAX loader maps the
                # whole epoch at once, so its workers decode ahead without limit)
                window = 2 * self.num_workers
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for start in range(0, len(order), window):
                        for padded in pool.map(self._load_one, order[start:start + window]):
                            if stop.is_set():
                                return
                            if padded is None:
                                continue
                            batch.append(padded)
                            if len(batch) == self.batch_size:
                                q.put(self._stack(batch))
                                batch = []
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
        finally:
            stop.set()
            while t.is_alive():  # let a producer blocked on a full queue finish
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(0.05)
