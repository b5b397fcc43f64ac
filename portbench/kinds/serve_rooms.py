"""Served rooms: one closed-loop client hands the port whole rooms with
their frames through ``SceneInference``, the next room prefetched while the
current one is served (as ``infer/driver.py`` prefetches), and takes back
each room's detections and instance masks.

A room is timed from its first call into the port (its ``prefetch_scene``)
to the return of its ``infer``. Every room is handed in as fresh arrays.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import harness, judge, traffic, weights
from portbench.reference.scene import RoomReference, bucket_shape


class ServeRooms:
    sample_rooms = 6  # rooms the reference checks after the window

    def __init__(self, cfg: dict, mix: dict, seed: int, device="cuda"):
        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.device = torch.device(device)
        self.records = []  # (pool index, t_first, t_done, det, masks)
        self.failed = 0
        self.calls = None

    # --- set-up ------------------------------------------------------------------------
    def setup(self) -> None:
        from tpu3dsis_torch import Detector, DetectorConfig, ProposalConfig, SceneInference

        serve = dict(self.cfg["serve"])
        serve["TEST"] = ProposalConfig(**serve["TEST"])
        for k, v in serve.items():
            if isinstance(v, list):
                serve[k] = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        self.dcfg = DetectorConfig(**serve)
        self.params = weights.make(self.cfg["model"], self.cfg["serve_weights"], self.seed, self.device)
        det = Detector(self.dcfg, device=self.device)
        det.load_state_dict({k: v for k, v in self.params.items()}, strict=True)
        self.si = SceneInference(det, self.dcfg)
        harness.note("program built")
        self.pool = traffic.rooms(self.mix, self.seed, self.cfg["serve"]["INTRINSIC"], self.device)
        harness.note(f"{len(self.pool)} rooms made")
        for i in self.covering():
            self.si.infer(*self.fresh(i))
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        harness.note("every extent and view count served once")
        self.host_path_before = self.si.host_path_scenes

    def covering(self) -> list:
        """A few rooms of the pool that hold every extent (tile batch) and
        every view count (ENet batch) between them: the shapes to warm."""
        extents, views, out = set(), set(), []
        for i, (tsdf, _, frames) in enumerate(self.pool):
            e, v = tsdf.shape[:3], len(frames["poses"])
            if e not in extents or v not in views:
                out.append(i)
                extents.add(e)
                views.add(v)
        return out

    def fresh(self, i: int):
        tsdf, _, frames = self.pool[i]
        return tsdf.copy(), {k: np.array(v, order="C", copy=True) for k, v in frames.items()}

    # --- the window ----------------------------------------------------------------------
    def window(self, seconds: float) -> dict:
        si = self.si
        order = traffic.serve_order(len(self.pool), 1 << 20, self.seed)
        cur = self.fresh(order[0])
        t_start = time.perf_counter()
        t_first = [t_start]
        si.prefetch_scene(cur[0])
        si.prefetch_frames(cur[1], cur[0].shape)
        j = 0
        while True:
            nxt = self.fresh(order[j + 1])
            t_first.append(time.perf_counter())
            si.prefetch_scene(nxt[0])
            si.prefetch_frames(nxt[1], nxt[0].shape)
            try:
                det, masks = si.infer(cur[0], cur[1])
                self.records.append((order[j], t_first[j], time.perf_counter(), det, masks))
            except RuntimeError:
                self.failed += 1
            j += 1
            if time.perf_counter() - t_start >= seconds:
                break
            cur = nxt
        t_end = time.perf_counter()
        si.close()  # joins the last prefetch
        return {"t_start": t_start, "t_end": t_end}

    def end_to_end(self, w: dict) -> dict:
        return {"scenes_per_min": len(self.records) / (w["t_end"] - w["t_start"]) * 60.0}

    def latencies_ms(self) -> list:
        """Each served room's time from its ``prefetch_scene`` to its
        ``infer``'s return."""
        return [(r[2] - r[1]) * 1e3 for r in self.records]

    @property
    def attempted(self) -> int:
        return len(self.records) + self.failed

    def counters(self) -> dict:
        return {"rooms": len(self.records), "host_path_scenes": self.si.host_path_scenes - self.host_path_before}

    def work(self) -> list:
        """What the counts need of each completed room: its bucket shape, views
        and served detections' boxes."""
        return [{"shape": bucket_shape(self.pool[i][0].shape), "views": len(self.pool[i][2]["poses"]),
                 "boxes": det["pred_box"]} for i, _, _, det, _ in self.records]

    def trace_on(self) -> None:
        """Nothing to switch on: the served path has no spans of its own."""

    def free(self) -> None:
        del self.si
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the comparison ----------------------------------------------------------------------
    def sample(self) -> list:
        """Rooms the reference checks: the served room with the most views and
        the largest extent, and others drawn from the seed."""
        n = len(self.records)
        if n == 0:
            return []
        size = [(np.prod(self.pool[r[0]][0].shape[:3]) * len(self.pool[r[0]][2]["poses"])) for r in self.records]
        rng = np.random.RandomState(np.random.SeedSequence([self.seed, 4]).generate_state(4))
        pick = [int(np.argmax(size))]
        for k in rng.permutation(n):
            if len(pick) == min(self.sample_rooms, n):
                break
            if self.records[k][0] not in {self.records[p][0] for p in pick}:
                pick.append(int(k))
        return pick

    def check(self, served=None) -> dict:
        """Numbers of the comparison with the reference over the sampled rooms.
        ``served`` (pool index -> (det, masks)) stands in for the program's
        answers, as the control does."""
        picks = [(self.records[k][0], self.records[k][3], self.records[k][4]) for k in self.sample()] \
            if served is None else [(i, *served[i]) for i in served]
        rooms = []
        for i, det, masks in picks:
            r_det, pool, scene = self.reference(i)
            ref_masks = [self.ref.mask(scene, b, c) for b, c in zip(det["pred_box"], det["pred_class"])]
            rooms.append(judge.room_numbers(det, masks, r_det, pool, ref_masks))
        return judge.combine_rooms(rooms)

    def reference(self, i: int):
        """The reference's detections, pool and padded scene of pool room
        ``i``, computed once."""
        if not hasattr(self, "ref"):
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            self.ref = RoomReference({**self.cfg["model"], **self.cfg["serve"]}, self.params)
            self.ref_rooms = {}
        if i not in self.ref_rooms:
            tsdf, _, frames = self.pool[i]
            r_det, _, pool, scene = self.ref.room(tsdf, frames)
            self.ref_rooms[i] = (r_det, pool, scene)
        return self.ref_rooms[i]

    def control(self) -> dict:
        """The reference in the program's place, its operands cast to float8:
        the answers it serves for the sampled rooms."""
        from portbench.reference import nets

        ref = RoomReference({**self.cfg["model"], **self.cfg["serve"]}, self.params, nets.Precision("fp8_cast"))
        out = {}
        for k in self.sample():
            i = self.records[k][0]
            tsdf, _, frames = self.pool[i]
            det, masks, _, _ = ref.room(tsdf, frames)
            out[i] = (det, masks)
        return out


def make(cfg, mix, seed, device="cuda"):
    return ServeRooms(cfg, mix, seed, device)

