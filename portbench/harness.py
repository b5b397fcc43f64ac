"""What every cell's run shares: the benchmark's file, the cell's
configuration and traffic, the guard against JAX, the card's facts, the
profiler's reading, the per-layer readers and the result line."""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG_DIR = ROOT / "configs"
METRIC_DIR = ROOT / "metrics"
LIMIT_DIR = ROOT / "limits"
CACHE_DIR = ROOT / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu3dsis")


class RunError(RuntimeError):
    """A run that cannot give a result: it exits non-zero and prints none."""


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's start time."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's, its
    libraries' or the JAX package's."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def guard_jax(where: str) -> None:
    found = forbidden_modules()
    if found:
        raise RunError(f"{where}: modules {found} are loaded; the benchmark runs the PyTorch port alone")


def prepare_environment() -> None:
    """Keep JAX out and every cache in the checkout, at fixed paths."""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE_DIR / sub)
    sys.modules.setdefault("torch.utils.tensorboard", None)


def benchmark(path: str = "BENCHMARK.json") -> dict:
    if not Path(path).is_file():
        raise RunError(f"{path} not found: run from the root of a checkout")
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise RunError(f"no workload {workload!r} in BENCHMARK.json")


def config(name: str) -> dict:
    with open(CONFIG_DIR / f"{name}.json") as f:
        return json.load(f)


def limits(workload: str) -> dict:
    with open(LIMIT_DIR / f"{workload}.json") as f:
        return json.load(f)


def metrics_of(bench: dict, workload: str, section: str) -> list:
    """The metrics of ``section`` that this cell reports."""
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


def require_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise RunError("no CUDA device: the benchmark measures the port on the card")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell asks for {chips} cards, {torch.cuda.device_count()} are present")


def nvidia_smi(query: str) -> str:
    try:
        res = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return res.stdout.strip().splitlines()[0].strip()


def device_facts(chips: int, device) -> dict:
    import torch

    if device.type != "cuda":  # the tests' runs on the CPU
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}


def p95(values) -> float:
    """The 95th percentile of all values (linear between order statistics)."""
    v = sorted(values)
    if not v:
        return math.nan
    k = (len(v) - 1) * 0.95
    lo, hi = math.floor(k), math.ceil(k)
    return v[lo] + (v[hi] - v[lo]) * (k - lo)


# --- the profiler ---------------------------------------------------------------------
@contextlib.contextmanager
def profiled(enabled: bool):
    """The window under ``torch.profiler`` (CPU and CUDA) when enabled."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


WINDOW_SPAN = "portbench.window"


def read_profile(prof) -> dict:
    """Of a finished profile: the device's operations [(name, start_us,
    end_us)] (kernels, copies, fills), the host's events [(name, start_us,
    end_us)] and the window (start_us, end_us) of the ``WINDOW_SPAN`` span,
    from the profiler's raw events (building its event tree takes minutes
    for a window of this size)."""
    kernels, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns() / 1e3, e.end_ns() / 1e3
        on_card = e.device_type().name == "CUDA"
        if e.name() == WINDOW_SPAN:  # the span, and its own range on the card's timeline
            if not on_card:
                window = (start, end)
        elif on_card:
            if not e.is_user_annotation():
                kernels.append((e.name(), start, end))
        else:
            host.append((e.name(), start, end))
    if window is None:
        raise RunError("the profile holds no window span")
    kernels = [k for k in kernels if k[2] > window[0] and k[1] < window[1]]
    kernels = [(n, max(s, window[0]), min(e, window[1])) for n, s, e in kernels]
    return {"kernels": kernels, "host": host, "window": window}


def busy_union(intervals) -> list:
    """Merged [start, end] intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_busy(trace: dict) -> tuple:
    """(busy_s, window_s): the union of the device's operations within the
    window, and the window's length."""
    busy = sum(e - s for s, e in busy_union([(s, e) for _, s, e in trace["kernels"]]))
    w = trace["window"]
    return busy / 1e6, (w[1] - w[0]) / 1e6


def kernel_seconds(trace: dict, names) -> float:
    """Device seconds of the operations whose name contains one of ``names``."""
    return sum(e - s for n, s, e in trace["kernels"] if any(k in n for k in names)) / 1e6


def breakdown(kernels, host, window) -> dict:
    """The ten device operations that took most time and the ten longest
    idle gaps, each named by the innermost host event under its middle."""
    by_name = {}
    for name, s, e in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = [(n[:160], t) for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    busy = busy_union([(s, e) for _, s, e in kernels])
    gaps, prev = [], window[0]
    for s, e in busy + [[window[1], window[1]]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    import numpy as np

    starts = np.fromiter((h[1] for h in host), np.float64, len(host))
    ends = np.fromiter((h[2] for h in host), np.float64, len(host))
    named = []
    for a, b in gaps:
        mid = (a + b) / 2
        inner = np.flatnonzero((starts <= mid) & (ends >= mid))
        name = host[inner[np.argmin(ends[inner] - starts[inner])]][0][:160] if len(inner) else "host: no profiled op"
        named.append([name, (b - a) / 1e6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


# --- per-layer readers ----------------------------------------------------------------
def reader(name: str):
    path = METRIC_DIR / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer(bench: dict, workload: str, ctx: dict) -> dict:
    """Each per-layer metric of the cell that its reader finds something
    for, as {name: {"value", "unit"}}."""
    out = {}
    for m in metrics_of(bench, workload, "per_layer"):
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict, check: dict,
                breakdown_: dict | None = None) -> str:
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed), "metrics": metrics,
            "device": device}
    if breakdown_ is not None:
        line["breakdown"] = breakdown_
    line["check"] = check
    return json.dumps(line)


def note(msg: str) -> None:
    """A line on standard error with the process's age."""
    print(f"[{process_age_s():7.1f} s] {msg}", file=sys.stderr, flush=True)
