"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``BENCHMARK.json`` names the cells). Set-up
builds the program and its inputs from the seed and warms every shape the
cell uses; the window then drives the port for ``--seconds``; with
``--trace 1`` the window runs under ``torch.profiler`` and the line holds
the cell's per-layer metrics, else its end-to-end metrics. After the window
the program's answers are compared with the plain reference
(``portbench/reference``), each number against its limit
(``portbench/limits/<workload>.json``). Without a CUDA card, with JAX or
the JAX package loaded, or without the program, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time

from portbench import calls as C
from portbench import harness


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(args) -> tuple:
    """One run: (the result line, the check's lines for standard error)."""
    harness.prepare_environment()
    harness.guard_jax("at the start")
    bench = harness.benchmark()
    w = harness.cell(bench, args.workload)
    cfg = harness.config(w["config"])
    from portbench import traffic

    mix = traffic.load(w["traffic"])
    harness.require_cards(int(w["chips"]))
    kind = importlib.import_module(f"portbench.kinds.{mix['kind']}").make(cfg, mix, args.seed)
    return drive(kind, bench, args.workload, args.seconds, bool(args.trace), int(w["chips"]))


def drive(kind, bench: dict, workload: str, seconds: float, trace: bool, chips: int = 1) -> tuple:
    """A run after the look for the card: set-up, the window (traced or
    not), the metrics, the program freed, the comparison."""
    import torch
    from torch.profiler import record_function

    from portbench import judge

    cuda = kind.device.type == "cuda"
    kind.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = harness.process_age_s()
    if trace:
        kind.trace_on()
    with C.recording(trace) as recorded, harness.profiled(trace) as prof:
        with record_function(harness.WINDOW_SPAN) if trace else contextlib.nullcontext():
            span = kind.window(seconds)
            if cuda:
                torch.cuda.synchronize()
    harness.guard_jax("after the window")
    harness.note("window closed")
    device = harness.device_facts(chips, kind.device)
    e2e = kind.end_to_end(span)
    e2e["setup_s"] = setup_s
    ctx = {"kind": kind, "cfg": kind.cfg, "window_s": span["t_end"] - span["t_start"], "trace": None,
           "calls": C.materialize(recorded), "counters": kind.counters()}
    metrics, brk = {}, None
    if trace:
        ctx["trace"] = harness.read_profile(prof)
        device["busy_s"], device["window_s"] = harness.device_busy(ctx["trace"])
        brk = harness.breakdown(ctx["trace"]["kernels"], ctx["trace"]["host"], ctx["trace"]["window"])
        metrics = harness.per_layer(bench, workload, ctx)
        harness.note("trace read")
    else:
        for m in harness.metrics_of(bench, workload, "end_to_end"):
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    kind.free()
    numbers = kind.check()
    harness.note("reference compared")
    correct, check = judge.decide(numbers, harness.limits(workload))
    harness.guard_jax("before the result")
    lines = [f"card: {device['kind']}, power limit {harness.nvidia_smi('power.limit') if cuda else 'none'}"]
    lines += [f"check {k}: {json.dumps(v)}" for k, v in check.items()]
    line = harness.result_line(correct, kind.attempted, kind.failed, metrics, device, check, brk)
    return line, lines


def main(argv=None) -> int:
    args = parse(argv)
    t0 = time.perf_counter()
    try:
        line, lines = run(args)
    except harness.RunError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    except ImportError as e:
        print(f"portbench: the program is missing: {e}", file=sys.stderr)
        return 2
    print(f"run took {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    for text in lines:
        print(text, file=sys.stderr)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
