"""The readings that a cell's limits are set from, in one process on the
card: the program's comparison numbers over many seeds, the control's (the
reference in the program's place, its operands in float8) and those of
each fault planted under the timed path (``portbench/faults.py``).

    python3 -m portbench.readings --workload <name> --seeds <first>:<count> \\
        --seconds <s> [--controls <n>] [--faults a,b,c] [--out <file>]

Each run is a set-up, a short window at the cell's own load and the
comparison, as the benchmark's runs make them; one JSON line per reading.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys

import torch

from portbench import faults, harness, judge, traffic


def one(workload: str, seed: int, seconds: float, what: str = "program") -> dict:
    bench = harness.benchmark()
    w = harness.cell(bench, workload)
    cfg, mix = harness.config(w["config"]), traffic.load(w["traffic"])
    mod = importlib.import_module(f"portbench.kinds.{mix['kind']}")
    serving = mix["kind"] == "serve_rooms"
    fault = contextlib.nullcontext()
    if what not in ("program", "control"):
        fault = faults.serve(what) if serving else faults.train(what)
    kind = mod.make(cfg, mix, seed)
    with fault:
        kind.setup()
        kind.window(seconds)
        torch.cuda.synchronize()
    kind.free()
    numbers = kind.check()
    out = {"workload": workload, "seed": seed, "what": what, "numbers": numbers}
    if what == "control":  # the program's own numbers of this seed stay as a reading too
        out["program_numbers"] = numbers
        out["numbers"] = kind.check(served=kind.control())
    ok, _ = judge.decide(out["numbers"], harness.limits(workload))
    out["correct_by_current_limits"] = ok
    del kind
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="first:count")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--controls", type=int, default=0)
    p.add_argument("--faults", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    harness.prepare_environment()
    harness.require_cards(1)
    first, count = (int(x) for x in args.seeds.split(":"))
    plan = [(first + i, "program") for i in range(count)]
    plan += [(first + 1000 + i, "control") for i in range(args.controls)]
    plan += [(first + 2000 + i, f) for i, f in enumerate(x for x in args.faults.split(",") if x)]
    sink = open(args.out, "a") if args.out else None
    for seed, what in plan:
        line = json.dumps(one(args.workload, seed, args.seconds, what))
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    harness.guard_jax("readings")
    return 0


if __name__ == "__main__":
    sys.exit(main())
