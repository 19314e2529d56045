"""Readings that set a cell's limits: the program's numbers over many
seeds, and the control's (the reference in the next precision down,
TF32) and each planted fault's on some of them, in one process.

    python3 portbench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 --seconds <s> [--out FILE]

Each seed runs the cell's driver once at the cell's own sizes and load
(a window of ``--seconds``), then, on a control seed, the driver's
``control``: the numbers the check compares, read with the control or
the fault in the program's place.  One JSON line a seed goes to standard
output (and ``--out``); the last line gives, for each number, the
largest program reading (the lower end of its limit) and the smallest
control reading (the upper end).  The benchmark's own runs never run
this.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import importlib

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench, entry, workload, config = bench_run.load_cell(args.workload)
    driver = importlib.import_module(
        f"portbench.drivers.{workload['driver']}")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    sink = open(args.out, "a") if args.out else None
    lower: dict = {}
    upper: dict = {}
    for seed in seeds:
        t = time.perf_counter()
        ctx = bench_run.SimpleNamespace(
            config=config, workload=workload, seed=seed,
            seconds=args.seconds, trace=False,
            device=torch.device("cuda"), chips=1, setup_at=None)
        ctx.setup_done = lambda c=ctx: setattr(c, "setup_at",
                                               time.perf_counter())
        out = driver.run(ctx)
        row = {"seed": seed, "correct": out["correct"],
               "program": {k: v for k, (v, _) in out["compared"].items()},
               "e2e": out["e2e"], "notes": out.get("notes", {})}
        for k, v in row["program"].items():
            lower[k] = max(lower.get(k, 0.0), v)
        if seed in controls:
            for kind, read in driver.control(ctx, out).items():
                row[kind] = read
                for k, v in read.items():
                    key = f"{kind}.{k}"
                    upper[key] = min(upper.get(key, float("inf")), v)
        row["seconds"] = time.perf_counter() - t
        del out
        torch.cuda.empty_cache()
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    summary = json.dumps({"lower": lower, "upper": upper})
    print(summary, flush=True)
    if sink:
        sink.write(summary + "\n")
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
