"""Find a serving cell's knee once, by a sweep of offered rates on the card.

    python3 portbench/sweep.py --workload <cell> --rates 3,4,5,6 \
        --seconds 40 [--seed N] [--out FILE]

One process builds and warms the cell's program once, then offers the
cell's traffic open loop at each rate for ``--seconds`` and finishes the
requests due.  Per rate it prints the end-to-end metrics and the count
of requests waiting for a slot (the batcher's ``queued``) over the
window: its mean in the first and the last third and at the close.  The
knee is the highest rate at which that count does not grow over the
window; the cell's rate is a fixed number in its workload file.  The
benchmark's own runs never run this.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import flops  # noqa: E402
from portbench import run as bench_run  # noqa: E402
from portbench.drivers import serve_open  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=20261018)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    _, _, wl, cfg = bench_run.load_cell(args.workload)
    ctx = bench_run.SimpleNamespace(config=cfg, workload=wl, seed=args.seed,
                                    seconds=args.seconds, trace=False,
                                    device=torch.device("cuda"), chips=1)
    t = time.perf_counter()
    _, _, batcher = serve_open.setup(ctx)
    print(json.dumps({"setup_s": time.perf_counter() - t}), flush=True)
    sink = open(args.out, "a") if args.out else None
    T = args.seconds
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        traffic = {**wl["traffic"], "rate_per_s": rate}
        reqs = serve_open.generator(wl).generate(
            traffic, args.seed + k, T, flops.sizes(cfg)["vocab"])
        waiting = []
        w = serve_open.window(ctx, batcher, reqs, T, waiting=waiting)
        e2e, _, failed = serve_open.summary(reqs, w["clock"], T)
        q = np.array([(a, n) for a, n in waiting if a <= T] or [(0, 0)])
        third = [q[(q[:, 0] >= lo * T / 3) & (q[:, 0] < (lo + 1) * T / 3), 1]
                 for lo in (0, 2)]
        row = {"rate_per_s": rate, "requests": len(reqs), "failed": failed,
               **e2e, "queued_first_third": float(np.mean(third[0]))
               if third[0].size else 0.0,
               "queued_last_third": float(np.mean(third[1]))
               if third[1].size else 0.0,
               "queued_at_close": int(q[-1, 1]),
               "finished_after_s": float(np.nanmax(w["clock"].last)),
               "stats": w["stats"]}
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
