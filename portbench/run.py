"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its file
``portbench/workloads/<cell>.json`` names the driver
(``portbench/drivers/<driver>.py``), the traffic and the limits of the
check, and its configuration's file holds the model's sizes.  With
``--trace 0`` the result's metrics are the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, each read by
``portbench/metrics/<metric>.py`` from a profiled slice of the window
and the run's counters.  The last line of standard output is one JSON
object; the numbers the check compared, each beside its limit, are the
last lines of standard error.  Needs a CUDA device; imports the port
(``exprgrad_torch``) and never JAX.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_cell(name: str) -> tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json, its workload entry, the workload file, the
    configuration file) of cell ``name``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    workload = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    config = json.loads((ROOT / conf["file"]).read_text())
    return bench, entry, workload, config


def cell_metrics(bench: dict, name: str, trace: bool) -> list[dict]:
    """The metrics a cell reports: with ``trace`` its per-layer metrics
    (listed for it, or moving an end-to-end metric it reports), else
    its end-to-end metrics."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]


def reader(metric: str):
    """The reader of a per-layer metric: ``portbench/metrics/<name>.py``'s
    ``read(run) -> number or None``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(workload: dict, config: dict, metrics: list,
             seed: int, seconds: float, trace: bool, device,
             chips: int = 1, marks: list = None) -> dict:
    """Run the cell's driver once and assemble the result line (the
    chip's presence is the caller's to check).  ``marks`` are the
    ``(phase, perf_counter)`` pairs of the set-up so far, the first the
    start of ``setup_s``; the run adds its own phases."""
    import torch

    from portbench import flops
    from portbench.harness import mark

    marks = list(marks or [("start", T0)])
    ctx = SimpleNamespace(config=config, workload=workload, seed=int(seed),
                          seconds=float(seconds), trace=bool(trace),
                          device=torch.device(device), chips=chips,
                          marks=marks)
    ctx.setup_done = lambda: mark(ctx, "setup done")
    torch.empty(1, device=ctx.device)
    mark(ctx, "device context")
    driver = importlib.import_module(f"portbench.drivers.{workload['driver']}")
    out = driver.run(ctx)
    at = dict(marks)
    values = dict(out["e2e"])
    values["setup_s"] = at["setup done"] - marks[0][1]
    split = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])
             if a[0] != "setup done"}
    run = SimpleNamespace(trace=out["trace"], counters=out["counters"],
                          sizes=flops.sizes(config))
    result = {}
    for m in metrics:
        v = reader(m["name"])(run) if trace else values.get(m["name"])
        if v is None:
            if not trace:
                raise SystemExit(f"the driver gave no {m['name']}")
            continue
        result[m["name"]] = {"value": float(v), "unit": m["unit"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": result,
            "device": out["device"]}
    if trace and out["trace"] is not None:
        line["breakdown"] = {"device_ops": out["trace"].device_ops,
                             "idle_gaps": out["trace"].idle_gaps}
    line["notes"] = {**out.get("notes", {}), "setup_split_s": split}
    line["compared"] = {k: {"value": float(v), "limit": float(lim)}
                        for k, (v, lim) in out["compared"].items()}
    return line


def finish(line: dict) -> int:
    """Print the result: the numbers compared, each beside its limit, as
    the last lines of standard error, and the line as the last of
    standard output; or, if JAX or the JAX package is loaded now, name
    it on standard error and print no result."""
    from portbench.harness import forbidden_modules

    found = forbidden_modules()
    if found:
        say(f"forbidden modules loaded by the end of the run: "
            f"{', '.join(found)}")
        return 3
    for k, c in line["compared"].items():
        say(f"compared {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the program in the checkout, at fixed paths
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(build / "exprgrad_torch" / "triton" / "cache"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))
    sys.path.insert(0, str(ROOT))
    from portbench.harness import forbidden_modules

    bench, entry, workload, config = load_cell(args.workload)
    import torch

    marks = [("start", T0), ("import torch", time.perf_counter())]
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        say(f"needs {chips} CUDA device(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    found = forbidden_modules()
    if found:
        say(f"forbidden modules loaded before the run: {', '.join(found)}")
        return 3
    metrics = cell_metrics(bench, args.workload, bool(args.trace))
    try:
        line = run_cell(workload, config, metrics, args.seed, args.seconds,
                        bool(args.trace), "cuda", chips, marks)
    except SystemExit as err:
        say(str(err))
        return 4
    say("setup_split_s " + json.dumps(line["notes"]["setup_split_s"]))
    return finish(line)


if __name__ == "__main__":
    sys.exit(main())
