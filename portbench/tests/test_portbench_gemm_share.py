"""``train.gemm_kernel_share`` on synthetic span records, each number
worked out by hand, in the style of ``test_portbench_tracing_metrics.py``:
0 where no kernel span carries the path ``einsum-b1``, nothing without a
device trace or without the program's spans."""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

from exprgrad_torch import tracing
from portbench import run as bench_run
from portbench.harness import Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
METRIC = "train.gemm_kernel_share"
MS = 10**6


def span(sid, name, start_ms, end_ms, parent=None, device_s=None, **attrs):
    return {"name": name, "id": sid, "parent": parent, "rid": None,
            "attrs": attrs, "start_ns": int(start_ms * MS),
            "end_ns": int(end_ms * MS), "device_s": device_s}


def traced_run():
    return SimpleNamespace(trace=Trace(kernels=[("k", 0.0, 0.1)],
                                       busy_s=0.1, window_s=1.0),
                           counters={}, sizes={})


def read(monkeypatch, records, run=None):
    monkeypatch.setattr(tracing, "spans", lambda: records)
    return bench_run.reader(METRIC)(run or traced_run())


def train_spans(paths):
    """Two runs of device seconds 1.0 and 1.5; three kernels each, of
    device seconds 0.5, 0.3, 0.2 and 0.7, 0.4, 0.4, on ``paths``."""
    secs = (0.5, 0.3, 0.2, 0.7, 0.4, 0.4)
    out = [span(1, "egt.executor.run", 0, 10, device_s=1.0, target="train"),
           span(2, "egt.executor.run", 10, 20, device_s=1.5,
                target="train")]
    for i, (path, s) in enumerate(zip(paths, secs)):
        out.append(span(10 + i, "egt.executor.kernel", i, i + 1,
                        1 if i < 3 else 2, device_s=s, index=i % 3,
                        phase="forward", path=path))
    return out


def test_share_of_the_kernel_path(monkeypatch):
    paths = ["einsum-b1", "general-direct", "einsum",
             "einsum-b1", "einsum-b1", "extern:attention"]
    assert read(monkeypatch, train_spans(paths)) == \
        100 * (0.5 + 0.7 + 0.4) / 2.5


def test_zero_where_no_span_carries_the_path(monkeypatch):
    paths = ["einsum", "general-direct", "einsum", "einsum", "matmul",
             "extern:attention"]
    assert read(monkeypatch, train_spans(paths)) == 0.0


def test_nothing_without_a_trace_or_spans(monkeypatch):
    records = train_spans(["einsum-b1"] * 6)
    assert read(monkeypatch, records,
                SimpleNamespace(trace=None, counters={}, sizes={})) is None
    assert read(monkeypatch, records,
                SimpleNamespace(trace=Trace(), counters={},
                                sizes={})) is None
    assert read(monkeypatch, []) is None
    host_only = [dict(s, device_s=None) for s in records]
    assert read(monkeypatch, host_only) is None


def test_nothing_from_a_program_without_spans(monkeypatch):
    monkeypatch.setitem(sys.modules, "exprgrad_torch.tracing", None)
    monkeypatch.delattr(sys.modules["exprgrad_torch"], "tracing",
                        raising=False)
    assert bench_run.reader(METRIC)(traced_run()) is None


def test_declared_for_the_training_cell():
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == METRIC]
    assert m == {"name": METRIC, "unit": "%", "better": "higher",
                 "source": "device_trace", "layer": "executor and lowering",
                 "moves": "train_tokens_per_s",
                 "workloads": ["codestral22b.train"]}
    assert BENCH["per_layer"][-1] is m or BENCH["per_layer"][-1] == m
