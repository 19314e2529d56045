"""The readers of the program's spans (``portbench/spans.py`` and the
metrics that read ``exprgrad_torch.tracing.spans()``) on synthetic span
records, each number worked out by hand; none reads anything without a
device trace or without the program's spans."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from exprgrad_torch import tracing
from portbench import run as bench_run
from portbench.harness import Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = ["serve.queue_p95_ms", "serve.first_token_hold_p95_ms",
                "serve.prefill_share", "train.optimizer_share",
                "train.general_share"]
MS = 10**6  # nanoseconds a millisecond


def span(sid, name, start_ms, end_ms, parent=None, rid=None, device_s=None,
         **attrs):
    return {"name": name, "id": sid, "parent": parent, "rid": rid,
            "attrs": attrs, "start_ns": int(start_ms * MS),
            "end_ns": int(end_ms * MS), "device_s": device_s}


def traced_run():
    return SimpleNamespace(trace=Trace(kernels=[("k", 0.0, 0.1)],
                                       busy_s=0.1, window_s=1.0),
                           counters={}, sizes={})


def read(monkeypatch, metric, records, run=None):
    monkeypatch.setattr(tracing, "spans", lambda: records)
    return bench_run.reader(metric)(run or traced_run())


def chat_spans():
    """Two steps: the first admits requests 1 and 2 (1's prefill picks its
    first token, 2's is a chunk), the second admits request 3 inside the
    dense reservation; 20 more queued waits from earlier requests."""
    out = [
        span(1, "egt.batcher.step", 0, 100),
        span(2, "egt.batcher.prefill", 5, 30, 1, rid=1, first=True,
             tokens=100, width=128, prefix_tokens=0),
        span(3, "egt.batcher.prefill", 30, 40, 1, rid=2, first=False,
             tokens=64, width=64, prefix_tokens=0),
        span(4, "egt.batcher.dispatch", 40, 90, 1),
        span(5, "egt.batcher.step", 100, 300),
        span(6, "egt.batcher.admit", 100, 160, 5),
        span(7, "egt.batcher.prefill", 110, 150, 6, rid=3, first=True,
             tokens=10, width=16, prefix_tokens=0),
    ]
    # queued: 1 ms, 2 ms, ..., 20 ms
    out += [span(100 + i, "egt.batcher.queued", 0, i, rid=100 + i)
            for i in range(1, 21)]
    return out


def test_queue_p95(monkeypatch):
    # numpy's rule over 1..20: 1 + 0.95 * 19
    assert read(monkeypatch, "serve.queue_p95_ms", chat_spans()) == \
        pytest.approx(19.05)


def test_first_token_hold_p95(monkeypatch):
    # first units: 100 - 30 = 70 ms (step 1), 300 - 150 = 150 ms (step 2,
    # through the admit span); the chunk unit does not count
    got = read(monkeypatch, "serve.first_token_hold_p95_ms", chat_spans())
    assert got == pytest.approx(70 + 0.95 * (150 - 70))


def test_prefill_share(monkeypatch):
    # prefills 25 + 10 + 40 ms of steps 100 + 200 ms
    assert read(monkeypatch, "serve.prefill_share", chat_spans()) == \
        pytest.approx(100 * 75 / 300)


def train_spans():
    """Two runs of device seconds 1.0 and 1.2; kernels by phase and path."""
    out = [span(1, "egt.executor.run", 0, 10, device_s=1.0, target="train"),
           span(2, "egt.executor.alloc", 0, 1, 1, device_s=0.05),
           span(3, "egt.executor.kernel", 1, 2, 1, device_s=0.5,
                index=0, phase="forward", path="einsum"),
           span(4, "egt.executor.kernel", 2, 3, 1, device_s=0.3,
                index=1, phase="backward", path="general-direct"),
           span(5, "egt.executor.kernel", 3, 4, 1, device_s=0.15,
                index=2, phase="optimizer", path="einsum"),
           span(6, "egt.executor.run", 10, 20, device_s=1.2, target="train"),
           span(7, "egt.executor.kernel", 11, 12, 6, device_s=0.6,
                index=0, phase="forward", path="general-structured"),
           span(8, "egt.executor.kernel", 12, 13, 6, device_s=0.35,
                index=1, phase="backward", path="extern:attention_grad"),
           span(9, "egt.executor.kernel", 13, 14, 6, device_s=0.25,
                index=2, phase="optimizer", path="general-direct")]
    return out


def test_optimizer_share(monkeypatch):
    assert read(monkeypatch, "train.optimizer_share", train_spans()) == \
        pytest.approx(100 * (0.15 + 0.25) / 2.2)


def test_general_share(monkeypatch):
    assert read(monkeypatch, "train.general_share", train_spans()) == \
        pytest.approx(100 * (0.3 + 0.6 + 0.25) / 2.2)


def test_train_shares_need_device_seconds(monkeypatch):
    host_only = [dict(s, device_s=None) for s in train_spans()]
    for metric in ("train.optimizer_share", "train.general_share"):
        assert read(monkeypatch, metric, host_only) is None


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_nothing_without_a_trace_or_spans(monkeypatch, metric):
    records = chat_spans() + train_spans()
    no_trace = SimpleNamespace(trace=None, counters={}, sizes={})
    assert read(monkeypatch, metric, records, no_trace) is None
    # a slice with no device operation (a run on the CPU)
    empty = SimpleNamespace(trace=Trace(), counters={}, sizes={})
    assert read(monkeypatch, metric, records, empty) is None
    assert read(monkeypatch, metric, []) is None


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_nothing_from_a_program_without_spans(monkeypatch, metric):
    """An older program has no ``exprgrad_torch.tracing``: the reader
    gives nothing and raises nothing."""
    import sys
    monkeypatch.setitem(sys.modules, "exprgrad_torch.tracing", None)
    monkeypatch.delattr(sys.modules["exprgrad_torch"], "tracing",
                        raising=False)
    assert bench_run.reader(metric)(traced_run()) is None


def test_each_span_metric_is_declared_for_its_cell():
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    for metric in SPAN_METRICS:
        cell = ("mistral7b.chat" if metric.startswith("serve.")
                else "codestral22b.train")
        assert per_layer[metric]["workloads"] == [cell]
