"""The port's spans (``exprgrad_torch/tracing.py``) on the CPU.

Off (no profiler records) a span is one shared null context and nothing
is kept; on, every span is a profiler event that is no user annotation
(so the profiler gives it no device copy) and a record in memory whose
parent and request id nest as the code does.  A paged batcher drive
records every batcher span, and each request's ``queue_s`` and
``prefill_s`` add up to its ``ttft_s``; a DSL train step's kernel spans
partition its run into forward, backward and optimizer phases, and
their lowering paths are the paths ``lowering_stats`` counts.
"""

import json
import threading
import time
from collections import Counter

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

import exprgrad_torch as egt
from exprgrad_torch import ir, tracing
from exprgrad_torch.models import (ContinuousBatcher, FlashLMServer,
                                   flash_transformer)

VOCAB = 16
BATCHER = ("egt.batcher.step", "egt.batcher.admit", "egt.batcher.prefill",
           "egt.batcher.queued", "egt.batcher.dispatch",
           "egt.batcher.readback", "egt.batcher.apply")
PATH_KEYS = ("einsum", "matmul", "matmul-fused", "rowchain", "mapreduce",
             "conv")


def _model():
    return egt.compile(flash_transformer(vocab=VOCAB, dim=32, heads=4,
                                         blocks=2, max_seq=64),
                       seed=0, device="cpu")


def _drive(model, prefix=None, **kw):
    """Serve four prompts (one longer than a page pool of 6 holds beside
    the others, so a request is preempted); returns (batcher, rids)."""
    b = ContinuousBatcher(FlashLMServer(model), slots=2, capacity=64,
                          paged=True, page_size=4, pool_pages=kw.pop(
                              "pool_pages", 6), **kw)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, VOCAB, n).astype(np.float32)
               for n in (5, 9, 3, 12)]
    if prefix is not None:
        b.register_prefix(prefix)
        prompts = [np.concatenate([prefix, p]) for p in prompts]
    rids = [b.submit(p, 8) for p in prompts]
    b.run()
    return b, rids


def _train_args(seed=0):
    toks = np.random.default_rng(seed).integers(0, VOCAB, (2, 12))
    return {"tokens": toks.astype(np.float32),
            "labels": np.eye(VOCAB, dtype=np.float32)[(toks + 1) % VOCAB]}


def _traced(fn):
    """``fn()`` under a CPU profiler, the ring emptied first; returns
    (its result, the spans, the profiler)."""
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, tracing.spans(), prof


def test_off_a_span_is_one_shared_null_and_nothing_is_recorded():
    tracing.clear()
    assert not tracing.enabled()
    assert tracing.span("a") is tracing.span("b", rid=3, device=True, x=1)
    with tracing.span("a") as s:
        assert s is None
    tracing.record("a", 0, 1)
    model = _model()
    _drive(model)
    model.epoch = 1
    model.apply("train", _train_args())
    assert tracing.spans() == []


def test_spans_are_profiler_events_and_no_user_annotations():
    model = _model()
    _, spans, prof = _traced(lambda: _drive(model))
    events = [e for e in prof.events() if e.name.startswith("egt.")]
    names = {e.name for e in events}
    # queued is recorded in memory only (its start lies in the past)
    assert names == set(BATCHER) - {"egt.batcher.queued"}
    assert not any(e.is_user_annotation for e in events)
    assert Counter(e.name for e in events) == Counter(
        s["name"] for s in spans if s["name"] != "egt.batcher.queued")


def test_parents_and_request_ids_nest():
    tracing.clear()
    seen = {}

    def other():
        with tracing.span("t.other") as s:
            seen["other"] = s.parent

    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("t.outer", rid=7) as outer:
            with tracing.span("t.inner", k=1) as inner:
                thread = threading.Thread(target=other)
                thread.start()
                thread.join()
                tracing.record("t.late", inner.start_ns - 5,
                               time.perf_counter_ns(), rid=8, n=2)
            with tracing.span("t.second"):
                pass
        with tracing.span("t.top"):
            pass
    by = {s["name"]: s for s in tracing.spans()}
    assert by["t.outer"]["parent"] is None and by["t.outer"]["rid"] == 7
    assert by["t.inner"]["parent"] == outer.id
    assert by["t.inner"]["attrs"] == {"k": 1} and by["t.inner"]["rid"] is None
    assert by["t.second"]["parent"] == outer.id
    assert by["t.top"]["parent"] is None
    assert seen["other"] is None  # another thread has its own stack
    late = by["t.late"]
    assert late["parent"] is None and late["rid"] == 8
    assert late["attrs"] == {"n": 2}
    assert late["start_ns"] == inner.start_ns - 5
    assert late["start_ns"] < late["end_ns"]
    assert all(s["device_s"] is None for s in by.values())
    # the order is the order the spans ended
    assert [s["name"] for s in tracing.spans()] == [
        "t.other", "t.late", "t.inner", "t.second", "t.outer", "t.top"]


def test_batcher_spans_nest_by_step_and_request():
    model = _model()
    (b, rids), spans, _ = _traced(lambda: _drive(model))
    by_id = {s["id"]: s for s in spans}
    steps = [s for s in spans if s["name"] == "egt.batcher.step"]
    assert all(s["parent"] is None for s in steps)
    for s in spans:
        if s["name"] in ("egt.batcher.step", "egt.batcher.queued"):
            continue
        up = by_id[s["parent"]]
        while up["parent"] is not None:
            up = by_id[up["parent"]]
        assert up["name"] == "egt.batcher.step", s
        assert up["start_ns"] <= s["start_ns"] <= s["end_ns"] <= up["end_ns"]
    prefills = [s for s in spans if s["name"] == "egt.batcher.prefill"]
    assert {s["rid"] for s in prefills} == set(rids)
    queued = [s for s in spans if s["name"] == "egt.batcher.queued"]
    assert sorted(s["rid"] for s in queued) == sorted(rids)
    for q in queued:
        first = min((p for p in prefills if p["rid"] == q["rid"]),
                    key=lambda p: p["start_ns"])
        assert q["end_ns"] >= first["start_ns"] - 10**6
        assert q["start_ns"] <= q["end_ns"]
    # one dispatch, read back and applied, in each step that decoded
    for name in ("egt.batcher.dispatch", "egt.batcher.readback",
                 "egt.batcher.apply"):
        inside = Counter(s["parent"] for s in spans if s["name"] == name)
        assert set(inside.values()) == {1}, name
    assert sum(s["attrs"]["rows"] > 0 for s in steps) == \
        b.stats["dispatches"]


@pytest.mark.parametrize("kw", [dict(), dict(decode_chunk=3),
                                dict(decode_chunk=2, pipeline=1),
                                dict(prefill_chunk=4, pool_pages=8)],
                         ids=["step", "chunk", "pipeline", "prefill_chunk"])
def test_paged_drive_records_every_span_and_times_each_request(kw):
    model = _model()
    (b, rids), spans, _ = _traced(lambda: _drive(model, **kw))
    names = Counter(s["name"] for s in spans)
    assert set(names) == set(BATCHER), names
    metrics = b.request_metrics()
    assert sorted(m["rid"] for m in metrics) == sorted(rids)
    for m in metrics:
        assert m["queue_s"] >= 0 and m["prefill_s"] > 0
        assert m["prefix_tokens"] == 0
        if "prefill_chunk" not in kw:
            # one unit until the first token: nothing runs between them
            assert m["queue_s"] + m["prefill_s"] == pytest.approx(
                m["ttft_s"], abs=1e-3)
        else:
            assert m["queue_s"] + m["prefill_s"] <= m["ttft_s"] + 1e-3
    if "prefill_chunk" not in kw:
        assert b.stats["preemptions"] > 0
    # the counters against the spans: every prefilled token, its padding,
    # and every generated token either admission's or a decode dispatch's
    prefills = [s["attrs"] for s in spans
                if s["name"] == "egt.batcher.prefill"]
    stats = b.stats
    assert stats["prefill_tokens"] == sum(a["tokens"] for a in prefills)
    assert stats["prefill_padded_tokens"] == sum(
        a["width"] - a["tokens"] for a in prefills)
    assert stats["prefill_tokens"] >= sum(m["prompt_tokens"]
                                          for m in metrics)
    admitted = sum(s["attrs"]["admitted"] for s in spans
                   if s["name"] == "egt.batcher.step")
    assert sum(m["generated_tokens"] for m in metrics) == \
        stats["decode_tokens"] + admitted
    assert sum(a["first"] for a in prefills) == len(rids)
    assert all(a["width"] >= a["tokens"] > 0 for a in prefills)


def test_dense_admission_and_prefix_tokens():
    model = _model()
    prefix = np.arange(8, dtype=np.float32) % VOCAB
    (b, rids), spans, _ = _traced(lambda: _drive(model, prefix=prefix,
                                                 pool_pages=14))
    prefills = [s for s in spans if s["name"] == "egt.batcher.prefill"]
    assert {s["attrs"]["prefix_tokens"] for s in prefills} == {8}
    assert {m["prefix_tokens"] for m in b.request_metrics()} == {8}
    assert b.stats["prefix_hits"] >= len(rids)
    # the dense batcher prefills inside the reservation
    b = ContinuousBatcher(FlashLMServer(model), slots=2, capacity=64)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        rid = b.submit(np.ones(6, np.float32), 4)
        b.run()
    spans = tracing.spans()
    by_id = {s["id"]: s for s in spans}
    (pre,) = [s for s in spans if s["name"] == "egt.batcher.prefill"]
    assert by_id[pre["parent"]]["name"] == "egt.batcher.admit"
    assert pre["rid"] == rid and pre["attrs"]["tokens"] == 6
    assert pre["attrs"]["width"] == 8 and pre["attrs"]["first"] is True
    (m,) = b.request_metrics()
    assert m["queue_s"] + m["prefill_s"] == pytest.approx(m["ttft_s"],
                                                          abs=1e-3)
    assert b.stats["decode_tokens"] == 3 and b.stats["prefill_tokens"] == 6


def test_train_kernel_spans_partition_the_run_into_phases():
    model = _model()
    model.epoch = 1
    _, spans, _ = _traced(lambda: model.apply("train", _train_args()))
    (run,) = [s for s in spans if s["name"] == "egt.executor.run"]
    (alloc,) = [s for s in spans if s["name"] == "egt.executor.alloc"]
    kernels = [s for s in spans if s["name"] == "egt.executor.kernel"]
    assert run["attrs"] == {"target": "train"} and run["parent"] is None
    assert alloc["parent"] == run["id"]
    assert all(k["parent"] == run["id"] for k in kernels)
    assert all(s["device_s"] is None for s in spans)  # no CUDA events
    (ex,) = model._executors.values()
    target = model.program.targets["train"]
    # every kernel the plan runs once, in order
    ran = [i for i in range(len(target.kernels))
           if i not in ex._skip_kernels]
    assert [k["attrs"]["index"] for k in kernels] == ran
    order = [k["attrs"]["phase"] for k in kernels]
    assert order == sorted(order, key=["forward", "backward",
                                       "optimizer"].index)
    assert set(order) == {"forward", "backward", "optimizer"}
    for k in kernels:
        kernel = target.kernels[k["attrs"]["index"]]
        kind = model.program.tensors[kernel.write.tensor].kind
        writes_state = kind in (ir.TensorKind.PARAM, ir.TensorKind.CACHE)
        assert (k["attrs"]["phase"] == "optimizer") == writes_state
        if not writes_state:
            assert (k["attrs"]["phase"] == "backward") == kernel.derived
    # the paths of the first run are the paths lowering_stats counted
    stats = model.lowering_stats("train")
    paths = {k: v for k, v in stats.items()
             if k in PATH_KEYS or k.startswith(("general-", "extern:"))}
    assert Counter(k["attrs"]["path"] for k in kernels) == paths
    # a later run's kernels take the same paths
    model.epoch = 2
    _, again, _ = _traced(lambda: model.apply("train", _train_args(1)))
    assert [(k["attrs"]["index"], k["attrs"]["path"])
            for k in again if k["name"] == "egt.executor.kernel"] == [
        (k["attrs"]["index"], k["attrs"]["path"]) for k in kernels]


def test_derived_marks_do_not_change_the_program_text():
    model = _model()
    target = model.program.targets["train"]
    assert any(k.derived for k in target.kernels)
    assert not any(k.derived for k in model.program.targets[
        "predict"].kernels)
    text = model.emit_ir("train")
    for k in target.kernels:
        k.derived = not k.derived
    assert model.emit_ir("train") == text


def test_device_seconds_chain_one_event_per_boundary(monkeypatch):
    """``device=True`` brackets a span with two events; a span started
    from the previous one's end event shares it, so a chain's seconds
    add up to the whole's."""

    class Event:
        clock = [0.0]

        def __init__(self):
            Event.clock[0] += 1.5
            self.t = Event.clock[0]

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return (end.t - self.t) * 1e3  # milliseconds, as CUDA's

    made = []
    monkeypatch.setattr(tracing, "_event",
                        lambda: made.append(Event()) or made[-1])
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("t.whole", device=True):
            with tracing.span("t.a", device=True) as a:
                pass
            with tracing.span("t.b", device=a.end_event) as b:
                pass
            with tracing.span("t.c", device=b.end_event):
                pass
        with tracing.span("t.host"):
            pass
    by = {s["name"]: s["device_s"] for s in tracing.spans()}
    # whole's two, a's two, then one at each later boundary
    assert len(made) == 6
    assert [by[n] for n in ("t.a", "t.b", "t.c")] == pytest.approx(
        [1.5] * 3)
    assert by["t.whole"] == pytest.approx(7.5) and by["t.host"] is None


def test_model_profile_trace_holds_the_executor_spans(tmp_path):
    model = _model()
    args = {"tokens": np.zeros((1, 8), np.float32)}
    model.call("predict", args)
    tracing.clear()
    model.profile("predict", args, str(tmp_path))
    trace = json.loads((tmp_path / "predict.pt.trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"egt.executor.run", "egt.executor.alloc",
            "egt.executor.kernel"} <= names
    assert not tracing.enabled()
    spans = tracing.spans()
    assert {s["name"] for s in spans} == {
        "egt.executor.shapes", "egt.executor.run", "egt.executor.alloc",
        "egt.executor.kernel"}
    (shapes,) = [s for s in spans if s["name"] == "egt.executor.shapes"]
    (run,) = [s for s in spans if s["name"] == "egt.executor.run"]
    assert shapes["attrs"] == {"target": "predict"}
    assert shapes["end_ns"] <= run["start_ns"]
