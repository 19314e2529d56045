"""Every per-layer metric's reader on a synthetic trace and counters, and
the trace reduction itself."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import flops
from portbench import run as bench_run
from portbench.harness import SLICE, Trace, reduce_events

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def cfg(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def test_reduce_events_busy_gaps_and_ops():
    host = [(SLICE, 0.0, 100.0), ("portbench.step", 10.0, 90.0),
            ("aten::item", 40.0, 60.0), ("portbench.submit", 92.0, 98.0)]
    device = [("k1", 5.0, 20.0), ("k2", 15.0, 30.0), ("k1", 70.0, 80.0),
              ("k3", 95.0, 120.0)]
    t = reduce_events(device, host)
    assert t.window_s == pytest.approx(100e-6)
    # union: [5,30] + [70,80] + [95,100] (clipped to the slice)
    assert t.busy_s == pytest.approx(40e-6)
    assert t.device_ops[0] == ["k1", pytest.approx(25e-6)]
    assert t.time_of("k1") == (pytest.approx(25e-6), 2)
    gaps = dict((n, s) for n, s in t.idle_gaps)
    # [30,70]'s middle is inside aten::item; [0,5] outside any host span
    assert gaps["aten::item"] == pytest.approx(40e-6)
    assert gaps["portbench.step"] == pytest.approx(15e-6)  # [80, 95]
    assert gaps["(no host span)"] == pytest.approx(5e-6)
    assert reduce_events(device, []).kernels == []


def run_for(config, trace=None, **counters):
    return SimpleNamespace(trace=trace, counters=counters,
                           sizes=flops.sizes(cfg(config)))


def trace_of(*kernels, window=1.0):
    busy = sum(d for _, _, d in kernels)
    return Trace(kernels=list(kernels), busy_s=busy, window_s=window)


def test_serving_readers():
    s = flops.sizes(cfg("mistral-7b-v0.1"))
    contexts = [300, 600, 900]
    bound = flops.b7_bound_s(s, contexts)
    tr = trace_of(("void paged_split_kernel<float, bf16, 4>", 0.0, bound),
                  ("paged_merge_kernel<float>", 0.1, bound),
                  ("gemm", 0.2, 0.5))
    run = run_for("mistral-7b-v0.1", tr, b7_contexts=contexts,
                  slice_step_s=[0.5, 0.5], slice_flops=165e12 * 0.25,
                  submit_lag_ms=[1.0] * 19 + [100.0])
    read = {m: bench_run.reader(m)(run) for m in (
        "serve.b7_roofline", "serve.mfu", "serve.device_idle",
        "serve.submit_lag_p95_ms")}
    assert read["serve.b7_roofline"] == pytest.approx(50.0)
    assert read["serve.mfu"] == pytest.approx(25.0)
    assert read["serve.device_idle"] == pytest.approx(
        100 * (1 - (2 * bound + 0.5)))
    assert read["serve.submit_lag_p95_ms"] == pytest.approx(5.95)


def test_training_readers():
    s = flops.sizes(cfg("codestral-22b-v0.1"))
    fwd = flops.flash_bound_s(s, 1, 4096, "fwd")
    dq = flops.flash_bound_s(s, 1, 4096, "dq")
    dkv = flops.flash_bound_s(s, 1, 4096, "dkv")
    tr = trace_of(("void flash_fwd_kernel<float, 128>", 0, 2 * fwd),
                  ("void flash_bwd_dq_kernel<float, 128>", 0, 2 * dq),
                  ("void flash_bwd_dkv_kernel<float, 128>", 0, 2 * dkv),
                  ("einsum", 0, 0.5), window=2.0)
    run = run_for("codestral-22b-v0.1", tr, batch=1, seq=4096,
                  host_ms_per_step=12.5, window_s=10.0,
                  model_flops=165e12 * 10.0 * 0.3)
    assert bench_run.reader("train.flash_roofline")(run) == \
        pytest.approx(50.0)
    assert bench_run.reader("train.mfu")(run) == pytest.approx(30.0)
    assert bench_run.reader("train.host_ms_per_step")(run) == 12.5
    assert bench_run.reader("train.device_idle")(run) == pytest.approx(
        100 * (1 - tr.busy_s / 2.0))


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]
                                    if m["source"] == "device_trace"])
def test_device_readers_give_nothing_without_a_trace(metric):
    run = run_for("mistral-7b-v0.1", None, batch=1, seq=64)
    assert bench_run.reader(metric)(run) is None
    empty = run_for("mistral-7b-v0.1", Trace(), batch=1, seq=64)
    assert bench_run.reader(metric)(empty) is None
