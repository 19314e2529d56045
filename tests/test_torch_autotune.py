"""Port parity: measured schedule autotuning (exprgrad_torch/autotune.py)
against the JAX package's (exprgrad_tpu/autotune.py,
tests/test_autotune.py), on the CPU.

CPU timings are real but not the card's, so these tests pin the
MECHANISM, test by test as tests/test_autotune.py does: candidates
enumerated (the original schedule, the schedule-stripped plain lowering
and the per-loop tile sweeps), the argmin chosen and installed, the
output unchanged, ``schedule_mode`` pinned to "force", the tuning
persisted through ``export_tuning``/``apply_tuning`` and a checkpoint, and
a training target's parameters left untouched.  The JAX package's
``test_autotune_requires_jax_backend`` has no counterpart: the port's
``Model`` has no backend to choose.

Two parity tests hand a tuning across the packages: one set by hand on
a JAX model (no timing, so the test is deterministic) applies to the
port's model of the same source, and the other way round; each side's
``export_tuning`` then equals the other's key for key, and the two
models' outputs agree at float32's ``rtol=1e-5``.
"""

import json

import numpy as np
import pytest
import torch

import exprgrad_torch as egt
import exprgrad_torch.layers
import exprgrad_tpu
from exprgrad_torch.autotune import (STRIP_LABEL, apply_tuning,
                                     export_tuning)
from exprgrad_torch.errors import ModelRuntimeError
from exprgrad_torch.io import load_model, save_model
from exprgrad_tpu import autotune as jax_autotune

# the packages' float32 products against each other: the JAX package's
# Pallas kernel (interpret mode) sums in float32, the port's plain
# version in float64; 64-term sums of unit normals
F32 = dict(rtol=1e-5, atol=1e-5)

pytestmark = pytest.mark.filterwarnings(
    "ignore::exprgrad_tpu.ScheduleWarning",
    "ignore::exprgrad_torch.ScheduleWarning",
)


def _graph(m, schedule=True):
    y, x, it = m.iters("y", "x", "it")
    a, b = m.input("a"), m.input("b")
    c = m.Fun("c")
    c[y, x] = a[y, it] * b[it, x]
    if schedule:
        c.schedule(tile={"y": 128, "x": 128, "it": 128},
                   parallel=["y", "x"])
    return c.target("c")


def _args(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": rng.normal(size=(m, k)).astype(np.float32),
        "b": rng.normal(size=(k, n)).astype(np.float32),
    }


def _matmul_model(schedule=True, m=256, k=256, n=256):
    model = egt.compile(_graph(egt, schedule), device="cpu")
    return model, _args(m, k, n)


def _schedules(model, target="c"):
    return [[(loop.schedule.tile, loop.schedule.parallel,
              loop.schedule.tile_size, loop.schedule.share_cache)
             for loop in kernel.loops]
            for kernel in model.program.targets[target].kernels]


def test_autotune_reports_and_installs():
    model, args = _matmul_model()
    want = model.call("c", args)

    report = model.autotune("c", args, tile_sizes=(128, 256), reps=1,
                            chain=2)
    assert isinstance(report, egt.TuneReport)
    # one scheduled kernel; candidates = original + strip + per-loop sweeps
    assert len(report.entries) == 1
    entry = report.entries[0]
    assert entry.writes == "c"
    labels = [c["label"] for c in entry.candidates]
    assert labels[:2] == ["original schedule", STRIP_LABEL]
    assert sorted(labels[2:]) == ["tile it=256", "tile x=256", "tile y=256"]
    # chosen is the measured argmin of the final descent state: it can
    # never be slower than the original-schedule measurement
    assert entry.chosen is not None
    assert entry.chosen["seconds"] <= entry.candidates[0]["seconds"] + 1e-9
    # installed: later calls honor the tuned schedule and stay correct
    assert model.schedule_mode == "force" and not model._executors
    assert _schedules(model)[0] == entry.chosen["schedule"]
    got = model.call("c", args)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    # report renders a table
    text = str(report)
    assert "autotune 'c'" in text and "ms" in text and STRIP_LABEL in text


def test_autotune_tuned_time_recorded():
    model, args = _matmul_model()
    report = model.autotune("c", args, tile_sizes=(128,), reps=1, chain=2)
    assert report.baseline_s > 0 and report.tuned_s > 0
    assert report.speedup > 0


def test_autotune_unknown_target():
    model, args = _matmul_model()
    with pytest.raises(ModelRuntimeError, match="target"):
        model.autotune("nope", args)


def test_autotune_unscheduled_target_is_noop():
    """A target with no scheduled kernels tunes to itself (no entries)."""
    model, args = _matmul_model(schedule=False)
    report = model.autotune("c", args, reps=1, chain=1)
    assert report.entries == []
    got = model.call("c", args)
    np.testing.assert_allclose(got, args["a"] @ args["b"], rtol=2e-4,
                               atol=2e-4)


def test_export_apply_tuning_roundtrip(tmp_path):
    """Tuned schedules survive checkpoint save/load via export/apply."""
    model, args = _matmul_model()
    model.autotune("c", args, tile_sizes=(256,), reps=1, chain=1)
    want = model.call("c", args)
    tuning = export_tuning(model, "c")
    # JSON round-trip (the on-disk form)
    tuning = json.loads(json.dumps(tuning))

    ckpt = tmp_path / "m.egt"
    save_model(model, str(ckpt))
    loaded = load_model(str(ckpt), device="cpu")
    apply_tuning(loaded, tuning)
    assert loaded.schedule_mode == "force"

    # schedules on the loaded program match the tuned ones exactly
    assert _schedules(loaded) == _schedules(model)
    got = loaded.call("c", args)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_apply_tuning_rejects_mismatched_source():
    model, args = _matmul_model()
    tuning = export_tuning(model, "c")
    other, _ = _matmul_model(schedule=False)
    tuning_bad = dict(tuning, n_kernels=tuning["n_kernels"] + 1)
    with pytest.raises(ModelRuntimeError, match="source changed"):
        apply_tuning(other, tuning_bad)
    with pytest.raises(ModelRuntimeError, match="format"):
        apply_tuning(model, {"format": 99})
    with pytest.raises(ModelRuntimeError, match="target"):
        apply_tuning(model, dict(tuning, target="nope"))
    with pytest.raises(ModelRuntimeError, match="target"):
        export_tuning(model, "nope")


def test_autotune_training_target_leaves_params_untouched():
    """Tuning a mutating target must not step the model's params."""
    y, x, it = egt.iters("y", "x", "it")
    w = egt.param([64, 64], (-0.1, 0.1), name="w")
    inp, lbl = egt.input("inp"), egt.input("lbl")
    pred = egt.Fun("pred")
    pred[y, x] = inp[y, it] * w[it, x]
    pred.schedule(tile={"y": 128, "x": 128, "it": 128})
    loss = egt.layers.mse(pred, lbl)
    graph = (
        loss.target("loss")
        .backwards()
        .optimize(egt.make_opt(egt.layers.gradient_descent, rate=0.1))
        .target("train")
    )
    model = egt.compile(graph, seed=3, device="cpu")
    rng = np.random.default_rng(1)
    args = {
        "inp": rng.normal(size=(32, 64)).astype(np.float32),
        "lbl": rng.normal(size=(32, 64)).astype(np.float32),
    }
    before = {tid: v.clone() for tid, v in model.params.items()}
    epoch = model.epoch
    model.autotune("train", args, tile_sizes=(128,), reps=1, chain=1)
    assert model.epoch == epoch
    for tid, v in model.params.items():
        assert torch.equal(v, before[tid]), tid
    # and training still works afterwards
    l0 = float(model.call("loss", args)[0])
    for _ in range(3):
        model.apply("train", args)
    assert float(model.call("loss", args)[0]) < l0


# --- a tuning handed across the packages ----------------------------------

def _set_by_hand(model):
    """A tuning no timing chose: y tiled 64, x 256, k untouched."""
    (kernel,) = model.program.targets["c"].kernels
    for loop in kernel.loops:
        name = kernel.regs[loop.iter_reg].name
        loop.schedule.tile_size = {"y": 64, "x": 256}.get(
            name, loop.schedule.tile_size)


def _both():
    jax_model = exprgrad_tpu.compile(_graph(exprgrad_tpu), backend="jax")
    port = egt.compile(_graph(egt), device="cpu")
    return jax_model, port, _args(128, 64, 256, seed=7)


def test_jax_tuning_applies_to_the_port():
    ref, port, args = _both()
    _set_by_hand(ref)
    tuning = jax_autotune.export_tuning(ref, "c")
    jax_autotune.apply_tuning(ref, tuning)
    apply_tuning(port, json.loads(json.dumps(tuning)))
    assert port.schedule_mode == "force"
    assert export_tuning(port, "c") == tuning
    assert _schedules(port) == _schedules(ref)
    got = port.call("c", args)
    (ex,) = port._executors.values()
    assert ex.stats == {"matmul": 1}
    sm = ex._lowerings[0].scheduled_matmul()
    # (64, 256) is not built: the larger axis steps down
    assert (sm.bm, sm.bn, sm.bk) == (64, 128, 64)
    np.testing.assert_allclose(got, np.asarray(ref.call("c", args)), **F32)


def test_port_tuning_applies_to_jax():
    ref, port, args = _both()
    _set_by_hand(port)
    tuning = export_tuning(port, "c")
    apply_tuning(port, tuning)
    jax_autotune.apply_tuning(ref, json.loads(json.dumps(tuning)))
    assert ref.schedule_mode == "force"
    assert jax_autotune.export_tuning(ref, "c") == tuning
    assert _schedules(ref) == _schedules(port)
    np.testing.assert_allclose(port.call("c", args),
                               np.asarray(ref.call("c", args)), **F32)
    assert ref.lowering_stats("c") == {"pallas": 1}
    assert port.lowering_stats("c") == {"matmul": 1}
