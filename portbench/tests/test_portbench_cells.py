"""Both cells end to end at a CPU size (the chip's look skipped): the
result line, and ``correct`` coming out false when the timed path is
broken underneath, once for each fault the cell can have."""

import json

import pytest
import torch

from exprgrad_torch.model import Model
from exprgrad_torch.models import ContinuousBatcher

from helpers import run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell,metrics", [
    ("mistral7b.chat", {"ttft_p95_ms", "tpot_p95_ms", "serve_tokens_per_s",
                        "setup_s"}),
    ("codestral22b.train", {"train_tokens_per_s", "setup_s"})])
def test_cell_runs_correct_at_a_cpu_size(cell, metrics):
    line = run_tiny(cell)
    assert list(line)[:5] == KEYS and list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == metrics
    assert all(m["value"] > 0 for m in line["metrics"].values())
    json.dumps(line)


@pytest.mark.parametrize("cell,metrics", [
    ("codestral22b.train", {"train.host_ms_per_step", "train.mfu"}),
    ("mistral7b.chat", {"serve.submit_lag_p95_ms", "serve.mfu"})])
def test_traced_run_reports_host_metrics_and_a_breakdown(cell, metrics):
    line = run_tiny(cell, trace=True)
    assert line["correct"] is True
    # the CPU has no device trace: only the host's metrics are read
    assert set(line["metrics"]) == metrics
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0


def test_no_result_once_jax_is_loaded(monkeypatch, capsys):
    """A metric reader that loads JAX (here a stub that plants it in
    ``sys.modules``) leaves the run without a result line."""
    import sys

    from portbench import run as bench_run

    def planting(metric):
        def read(run):
            monkeypatch.setitem(sys.modules, "jax", object())
            return 1.0
        return read

    assert "jax" not in sys.modules
    monkeypatch.setattr(bench_run, "reader", planting)
    line = run_tiny("codestral22b.train", trace=True)
    capsys.readouterr()
    assert bench_run.finish(line) != 0
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err
    sys.modules.pop("jax")
    assert bench_run.finish(line) == 0
    assert json.loads(capsys.readouterr().out) == line


def test_served_token_altered_is_not_correct(monkeypatch):
    emit = ContinuousBatcher._emit

    def altered(self, slot, token):
        return emit(self, slot, (int(token) + 1) % self.server.vocab)

    monkeypatch.setattr(ContinuousBatcher, "_emit", altered)
    line = run_tiny("mistral7b.chat")
    assert line["correct"] is False
    assert line["compared"]["logit_gap"]["value"] > \
        line["compared"]["logit_gap"]["limit"]


def test_train_step_leaving_state_unchanged_is_not_correct(monkeypatch):
    apply = Model.apply
    monkeypatch.setattr(Model, "apply", lambda self, target, args=None: (
        None if target == "train" else apply(self, target, args)))
    line = run_tiny("codestral22b.train")
    assert line["correct"] is False
    assert line["compared"]["change_norm_gap"]["value"] == \
        pytest.approx(1.0, abs=0.01)
    assert line["compared"]["grad_norm_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    call = Model.call

    def half(self, target, args=None):
        t = args["tokens"].shape[1] // 2
        return call(self, target, {"tokens": args["tokens"][:, :t],
                                   "labels": args["labels"][:, :t]})

    monkeypatch.setattr(Model, "call", half)
    line = run_tiny("codestral22b.train")
    assert line["correct"] is False


@pytest.mark.gpu
@pytest.mark.parametrize("cell,seconds", [("codestral22b.train", 1),
                                          ("mistral7b.chat", 10)])
def test_control_fails_and_program_passes_on_the_card(cell, seconds):
    """On the card, at the cell's own sizes and load (a short window):
    the program's numbers within their limits, the control's (the
    reference in TF32) beyond one of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import contextlib
    import io

    from portbench import control
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        control.main(["--workload", cell, "--seeds", "7",
                      "--control-seeds", "7", "--seconds", str(seconds)])
    row = json.loads(buf.getvalue().splitlines()[0])
    limits = json.load(open(f"portbench/workloads/{cell}.json"))["limits"]
    assert row["correct"]
    assert any(v > limits[k] for k, v in row["control"].items()
               if k in limits)
