"""The hybrid cell ``jamba2mini.chat``: its configuration against the
catalog's published sizes, ``serve_hybrid`` end to end at a CPU size (and
``correct`` false when a served token is altered or bucket padding
reaches a Mamba state), and the two readers it adds."""

import copy
import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import flops_hybrid
from portbench import run as bench_run
from portbench.harness import Trace

ROOT = Path(__file__).resolve().parents[2]
CELL = "jamba2mini.chat"
# AI21-Jamba2-Mini's config.json as the model catalog reads it
PUBLISHED = {
    "attn_layer_offset": 4, "attn_layer_period": 8, "expert_layer_offset": 1,
    "expert_layer_period": 2, "hidden_act": "silu", "hidden_size": 4096,
    "intermediate_size": 14336, "mamba_conv_bias": True, "mamba_d_conv": 4,
    "mamba_d_state": 16, "mamba_dt_rank": 256, "mamba_expand": 2,
    "mamba_proj_bias": False, "max_position_embeddings": 262144,
    "model_type": "jamba", "num_attention_heads": 32, "num_experts": 16,
    "num_experts_per_tok": 2, "num_hidden_layers": 32,
    "num_key_value_heads": 8, "num_logits_to_keep": 1, "rms_norm_eps": 1e-06,
    "sliding_window": None, "tie_word_embeddings": False,
    "use_mamba_kernels": True, "vocab_size": 65536}


def tiny_cell():
    bench, _, wl, cfg = bench_run.load_cell(CELL)
    cfg, wl = copy.deepcopy(cfg), copy.deepcopy(wl)
    cfg.update(hidden_size=32, intermediate_size=48, num_attention_heads=4,
               num_key_value_heads=2, vocab_size=64, num_experts=4,
               mamba_dt_rank=4, max_position_embeddings=96,
               initializer_range=0.2)
    cfg["build"].update(vocab=64, dim=32, heads=4, kv_heads=2, hidden=48,
                        n_experts=4, dt_rank=4, max_seq=96)
    wl["traffic"].update(rate_per_s=8, prompt_min=4, prompt_max=40,
                         output_min=4, output_max=40)
    wl["batcher"].update(slots=4, capacity=96, pool_pages=12, page_size=8,
                         decode_chunk=4)
    wl["check"]["tokens"] = 60
    return bench, wl, cfg


def run_tiny(trace=False, seed=2 ** 31 + 12345):
    bench, wl, cfg = tiny_cell()
    metrics = bench_run.cell_metrics(bench, CELL, trace)
    return bench_run.run_cell(wl, cfg, metrics, seed, 2.0, trace, "cpu", 1,
                              [("start", time.perf_counter())])


def test_config_holds_the_published_sizes():
    bench, entry, wl, cfg = bench_run.load_cell(CELL)
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    assert conf["reduced"] == cfg["reduced"] == [
        "num_hidden_layers", "max_position_embeddings", "torch_dtype"]
    for key, value in PUBLISHED.items():
        if key in cfg["reduced"]:
            assert cfg["published"][key] == value
        else:
            assert cfg[key] == value, key
    # one whole period: 7 Mamba and 1 attention mixer, 4 MoE FFNs
    s = flops_hybrid.sizes(cfg)
    assert (s["mamba_layers"], s["attention_layers"], s["moe_layers"]) == \
        (7, 1, 4)
    assert flops_hybrid.param_count(s) == 13_295_302_624
    assert entry["chips"] == 1 and wl["driver"] == "serve_hybrid"
    b = cfg["build"]
    assert (b["dim"], b["hidden"], b["heads"], b["kv_heads"], b["d_state"],
            b["dt_rank"], b["n_experts"], b["k"]) == (
        4096, 14336, 32, 8, 16, 256, 16, 2)


def test_cell_runs_correct_at_a_cpu_size():
    line = run_tiny()
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"ttft_p95_ms", "tpot_p95_ms",
                                    "serve_tokens_per_s", "setup_s"}
    stats = line["notes"]["window_stats"]
    assert stats["scan_tokens"] > 0 and stats["moe_computed_rows"] > \
        stats["moe_routed_rows"] > 0
    assert line["notes"]["routing_margin_min"] > 0
    json.dumps(line)


def test_traced_run_reports_the_host_metrics():
    line = run_tiny(trace=True)
    assert line["correct"] is True
    # the CPU has no device trace: of the new metrics only the counter's
    assert {"serve.mfu", "serve.moe_unrouted_share"} <= set(line["metrics"])
    assert "serve.scan_roofline" not in line["metrics"]
    assert 0 < line["metrics"]["serve.moe_unrouted_share"]["value"] < 100


def test_served_token_altered_is_not_correct(monkeypatch):
    from exprgrad_torch.models import ContinuousBatcher
    emit = ContinuousBatcher._emit

    def altered(self, slot, token):
        return emit(self, slot, (int(token) + 1) % self.server.vocab)

    monkeypatch.setattr(ContinuousBatcher, "_emit", altered)
    line = run_tiny()
    assert line["correct"] is False


def test_padding_reaching_the_state_is_not_correct(monkeypatch):
    """Prefill that scans a prompt's bucket padding into the state."""
    from exprgrad_torch.ops import mamba
    scan = mamba.selective_scan

    def padded(x, dt, z, B, C, a_log, d, dt_bias, state, lengths):
        full = torch.full_like(torch.as_tensor(lengths), x.shape[1])
        return scan(x, dt, z, B, C, a_log, d, dt_bias, state, full)

    monkeypatch.setattr(mamba, "selective_scan", padded)
    line = run_tiny()
    assert line["correct"] is False


def _slice(**counters):
    kernels = [("mamba_conv_kernel", 0.0, 1e-3), ("mamba_scan_kernel", 0.0,
                                                  2e-3)]
    return SimpleNamespace(trace=Trace(kernels=kernels, busy_s=3e-3,
                                       window_s=4e-3),
                           counters=counters, sizes={})


def test_scan_roofline_reads_the_kernels_against_their_bound():
    read = bench_run.reader("serve.scan_roofline")
    launch = {"mamba_conv_kernel": 100, "mamba_scan_kernel": 200}
    run = _slice(scan_ops=10, scan_bytes=3.35e9 - 300,
                 scan_launch_bytes=launch)
    # 3.35 GB at 3.35 TB/s is 1 ms against 3 ms of device time
    assert read(run) == pytest.approx(100 / 3)
    assert read(_slice()) is None
    assert read(SimpleNamespace(trace=None, counters={}, sizes={})) is None
    no_kernels = _slice(scan_ops=10, scan_bytes=1, scan_launch_bytes=launch)
    no_kernels.trace.kernels = []
    assert read(no_kernels) is None


def test_moe_unrouted_share_reads_the_counters():
    read = bench_run.reader("serve.moe_unrouted_share")
    assert read(_slice(moe_computed_rows=512, moe_routed_rows=64)) == 87.5
    assert read(_slice()) is None


def test_the_cell_is_declared_with_its_metrics():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in ("serve.scan_roofline", "serve.moe_unrouted_share"):
        assert per_layer[name]["workloads"] == [CELL]
        assert per_layer[name]["moves"] == "tpot_p95_ms"
    traced = {m["name"] for m in bench_run.cell_metrics(bench, CELL, True)}
    # every serving metric but B7's roofline, whose bound counts every
    # layer of the configuration as an attention layer
    assert traced == {"serve.mfu", "serve.device_idle", "serve.prefill_share",
                      "serve.queue_p95_ms", "serve.submit_lag_p95_ms",
                      "serve.first_token_hold_p95_ms", "serve.scan_roofline",
                      "serve.moe_unrouted_share"}
