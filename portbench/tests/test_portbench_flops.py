"""``flops.py`` against counts made by hand from the published sizes."""

import json
from pathlib import Path

import pytest

from portbench import flops

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def sizes(name):
    return flops.sizes(json.loads((CONFIGS / f"{name}.json").read_text()))


def test_mistral_7b_counts():
    s = sizes("mistral-7b-v0.1")
    # HF's 7,241,732,096 parameters plus the port's 32,000-wide head bias
    assert flops.param_count(s) == 7_241_732_096 + 32_000
    # per block: q and o 4096^2, k and v 4096 x 1024, SwiGLU 3 x 4096 x 14336
    assert flops.layer_matmul_params(s) == (2 * 4096 * 4096 + 2 * 4096 * 1024
                                            + 3 * 4096 * 14336)
    # K and V of 8 heads of 128 in bfloat16 over 32 layers: 128 KiB a token
    assert flops.kv_bytes_per_token(s) == 128 * 1024
    assert flops.param_count(s) * 4 == pytest.approx(28.97e9, rel=1e-3)


def test_codestral_22b_counts_at_three_layers():
    s = sizes("codestral-22b-v0.1")
    assert s["layers"] == 3
    assert flops.layer_matmul_params(s) == 390_070_272
    assert flops.param_count(s) == 3 * 390_070_272 + 2 * 32768 * 6144 \
        + 7 * 6144 + 32768
    assert flops.param_count(s) == pytest.approx(1.573e9, rel=1e-3)
    # 6 x 1.372 B matmul parameters x 4096 tokens, plus 3 x the attention
    # forward (4 x 48 heads x 128 x 4096 x 4097 / 2 pairs x 3 layers)
    attn = 4 * 48 * 128 * (4096 * 4097 // 2) * 3
    assert flops.train_flops(s, 1, 4096) == 6 * (
        3 * 390_070_272 + 6144 * 32768) * 4096 + 3 * attn


def test_codestral_22b_counts_at_other_depths():
    s = sizes("codestral-22b-v0.1")
    # the issue's 4 layers, and the published 56
    assert flops.param_count({**s, "layers": 4}) == pytest.approx(
        1.963e9, rel=1e-3)
    assert flops.param_count({**s, "layers": 56}) == pytest.approx(
        22.25e9, rel=1e-3)


def test_causal_pairs_and_windows():
    assert flops.causal_pairs(4) == 10
    assert flops.causal_pairs(6, window=2) == 3 + 4 * 2
    assert flops.causal_pairs(3, window=8) == 6


def test_b7_row_counts_kv_query_and_output():
    s = sizes("mistral-7b-v0.1")
    b, f = flops.b7_row(s, 100)
    assert b == 100 * 8 * 128 * 2 * 2 + 2 * 32 * 128 * 4 + 4 * 4
    assert f == 4 * 32 * 128 * 100
    # bound by bytes: 4 operations a byte against 67e12 / 3.35e12 = 20
    assert flops.b7_bound_s(s, [100]) == pytest.approx(
        32 * b / flops.HBM_BYTES_PER_S)


def test_flash_bound_is_compute_at_4096():
    s = sizes("codestral-22b-v0.1")
    _, f = flops.flash_cost(s, 1, 4096, "fwd")
    assert f == 4 * 128 * 48 * (4096 * 4097 // 2)
    assert flops.flash_bound_s(s, 1, 4096, "fwd") == pytest.approx(
        f / flops.SPLIT_TF32_FLOPS)
    assert flops.flash_cost(s, 1, 4096, "dkv")[1] == 2 * f
