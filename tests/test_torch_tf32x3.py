"""Split TF32, the float32 arithmetic of kernels B1-B4, on the CPU.

``chip_smoke.py`` holds B1 (``csrc/matmul.cu``), B2
(``csrc/flash_fwd.cu``) and B3/B4 (``csrc/flash_bwd.cu``) against their
plain versions at the float32 tolerances the FP32-FMA kernels before them
met: ``matmul_f32_tol(k)`` (``atol = 1e-5 * sqrt(k)``),
``F32_OUT``/``F32_LSE_ATOL`` and ``F32_GRAD``.  All now run float32
products on the tensor cores as split TF32.  This is the written
argument that those tolerances still hold, with the arithmetic emulated
bit for bit in ``exprgrad_torch/ops/tf32.py``, on inputs made from a seed
with numpy (standard normal, as chip_smoke's):

* split TF32 rounded to nearest stays inside them, at k = 4096, at the
  serving attention shape [8, 4, 256, 128] causal, and for the backward
  (dq, dk, dv, each product summed per warp's slice of a tile in the
  kernels' order) there and at GQA h4/hkv1 (dk/dv over 1024 query rows);
* one TF32 pass does not, and neither does the mismatched split (the raw
  float32 fed as ``big``, which the tensor core truncates, beside
  ``small = x - rna(x)``);
* the split that truncates both parts consistently is reported, not held.

The emulation sums in float32 on the CPU (in another order than the
tensor cores, which also truncate each MMA's sum; the kernels bound that
by summing each k slice or kv tile in a fresh accumulator).
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import F32_GRAD, F32_LSE_ATOL, F32_OUT, matmul_f32_tol
from exprgrad_torch.ops.attention import (attention_backward_plain,
                                          attention_forward_plain)
from exprgrad_torch.ops.tf32 import (attention_backward, split, tf32_matmul,
                                     tf32_round, tf32x3_matmul)

MATMUL = (256, 4096, 256)  # m, k, n
ATTENTION = (8, 4, 256, 128)  # b, h, s, d; causal
# the backward's shapes, causal: (b, h, hkv, s, d), as chip_smoke's cases
BACKWARD = {"serving": (8, 4, 4, 256, 128), "gqa h4/hkv1": (2, 4, 1, 256, 128)}


def _normal(seed, *shape):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape, dtype=np.float32))


def _within(got, want, rtol, atol) -> bool:
    return bool(torch.all((got.double() - want.double()).abs()
                          <= atol + rtol * want.double().abs()))


def _matmul_case():
    m, k, n = MATMUL
    a, b = _normal(0, m, k), _normal(1, k, n)
    return a, b, a.double() @ b.double()


def _attention(q, k, v, mm):
    """Causal attention whose two products run through ``mm``; the
    softmax in float32, as in the kernel."""
    s = mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    n = s.shape[-1]
    keep = torch.ones(n, n, dtype=torch.bool).tril()
    s = s.masked_fill(~keep, -1e30)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = mm(p, v) / l
    return out, (m + torch.log(l))[..., 0]


@pytest.fixture(scope="module")
def attention_case():
    q, k, v = (_normal(seed, *ATTENTION) for seed in (2, 3, 4))
    ref_out, ref_lse = attention_forward_plain(q.double(), k.double(),
                                               v.double(), causal=True)
    return (q, k, v), (ref_out, ref_lse.reshape(ATTENTION[:3]))


def _attention_ok(got, want) -> bool:
    (out, lse), (ref_out, ref_lse) = got, want
    return (_within(out, ref_out, **F32_OUT)
            and _within(lse, ref_lse, 0.0, F32_LSE_ATOL))


def _errors(got, want) -> str:
    (out, lse), (ref_out, ref_lse) = got, want
    return (f"max |out err| {(out.double() - ref_out).abs().max():.3e}, "
            f"max |lse err| {(lse.double() - ref_lse).abs().max():.3e}")


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      -(1.0 + 2**-11), 1.0 + 2**-11 - 2**-23,
                      float("inf"), -float("inf")])
    want_rna = [1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0 + 2**-9,
                -(1.0 + 2**-10), 1.0, float("inf"), -float("inf")]
    want_rz = [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-10, -1.0, 1.0,
               float("inf"), -float("inf")]
    assert tf32_round(x, "rna").tolist() == want_rna  # ties away from 0
    assert tf32_round(x, "rz").tolist() == want_rz
    assert torch.isnan(tf32_round(torch.tensor([float("nan")]))).all()
    low = tf32_round(_normal(5, 1000)).view(torch.int32) & ((1 << 13) - 1)
    assert torch.all(low == 0)


@pytest.mark.parametrize("how", ["rna", "rz"])
def test_split_parts_are_tf32_and_sum_close(how):
    x = _normal(6, 10000)
    big, small = split(x, how)
    for part in (big, small):
        assert torch.equal(tf32_round(part, "rz"), part)  # 13 low bits 0
    rel = ((big.double() + small.double() - x.double()).abs()
           / x.double().abs()).max().item()
    assert rel <= 2.0**-21, rel


def test_split_tf32_matmul_meets_the_chip_tolerance():
    a, b, want = _matmul_case()
    got = tf32x3_matmul(a, b)
    tol = matmul_f32_tol(MATMUL[1])
    err = (got.double() - want).abs().max().item()
    print(f"split TF32 (rna) at k={MATMUL[1]}: max |err| {err:.3e}, "
          f"atol {tol['atol']:.3e}")
    assert _within(got, want, **tol)


def test_split_tf32_attention_meets_the_chip_tolerance(attention_case):
    (q, k, v), want = attention_case
    got = _attention(q, k, v, tf32x3_matmul)
    print(f"split TF32 (rna) attention {ATTENTION}: {_errors(got, want)}")
    assert _attention_ok(got, want)


@pytest.mark.parametrize("name", ["one TF32 pass", "mismatched split"])
def test_other_routes_miss_the_chip_tolerance(name, attention_case):
    mm = (tf32_matmul if name == "one TF32 pass"
          else lambda x, y: tf32x3_matmul(x, y, "mismatched"))
    a, b, want = _matmul_case()
    got = mm(a, b)
    err = (got.double() - want).abs().max().item()
    print(f"{name} at k={MATMUL[1]}: max |err| {err:.3e}")
    assert not _within(got, want, **matmul_f32_tol(MATMUL[1]))
    (q, k, v), att_want = attention_case
    att = _attention(q, k, v, mm)
    print(f"{name} attention {ATTENTION}: {_errors(att, att_want)}")
    assert not _attention_ok(att, att_want)


def test_consistent_truncation_is_reported(attention_case):
    """Both parts cut toward zero: reported, not held to a tolerance."""
    a, b, want = _matmul_case()
    rz = lambda x, y: tf32x3_matmul(x, y, "rz")  # noqa: E731
    err = (rz(a, b).double() - want).abs().max().item()
    (q, k, v), att_want = attention_case
    att = _attention(q, k, v, rz)
    print(f"consistent truncation at k={MATMUL[1]}: max |err| {err:.3e}; "
          f"attention {ATTENTION}: {_errors(att, att_want)}")
    assert math.isfinite(err)


@pytest.fixture(scope="module", params=list(BACKWARD))
def backward_case(request):
    """Inputs of the backward at one shape, with the forward's (out, lse)
    and the plain backward in float64 as the reference."""
    b, h, hkv, s, d = BACKWARD[request.param]
    q = _normal(7, b, h, s, d)
    k, v = (_normal(seed, b, hkv, s, d) for seed in (8, 9))
    g = _normal(10, b, h, s, d)
    out, lse = attention_forward_plain(q.double(), k.double(), v.double(),
                                       causal=True)
    want = attention_backward_plain(q.double(), k.double(), v.double(),
                                    out, lse, g.double(), causal=True)
    return request.param, (q, k, v, out.float(), lse, g), want


def _grad_errors(got, want) -> str:
    return ", ".join(f"max |{part} err| {(a.double() - w).abs().max():.3e}"
                     for part, a, w in zip(("dq", "dk", "dv"), got, want))


def test_split_tf32_backward_meets_the_chip_tolerance(backward_case):
    name, args, want = backward_case
    got = attention_backward(*args, how="rna")
    print(f"split TF32 (rna) backward {name}: {_grad_errors(got, want)}")
    for part, a, w in zip(("dq", "dk", "dv"), got, want):
        assert _within(a, w, **F32_GRAD), part


def test_one_tf32_pass_backward_misses_the_chip_tolerance(backward_case):
    name, args, want = backward_case
    got = attention_backward(*args, how="single")
    print(f"one TF32 pass backward {name}: {_grad_errors(got, want)}")
    for part, a, w in zip(("dq", "dk", "dv"), got, want):
        assert not _within(a, w, **F32_GRAD), part
