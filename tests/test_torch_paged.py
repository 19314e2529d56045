"""Port parity: the paged KV pool and paged decode attention
(exprgrad_torch/ops/paged.py, ops/paged_attention.py) and the rest of
ops/decode.py (int8 caches, ``append_at``, position masking).

The same numpy inputs go through the JAX functions and the port's:

* ``_quantize`` codes and scales, ``append_at`` and every ``ops.paged``
  function are held bit-equal to the JAX package's on random pools;
* ``decode_attention`` with ``key_pos``/``q_pos`` within ``2e-5`` of the
  JAX version (float32 sums in another order);
* ``paged_decode_attention`` (its plain version, on the CPU) within
  ``atol=rtol=2e-5`` of the JAX Pallas kernel run in interpret mode, on
  the seven cases of tests/test_paged_attention.py, over the query rows
  that see a live key (a row that sees none gives 0 on the port, as the
  flash kernels' rule; the JAX kernel gives the mean of the visited V).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from exprgrad_tpu.ops import decode as jax_decode
from exprgrad_tpu.ops import paged as jax_paged
from exprgrad_tpu.ops.paged_attention import (
    paged_decode_attention as jax_paged_attention)
from exprgrad_torch.ops import decode, paged, paged_attention

TOL = dict(atol=2e-5, rtol=2e-5)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def _np(x):
    """A JAX or torch array as numpy (bfloat16 through float32)."""
    if isinstance(x, torch.Tensor):
        x = x.float() if x.dtype == torch.bfloat16 else x
        return x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _t(x, dtype=None):
    """numpy -> torch, bfloat16 through float32."""
    t = torch.as_tensor(np.array(x, np.float32) if dtype == torch.bfloat16
                        else np.array(x))
    return t if dtype is None else t.to(dtype)


def _equal(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(_np(g), _np(w))


def _pools(rng, n_pages, hkv, page, d, dtype):
    """The same random pool for both packages (garbage everywhere, as in
    recycled pages)."""
    jd, td = DTYPES[dtype]
    jp = jax_paged.init_pool(n_pages, hkv, page, d, dtype=jd)
    if dtype == "int8":
        k = rng.integers(-127, 128, jp.k.shape).astype(np.int8)
        v = rng.integers(-127, 128, jp.v.shape).astype(np.int8)
    else:
        k = rng.normal(size=jp.k.shape).astype(np.float32)
        v = rng.normal(size=jp.v.shape).astype(np.float32)
    jp = jp._replace(k=jnp.asarray(k, jd), v=jnp.asarray(v, jd))
    tp = paged.PagedKVPool(k=_t(_np(jp.k), td), v=_t(_np(jp.v), td))
    if dtype == "int8":
        ks = rng.uniform(0.5, 1.5, jp.k_scale.shape).astype(np.float32)
        vs = rng.uniform(0.5, 1.5, jp.v_scale.shape).astype(np.float32)
        jp = jp._replace(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tp = tp._replace(k_scale=torch.as_tensor(ks),
                         v_scale=torch.as_tensor(vs))
    return jp, tp


# -- ops/decode.py ----------------------------------------------------------

def test_quantize_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 2, 5, 16)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0                                   # an all-zero slot
    # values that land exactly half-way between two codes (round to even)
    x[1, 1, 2] = np.linspace(-127, 127, 16) / 2 + 0.5
    x[1, 1, 2, 0] = 127.0
    codes, scale = decode._quantize(torch.as_tensor(x))
    want_codes, want_scale = jax_decode._quantize(jnp.asarray(x))
    assert codes.dtype == torch.int8
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want_scale))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_append_and_append_at_match_jax(dtype):
    """Per-row cursors, the batch-wide cursor, and int8 quantization on
    write, against the JAX package's functional caches."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(1)
    b, hkv, cap, d, t = 3, 2, 16, 8, 2
    k_new = rng.normal(size=(b, hkv, t, d)).astype(np.float32)
    v_new = rng.normal(size=(b, hkv, t, d)).astype(np.float32)
    starts = np.asarray([0, 5, 15], np.int32)  # the last one is clamped
    want = jax_decode.append_at(jax_decode.init_cache(b, hkv, cap, d, jd),
                                jnp.asarray(k_new), jnp.asarray(v_new),
                                jnp.asarray(starts))
    got = decode.append_at(decode.init_cache(b, hkv, cap, d, td),
                           torch.as_tensor(k_new), torch.as_tensor(v_new),
                           torch.as_tensor(starts))
    _equal(got[:2] + got[3:], want[:2] + want[3:])
    want = jax_decode.append(want, jnp.asarray(k_new), jnp.asarray(v_new))
    got = decode.append(got, torch.as_tensor(k_new), torch.as_tensor(v_new))
    assert got.length == int(want.length) == 2
    _equal(got[:2] + got[3:], want[:2] + want[3:])


@pytest.mark.parametrize("dtype,window,group,t", [
    ("float32", None, 1, 1), ("float32", 5, 2, 3), ("bfloat16", None, 4, 2),
    ("int8", 6, 2, 1)])
def test_decode_attention_positions_match_jax(dtype, window, group, t):
    """Position masking over the whole capacity (ragged rows, dead slots
    marked -1), GQA, windows and int8 dequantization."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(2)
    b, hkv, cap, d = 3, 2, 24, 16
    lens = np.asarray([7, 24, 3])
    jc = jax_decode.init_cache(b, hkv, cap, d, jd)
    kv = [rng.normal(size=(b, hkv, cap, d)).astype(np.float32)
          for _ in range(2)]
    jc = jax_decode.append(jc, jnp.asarray(kv[0]), jnp.asarray(kv[1]))
    tc = decode.append(decode.init_cache(b, hkv, cap, d, td),
                       torch.as_tensor(kv[0]), torch.as_tensor(kv[1]))
    key_pos = np.where(np.arange(cap)[None] < lens[:, None],
                       np.arange(cap)[None], -1).astype(np.int32)
    key_pos[0, 2] = -1                                  # a dead slot
    q_pos = (lens[:, None] - t + np.arange(t)[None]).astype(np.int32)
    q = rng.normal(size=(b, hkv * group, t, d)).astype(np.float32)
    want = jax_decode.decode_attention(
        jnp.asarray(q), jc, window=window, key_pos=jnp.asarray(key_pos),
        q_pos=jnp.asarray(q_pos))
    got = decode.decode_attention(
        torch.as_tensor(q), tc._replace(length=0), window=window,
        key_pos=torch.as_tensor(key_pos), q_pos=torch.as_tensor(q_pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="together"):
        decode.decode_attention(torch.as_tensor(q), tc,
                                key_pos=torch.as_tensor(key_pos))


# -- ops/paged.py -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_paged_functions_match_jax_bit_for_bit(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(3)
    n_pages, hkv, page, d = 9, 2, 4, 8
    jp, tp = _pools(rng, n_pages, hkv, page, d, dtype)
    _equal(paged.init_pool(n_pages, hkv, page, d, dtype=td),
           jax_paged.init_pool(n_pages, hkv, page, d, dtype=jd))

    # write_token: one token per row ([b] ids), then t = 2 per row
    k1 = rng.normal(size=(3, hkv, 1, d)).astype(np.float32)
    v1 = rng.normal(size=(3, hkv, 1, d)).astype(np.float32)
    pid, off = np.asarray([2, 5, 7], np.int32), np.asarray([0, 3, 1],
                                                           np.int32)
    jp = jax_paged.write_token(jp, jnp.asarray(k1), jnp.asarray(v1),
                               jnp.asarray(pid), jnp.asarray(off))
    tp = paged.write_token(tp, torch.as_tensor(k1), torch.as_tensor(v1),
                           pid, off)
    _equal(tp, jp)
    k2 = rng.normal(size=(2, hkv, 2, d)).astype(np.float32)
    v2 = rng.normal(size=(2, hkv, 2, d)).astype(np.float32)
    pid2 = np.asarray([[1, 1], [3, 4]], np.int32)
    off2 = np.asarray([[2, 3], [3, 0]], np.int32)
    jp = jax_paged.write_token(jp, jnp.asarray(k2), jnp.asarray(v2),
                               jnp.asarray(pid2), jnp.asarray(off2))
    tp = paged.write_token(tp, torch.as_tensor(k2), torch.as_tensor(v2),
                           torch.as_tensor(pid2), torch.as_tensor(off2))
    _equal(tp, jp)

    # dense batch-1 caches into pages: static and clamped offsets
    cap = 12
    jc = jax_decode.init_cache(1, hkv, cap, d, jd)
    kv = [rng.normal(size=(1, hkv, cap, d)).astype(np.float32)
          for _ in range(2)]
    jc = jax_decode.append(jc, jnp.asarray(kv[0]), jnp.asarray(kv[1]))
    tc = decode.append(decode.init_cache(1, hkv, cap, d, td),
                       torch.as_tensor(kv[0]), torch.as_tensor(kv[1]))
    ids = np.asarray([6, 8], np.int32)
    jp = jax_paged.write_prefill(jp, jc, jnp.asarray(ids), src_offset=4)
    tp = paged.write_prefill(tp, tc, ids, src_offset=4)
    _equal(tp, jp)
    jp = jax_paged.write_prefill_at(jp, jc, jnp.asarray(ids[::-1].copy()),
                                    jnp.int32(8))   # past the end: clamped
    tp = paged.write_prefill_at(tp, tc, ids[::-1].copy(), 8)
    _equal(tp, jp)

    # reads: batch-1 rows of some pages, and the per-row dense view
    rows = np.asarray([3, 0, 8], np.int32)
    _equal(paged.gather_rows(tp, rows),
           jax_paged.gather_rows(jp, jnp.asarray(rows)))
    table = np.asarray([[1, 2, 0], [8, 8, 5]], np.int32)
    got = paged.gather_view(tp, torch.as_tensor(table))
    want = jax_paged.gather_view(jp, jnp.asarray(table))
    assert got.length == 0
    _equal(got[:2] + got[3:], want[:2] + want[3:])
    assert tp.page_size == page and tp.n_pages == n_pages


def test_dense_and_paged_prefill_agree():
    """An int8 prefill quantizes identically into a dense cache and into
    pages, so the paged view of the pages equals the dense cache."""
    rng = np.random.default_rng(4)
    hkv, d, page = 2, 8, 4
    k = torch.as_tensor(rng.normal(size=(1, hkv, 12, d)).astype(np.float32))
    cache = decode.append(decode.init_cache(1, hkv, 12, d, torch.int8), k, k)
    pool = paged.write_prefill(paged.init_pool(5, hkv, page, d, torch.int8),
                               cache, [4, 1, 3])
    view = paged.gather_view(pool, torch.as_tensor([[4, 1, 3]]))
    _equal(view[:2] + view[3:], cache[:2] + cache[3:])


# -- ops/paged_attention.py -------------------------------------------------

def _random_case(rng, b, hkv, t, d, P, page, n_pages, dtype):
    """tests/test_paged_attention.py's case: random pools, tables with -1
    for unallocated pages, dead slots past each row's length."""
    jp, tp = _pools(rng, n_pages, hkv, page, d, dtype)
    lens = rng.integers(t, P * page, size=b)
    table = np.full((b, P), -1, np.int32)
    used = set()
    for i in range(b):
        for p in range(int(np.ceil(lens[i] / page))):
            while True:
                pid = int(rng.integers(0, n_pages))
                if pid not in used:
                    used.add(pid)
                    break
            table[i, p] = pid
    key_pos = np.full((b, P * page), -1, np.int32)
    for i in range(b):
        key_pos[i, :lens[i]] = np.arange(lens[i])
    q_pos = ((lens - 1)[:, None] - np.arange(t)[::-1][None, :]).astype(
        np.int32)
    return jp, tp, table, key_pos, q_pos


SEVEN = [
    (2, 4, 4, 1, 128, 4, 64, "float32", None),   # plain MHA decode
    (2, 4, 2, 1, 128, 4, 64, "float32", None),   # GQA
    (2, 8, 1, 1, 64, 3, 32, "float32", None),    # MQA, small d
    (2, 4, 2, 3, 64, 4, 64, "float32", None),    # t > 1
    (2, 4, 4, 1, 128, 4, 64, "float32", 40),     # sliding window
    (1, 4, 2, 2, 128, 3, 128, "int8", None),     # int8 pool + scales
    (2, 2, 2, 2, 32, 4, 16, "bfloat16", 24),     # bf16 pages, window
]


@pytest.mark.parametrize("b,h,hkv,t,d,P,page,dtype,window", SEVEN,
                         ids=["mha", "gqa", "mqa", "t3", "window", "int8",
                              "bf16_window"])
def test_paged_attention_matches_jax_kernel(b, h, hkv, t, d, P, page, dtype,
                                            window):
    rng = np.random.default_rng(hash((b, h, t, d, P, page)) % 2**31)
    jp, tp, table, key_pos, q_pos = _random_case(
        rng, b, hkv, t, d, P, page, 4 * P, dtype)
    q = rng.normal(size=(b, h, t, d)).astype(np.float32)
    want = np.asarray(jax_paged_attention(
        jnp.asarray(q), jp, jnp.asarray(table), jnp.asarray(key_pos),
        jnp.asarray(q_pos), window=window), np.float32)
    before = paged_attention.launches
    got = paged_attention.paged_decode_attention(
        torch.as_tensor(q), tp, torch.as_tensor(table),
        torch.as_tensor(key_pos), torch.as_tensor(q_pos), window=window)
    assert paged_attention.launches == before  # the CPU runs the plain one
    assert got.shape == q.shape and got.dtype == torch.float32
    live = paged_attention._live_rows(torch.as_tensor(key_pos),
                                      torch.as_tensor(q_pos), window).numpy()
    assert live.any()
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1, 3)[live],
                               want.transpose(0, 2, 1, 3)[live], **TOL)


def test_dead_rows_give_zero_and_bfloat16_queries():
    rng = np.random.default_rng(5)
    _, tp, table, key_pos, q_pos = _random_case(rng, 2, 2, 2, 16, 3, 8, 8,
                                                "bfloat16")
    key_pos[1] = -1                                   # row 1 sees nothing
    q = torch.as_tensor(rng.normal(size=(2, 4, 2, 16)).astype(np.float32))
    out = paged_attention.paged_decode_attention(
        q.to(torch.bfloat16), tp, torch.as_tensor(table),
        torch.as_tensor(key_pos), torch.as_tensor(q_pos))
    assert out.dtype == torch.bfloat16
    assert torch.all(out[1] == 0) and torch.any(out[0] != 0)
    ref = paged_attention.paged_decode_attention(
        q, tp, torch.as_tensor(table), torch.as_tensor(key_pos),
        torch.as_tensor(q_pos))
    torch.testing.assert_close(out.float(), ref, rtol=2e-2, atol=2e-2)


def test_validation_errors_match_jax():
    pool = paged.init_pool(4, 2, 8, 64, torch.float32)
    q = torch.zeros((1, 2, 1, 64))
    tbl = torch.zeros((1, 2), dtype=torch.int32)
    kp = torch.zeros((1, 16), dtype=torch.int32)
    qp = torch.zeros((1, 1), dtype=torch.int32)
    f = paged_attention.paged_decode_attention
    with pytest.raises(ValueError, match="key_pos"):
        f(q, pool, tbl, kp[:, :8], qp)
    with pytest.raises(ValueError, match="q_pos"):
        f(q, pool, tbl, kp, torch.zeros((1, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="not a multiple"):
        f(torch.zeros((1, 3, 1, 64)), pool, tbl, kp, qp)
    with pytest.raises(ValueError, match="head_dim"):
        f(torch.zeros((1, 2, 1, 32)), pool, tbl, kp, qp)
    with pytest.raises(ValueError, match="batch"):
        f(torch.zeros((2, 2, 1, 64)), pool, tbl, kp, qp)
    # a page of 12 slots (not a multiple of 8, which the TPU kernel
    # refuses) is taken
    pool12 = paged.init_pool(4, 2, 12, 64, torch.float32)
    out = f(q, pool12, tbl, torch.zeros((1, 24), dtype=torch.int32), qp)
    assert out.shape == q.shape
    # no kernel for a device that is neither the CPU nor CUDA
    meta = paged.PagedKVPool(k=pool.k.to("meta"), v=pool.v.to("meta"))
    with pytest.raises(ValueError, match="no paged-attention kernel"):
        f(q.to("meta"), meta, tbl.to("meta"), kp.to("meta"), qp.to("meta"))


# -- B7's split plan and its split-then-merge --------------------------------

@pytest.mark.parametrize("P,page,blocks,sms", [
    (16, 128, 64, 132), (8, 32, 32, 132), (1, 64, 64, 132),
    (64, 128, 8, 132), (5, 256, 1, 132), (7, 128, 300, 132),
    (128, 16, 16, 132), (3, 128, 2, 8), (0, 128, 4, 132), (9, 1, 4, 132),
    (100, 12, 8, 132)])
def test_split_plan_covers_the_table_once(P, page, blocks, sms):
    """Contiguous splits that cover every table entry exactly once, none
    empty; each of at least one page and 256 slots (two 32-slot chunks for
    each of a block's four warps) where the table holds them; and enough
    splits for two blocks per SM where those rules leave the entries."""
    n_split, per = paged_attention.split_plan(P, page, blocks, sms)
    width = max(P, 1)
    ranges = [(z * per, min(width, (z + 1) * per)) for z in range(n_split)]
    covered = [e for lo, hi in ranges for e in range(lo, hi)]
    assert covered == list(range(width))
    assert all(hi > lo for lo, hi in ranges) and per >= 1
    assert per * page >= 256 or per == width
    if width // -(-256 // page) >= -(-2 * sms // blocks):
        assert n_split * blocks >= 2 * sms


def test_split_plan_at_the_paths_shapes():
    """bench.py's paged shape (64 blocks, 16 entries of 128 slots) runs 6
    splits of 3 pages (the last of 1); path (e)'s decode step (32 blocks,
    8 entries of 32 slots, 256 in all) one split."""
    assert paged_attention.split_plan(16, 128, 64, 132) == (6, 3)
    assert paged_attention.split_plan(8, 32, 32, 132) == (1, 8)
    assert [paged_attention.rows_per_block(r) for r in (1, 2, 3, 5, 8, 12)] \
        == [1, 4, 4, 8, 8, 8]


def _split_merge(q, pool, table, key_pos, q_pos, window, n_split, per):
    """B7's arithmetic in plain PyTorch: each split's partial softmax
    (m, l, acc) over its table entries, then the merge in split order that
    skips splits with m = -inf; a row no split sees gives 0."""
    b, h, t, d = q.shape
    _, hkv, page, _ = pool.k.shape
    group = h // hkv
    view = paged.gather_view(pool, table.clamp(min=0))
    k = view.k.float()
    v = view.v.float()
    if view.k_scale is not None:
        k = k * view.k_scale[..., None]
        v = v * view.v_scale[..., None]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    allocated = (table >= 0).repeat_interleave(page, dim=1)
    kp = key_pos.long()[:, None, :]
    qp = q_pos.long()[:, :, None]
    keep = (kp >= 0) & (kp <= qp) & allocated[:, None, :]
    if window is not None:
        keep = keep & (kp > qp - window)
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k) / d ** 0.5
    s = s.masked_fill(~keep[:, None], -torch.inf)
    parts = []
    for z in range(n_split):
        lo, hi = z * per * page, (z + 1) * per * page
        sz = s[..., lo:hi]
        m = sz.amax(-1, keepdim=True)
        p = torch.where(torch.isneginf(m), torch.zeros_like(sz),
                        torch.exp(sz - m))
        parts.append((m, p.sum(-1, keepdim=True), p @ v[:, :, lo:hi]))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l, acc in parts:
        f = torch.where(torch.isneginf(m), torch.zeros_like(m),
                        torch.exp(m - mx))
        num, den = num + f * acc, den + f * l
    out = torch.where(den > 0, num / den.clamp(min=1e-30),
                      torch.zeros_like(num))
    return out.to(q.dtype)


@pytest.mark.parametrize("b,h,hkv,t,d,P,page,dtype,window", SEVEN,
                         ids=["mha", "gqa", "mqa", "t3", "window", "int8",
                              "bf16_window"])
@pytest.mark.parametrize("splits", ["plan", "one", "every page"])
def test_split_then_merge_matches_jax_kernel(b, h, hkv, t, d, P, page, dtype,
                                             window, splits):
    """The split-then-merge at the plan's split, at one split and at one
    split per page, within TOL of the JAX Pallas kernel (interpret mode)
    on the rows that see a key; rows that see none give 0."""
    rng = np.random.default_rng(hash((b, h, t, d, P, page)) % 2**31)
    jp, tp, table, key_pos, q_pos = _random_case(
        rng, b, hkv, t, d, P, page, 4 * P, dtype)
    q = rng.normal(size=(b, h, t, d)).astype(np.float32)
    key_pos[-1, :] = -1 if b > 1 else key_pos[-1, :]  # a row with no key
    want = np.asarray(jax_paged_attention(
        jnp.asarray(q), jp, jnp.asarray(table), jnp.asarray(key_pos),
        jnp.asarray(q_pos), window=window), np.float32)
    rows = (h // hkv) * t
    blocks = b * hkv * -(-rows // paged_attention.rows_per_block(rows))
    n_split, per = {"plan": paged_attention.split_plan(P, page, blocks,
                                                       132),
                    "one": (1, P), "every page": (P, 1)}[splits]
    got = _split_merge(torch.as_tensor(q), tp, torch.as_tensor(table),
                       torch.as_tensor(key_pos), torch.as_tensor(q_pos),
                       window, n_split, per)
    live = paged_attention._live_rows(torch.as_tensor(key_pos),
                                      torch.as_tensor(q_pos), window).numpy()
    assert live.any()
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1, 3)[live],
                               want.transpose(0, 2, 1, 3)[live], **TOL)
    assert torch.all(got.transpose(1, 2)[torch.as_tensor(~live)] == 0)
    plain = paged_attention.paged_decode_attention(
        torch.as_tensor(q), tp, torch.as_tensor(table),
        torch.as_tensor(key_pos), torch.as_tensor(q_pos), window=window)
    torch.testing.assert_close(got, plain, **TOL)
