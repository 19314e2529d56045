"""The benchmark's own arithmetic: parameters, model FLOPs, kernel bytes
and operations, and the H100's published peaks.

Everything here is computed from a configuration's sizes; nothing is
read from the program.  The roofline rules follow the kernel table of
``PERF.md`` (copied, not imported, from ``scripts/probe_torch_kernels.py``
and chip_smoke's bounds): a kernel's least time is the larger of the
bytes it must move (each input read once, each output written once) over
the HBM bandwidth and its operations over its arithmetic rate.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense rates (NVIDIA's data sheet), at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12
# float32-grade work on the tensor cores is split TF32: three TF32
# products for one float32 product (csrc/tf32x3.cuh), so 495 / 3 is the
# fastest float32-exact rate the card has, and the peak of every `mfu`.
SPLIT_TF32_FLOPS = TF32_FLOPS / 3
FP32_SIMT_FLOPS = 67e12
MFU_PEAK_FLOPS = SPLIT_TF32_FLOPS

F32 = 4


def sizes(cfg: dict) -> dict:
    """The sizes every formula below uses, from a configuration file."""
    dim = cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    return {
        "dim": dim,
        "hidden": cfg["intermediate_size"],
        "layers": cfg["num_hidden_layers"],
        "heads": heads,
        "kv_heads": cfg["num_key_value_heads"],
        "head_dim": cfg.get("head_dim") or dim // heads,
        "vocab": cfg["vocab_size"],
        "window": cfg.get("sliding_window"),
    }


def layer_matmul_params(s: dict) -> int:
    """Weights of one block that a token multiplies: q, k, v, o and the
    three SwiGLU matrices."""
    d, hd = s["dim"], s["head_dim"]
    attn = d * s["heads"] * hd * 2 + d * s["kv_heads"] * hd * 2
    return attn + 3 * d * s["hidden"]


def matmul_params(s: dict) -> int:
    """Weights a token multiplies: every block's and the LM head's (the
    embedding is a gather)."""
    return s["layers"] * layer_matmul_params(s) + s["dim"] * s["vocab"]


def param_count(s: dict) -> int:
    """Every parameter of the port's model: the matrices, the embedding,
    2 gains a block, the final gain and the head's bias."""
    gains = (2 * s["layers"] + 1) * s["dim"]
    return matmul_params(s) + s["vocab"] * s["dim"] + gains + s["vocab"]


def kv_bytes_per_token(s: dict, elt: int = 2) -> int:
    """Bytes of K and V one token holds in the cache over all layers."""
    return 2 * s["layers"] * s["kv_heads"] * s["head_dim"] * elt


def _keys(pos: int, window) -> int:
    """Keys a query at position ``pos`` attends (itself included)."""
    return pos + 1 if not window else min(pos + 1, window)


def causal_pairs(t: int, window=None) -> int:
    """(query, key) pairs a causal (optionally windowed) pass over ``t``
    tokens computes."""
    if not window or window >= t:
        return t * (t + 1) // 2
    return window * (window + 1) // 2 + (t - window) * window


def attn_flops_per_pair(s: dict) -> int:
    """Q.K and P.V: two multiply-adds a head dim a query head."""
    return 4 * s["heads"] * s["head_dim"]


def prefill_flops(s: dict, prompt: int) -> int:
    """Model FLOPs of a prompt's forward: the matmuls of every token and
    causal attention over the prompt, in every layer."""
    return (2 * matmul_params(s) * prompt + s["layers"]
            * attn_flops_per_pair(s) * causal_pairs(prompt, s["window"]))


def decode_flops(s: dict, context: int) -> int:
    """Model FLOPs of one generated token whose query attends ``context``
    cached positions (itself included)."""
    keys = min(context, s["window"]) if s["window"] else context
    return (2 * matmul_params(s)
            + s["layers"] * attn_flops_per_pair(s) * keys)


def train_flops(s: dict, batch: int, seq: int) -> int:
    """Model FLOPs of a train step: 6 x matmul parameters x tokens, plus
    the causal attention forward three times (forward, and its two
    backward products)."""
    attn = (s["layers"] * attn_flops_per_pair(s) * batch
            * causal_pairs(seq, s["window"]))
    return 6 * matmul_params(s) * batch * seq + 3 * attn


# --- kernel B7: paged decode attention (csrc/paged_attention.cu) ------

def b7_row(s: dict, context: int, kv_elt: int = 2) -> tuple[int, int]:
    """(bytes, operations) one decode row needs in one layer's B7 call:
    the K/V of its ``context`` live positions in the stored dtype, its
    float32 query and output, its page-table entries; Q.K and P.V."""
    keys = min(context, s["window"]) if s["window"] else context
    kv = 2 * keys * s["kv_heads"] * s["head_dim"] * kv_elt
    qo = 2 * s["heads"] * s["head_dim"] * F32
    table = -(-keys // 32) * 4
    return kv + qo + table, attn_flops_per_pair(s) * keys


def b7_bound_s(s: dict, contexts, kv_elt: int = 2) -> float:
    """Least seconds B7 needs for decode rows at ``contexts`` (one entry
    per row and step), summed over the layers: bytes over HBM bandwidth
    or operations over the float32 rate, whichever is larger, per
    launch-equivalent row set."""
    total_b = total_f = 0
    for c in contexts:
        b, f = b7_row(s, int(c), kv_elt)
        total_b += b
        total_f += f
    return s["layers"] * max(total_b / HBM_BYTES_PER_S,
                             total_f / FP32_SIMT_FLOPS)


# --- kernels B2-B4: flash attention forward and backward --------------

def flash_cost(s: dict, batch: int, seq: int, kind: str) -> tuple[int, int]:
    """(bytes, operations) of one launch of B2 (``"fwd"``), B3 (``"dq"``)
    or B4 (``"dkv"``) over a causal float32 ``[batch, heads, seq,
    head_dim]`` self-attention with ``kv_heads`` K/V heads."""
    h, hkv, d = s["heads"], s["kv_heads"], s["head_dim"]
    q = batch * h * seq * d * F32
    kv = batch * hkv * seq * d * F32
    row = batch * h * seq * F32  # lse or delta
    pairs = batch * h * causal_pairs(seq, s["window"])
    if kind == "fwd":   # reads q, k, v; writes out, lse
        return q + 2 * kv + q + row, 4 * d * pairs
    if kind == "dq":    # reads q, k, v, out, dout, lse; writes dq
        return 3 * q + 2 * kv + row + q, 6 * d * pairs
    if kind == "dkv":   # reads q, k, v, dout, lse, delta; writes dk, dv
        return 2 * q + 2 * kv + 2 * row + 2 * kv, 8 * d * pairs
    raise ValueError(f"unknown flash kernel {kind!r}")


def flash_bound_s(s: dict, batch: int, seq: int, kind: str) -> float:
    """Least seconds of one B2/B3/B4 launch: bytes over HBM bandwidth or
    operations over split TF32's rate (PERF.md's kernel table)."""
    b, f = flash_cost(s, batch, seq, kind)
    return max(b / HBM_BYTES_PER_S, f / SPLIT_TF32_FLOPS)
