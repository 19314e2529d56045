"""The benchmark's arithmetic for a hybrid Jamba configuration: parameters,
the FLOPs a token activates (its routed experts only, the scan and the
attention included), and the bytes and operations of the Mamba layers'
kernels.

Everything here is computed from the configuration's sizes; nothing is
read from the program.  The kernels' rule is ``flops.py``'s (the kernel
table of ``PERF.md``): a launch's least time is the larger of the bytes
it must move over 3.35 TB/s and its operations over the CUDA cores' 67
TFLOP/s.  Bytes count each input read once, each output written once and
each live row's state read and written once a launch.
"""

from __future__ import annotations

from .flops import (F32, FP32_SIMT_FLOPS, HBM_BYTES_PER_S,
                    attn_flops_per_pair, causal_pairs)

# the two kernels' names in a device trace (csrc/selective_scan.cu)
CONV_KERNEL = "mamba_conv_kernel"
SCAN_KERNEL = "mamba_scan_kernel"


def sizes(cfg: dict) -> dict:
    """The sizes every formula below uses, from a configuration file."""
    dim = cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    layers = cfg["num_hidden_layers"]
    mixers = ["attention" if i % cfg["attn_layer_period"]
              == cfg["attn_layer_offset"] else "mamba" for i in range(layers)]
    moe = sum(i % cfg["expert_layer_period"] == cfg["expert_layer_offset"]
              for i in range(layers))
    return {
        "dim": dim, "heads": heads, "kv_heads": cfg["num_key_value_heads"],
        "head_dim": dim // heads, "hidden": cfg["intermediate_size"],
        "vocab": cfg["vocab_size"], "layers": layers,
        "attention_layers": mixers.count("attention"),
        "mamba_layers": mixers.count("mamba"), "moe_layers": moe,
        "dense_layers": layers - moe, "experts": cfg["num_experts"],
        "top": cfg["num_experts_per_tok"],
        "d_inner": cfg["mamba_expand"] * dim, "d_state": cfg["mamba_d_state"],
        "d_conv": cfg["mamba_d_conv"], "dt_rank": cfg["mamba_dt_rank"],
        "window": cfg.get("sliding_window"),
    }


def mamba_params(s: dict) -> int:
    """One Mamba mixer: in_proj, the conv's weights and bias, x_proj, the
    three inner gains, dt_proj and its bias, a_log, D, out_proj."""
    d, di, n, r, k = (s["dim"], s["d_inner"], s["d_state"], s["dt_rank"],
                      s["d_conv"])
    return (2 * d * di + di * k + di + di * (r + 2 * n) + r + 2 * n
            + r * di + di + di * n + di + di * d)


def attention_params(s: dict) -> int:
    d, hd = s["dim"], s["head_dim"]
    return 2 * d * s["heads"] * hd + 2 * d * s["kv_heads"] * hd


def param_count(s: dict) -> int:
    """Every parameter of the port's model: the layers, their two gains
    each, the embedding, the final gain, the head and its bias."""
    dense = 3 * s["dim"] * s["hidden"]
    return (s["mamba_layers"] * mamba_params(s)
            + s["attention_layers"] * attention_params(s)
            + s["moe_layers"] * (s["dim"] * s["experts"]
                                 + s["experts"] * dense)
            + s["dense_layers"] * dense
            + 2 * s["layers"] * s["dim"] + 2 * s["vocab"] * s["dim"]
            + s["dim"] + s["vocab"])


def active_matmul_params(s: dict) -> int:
    """Weights a token multiplies: the Mamba layers' four projections, the
    attention's four, the dense FFNs, each MoE layer's router and its
    ``top`` experts, and the head (the embedding is a gather)."""
    d, di, n, r = s["dim"], s["d_inner"], s["d_state"], s["dt_rank"]
    swiglu = 3 * d * s["hidden"]
    return (s["mamba_layers"] * (2 * d * di + di * (r + 2 * n) + r * di
                                 + di * d)
            + s["attention_layers"] * attention_params(s)
            + s["dense_layers"] * swiglu
            + s["moe_layers"] * (d * s["experts"] + s["top"] * swiglu)
            + d * s["vocab"])


def conv_ops(s: dict) -> int:
    """Operations of the conv kernel a token and layer: the k-wide sum,
    the bias and silu."""
    return s["d_inner"] * (2 * s["d_conv"] + 4)


def scan_ops(s: dict) -> int:
    """Operations of the scan kernel a token and layer: a channel's
    softplus and gate (10), and 7 a state (exp(delta A), the decay, the
    input and the output's multiply-add)."""
    return s["d_inner"] * (7 * s["d_state"] + 10)


def prefill_flops(s: dict, prompt: int) -> int:
    """Model FLOPs of a prompt's forward: the active matmuls of every
    token, causal attention over the prompt, and the conv and scan of
    every Mamba layer."""
    return (2 * active_matmul_params(s) * prompt
            + s["attention_layers"] * attn_flops_per_pair(s)
            * causal_pairs(prompt)
            + s["mamba_layers"] * prompt * (conv_ops(s) + scan_ops(s)))


def decode_flops(s: dict, context: int) -> int:
    """Model FLOPs of one generated token whose query attends ``context``
    cached positions (itself included)."""
    return (2 * active_matmul_params(s)
            + s["attention_layers"] * attn_flops_per_pair(s) * context
            + s["mamba_layers"] * (conv_ops(s) + scan_ops(s)))


# --- the Mamba kernels (csrc/selective_scan.cu) --------------------------

def row_cost(s: dict, tokens: int, width: int) -> tuple[int, int]:
    """(operations, bytes) one row of ``tokens`` true positions padded to
    ``width`` adds to a conv and a scan launch of one layer: x, dt, z, B
    and C of its true positions read, the conv's and the scan's outputs
    over the width written, and, for a live row, both states read and
    written."""
    di, n, k = s["d_inner"], s["d_state"], s["d_conv"]
    live = tokens > 0
    conv = F32 * di * tokens + 2 * F32 * di * (k - 1) * live
    scan = (F32 * (3 * di + 2 * n) * tokens
            + 2 * F32 * di * n * live)
    out = 2 * F32 * di * width
    return tokens * (conv_ops(s) + scan_ops(s)), conv + scan + out


def launch_bytes(s: dict) -> dict:
    """Bytes each launch reads once whatever its rows: the conv's weights
    and bias; the scan's a_log, D and step bias; by kernel name."""
    di, n, k = s["d_inner"], s["d_state"], s["d_conv"]
    return {CONV_KERNEL: F32 * di * (k + 1),
            SCAN_KERNEL: F32 * di * (n + 2)}


def bound_s(ops: float, nbytes: float) -> float:
    """Least seconds of work of ``ops`` operations and ``nbytes`` bytes."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_SIMT_FLOPS)
