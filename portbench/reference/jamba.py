"""Plain PyTorch reference of Jamba's decoder (AI21-Jamba2-Mini's layers).

The equations of the Jamba paper (arXiv:2403.19887) and of HF's
``JambaForCausalLM``, from a configuration in HF's keys (``hidden_size``,
``intermediate_size``, ``num_hidden_layers``, ``num_attention_heads``,
``num_key_value_heads``, ``vocab_size``, ``rms_norm_eps``,
``num_experts``, ``num_experts_per_tok``, ``attn_layer_period``,
``attn_layer_offset``, ``expert_layer_period``, ``expert_layer_offset``,
``mamba_d_state``, ``mamba_d_conv``, ``mamba_expand``,
``mamba_dt_rank``):

* layer ``i``: ``h = x + mixer(rms(x)); out = h + ffn(rms(h))``; then a
  final RMSNorm and an untied head, which carries a bias (the port's
  dense head; a model without one holds it at 0);
* mixer: causal grouped-query attention without positions where ``i %
  attn_layer_period == attn_layer_offset``, else Mamba-1 with Jamba's
  inner RMSNorms on dt, B and C, its state and conv window starting at 0
  and scanned one position at a time;
* FFN: where ``i % expert_layer_period == expert_layer_offset`` a softmax
  router over the experts, the top ``num_experts_per_tok`` (ties to the
  lower index) weighted by their probabilities, not renormalized, each
  a bias-free SwiGLU at ``intermediate_size``; else one such SwiGLU.

No kernel, cache or batching of the program: dense ``torch`` operations
in the weights' dtype (float32 as the configurations state it), matrix
products with TF32 off (``precision``).  Only ``kv_dtype`` reproduces a
stated storage precision: a served model's keys and values are held in
bfloat16, so they are rounded to it before attention reads them.  The
weights are the program's parameters in its order (``layout``).  This
file imports nothing of the port; ``portbench/reference/jamba.py`` is a
copy of it, which a test holds equal.
"""

from __future__ import annotations

import contextlib
import math

import torch


@contextlib.contextmanager
def precision(tf32: bool = False):
    """Matmuls in float32 (TF32 off), or in TF32 for the control."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def kinds(cfg: dict) -> list:
    """``(mixer, ffn)`` of each layer: ``"attention"``/``"mamba"`` and
    ``"moe"``/``"dense"``."""
    return [("attention" if i % cfg["attn_layer_period"]
             == cfg["attn_layer_offset"] else "mamba",
             "moe" if i % cfg["expert_layer_period"]
             == cfg["expert_layer_offset"] else "dense")
            for i in range(cfg["num_hidden_layers"])]


def sizes(cfg: dict) -> dict:
    dim = cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    return {"dim": dim, "heads": heads, "kv_heads": cfg["num_key_value_heads"],
            "head_dim": dim // heads, "hidden": cfg["intermediate_size"],
            "vocab": cfg["vocab_size"], "experts": cfg["num_experts"],
            "top": cfg["num_experts_per_tok"],
            "d_inner": cfg["mamba_expand"] * dim,
            "d_state": cfg["mamba_d_state"], "d_conv": cfg["mamba_d_conv"],
            "dt_rank": cfg["mamba_dt_rank"]}


MAMBA = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_norm", "b_norm",
         "c_norm", "dt_proj", "dt_bias", "a_log", "d", "out_proj")


def layout(cfg: dict) -> list:
    """(name, shape) of every parameter in the program's order."""
    s = sizes(cfg)
    d, hd, di, n, r = (s["dim"], s["head_dim"], s["d_inner"], s["d_state"],
                       s["dt_rank"])
    mamba = [("mamba.in_proj", (d, 2 * di)),
             ("mamba.conv_w", (di, s["d_conv"])), ("mamba.conv_b", (di,)),
             ("mamba.x_proj", (di, r + 2 * n)), ("mamba.dt_norm", (r,)),
             ("mamba.b_norm", (n,)), ("mamba.c_norm", (n,)),
             ("mamba.dt_proj", (r, di)), ("mamba.dt_bias", (di,)),
             ("mamba.a_log", (di, n)), ("mamba.d", (di,)),
             ("mamba.out_proj", (di, d))]
    attention = [("wq", (s["heads"], d, hd)), ("wk", (s["kv_heads"], d, hd)),
                 ("wv", (s["kv_heads"], d, hd)), ("wo", (s["heads"], hd, d))]
    dense = [("ffn.wg", (d, s["hidden"])), ("ffn.wu", (d, s["hidden"])),
             ("ffn.wd", (s["hidden"], d))]
    e = s["experts"]
    moe = [("moe.router", (d, e)), ("moe.wg", (e, d, s["hidden"])),
           ("moe.wu", (e, d, s["hidden"])), ("moe.wd", (e, s["hidden"], d))]
    out = [("embed", (s["vocab"], d))]
    for mixer, ffn in kinds(cfg):
        out += [("rms.g", (d,))] + (attention if mixer == "attention"
                                    else mamba)
        out += [("rms.g", (d,))] + (moe if ffn == "moe" else dense)
    return out + [("rms.g", (d,)), ("weights", (d, s["vocab"])),
                  ("bias", (s["vocab"],))]


class Weights:
    """The leaves of ``layout`` by role: ``layers[i]`` is a dict of the
    layer's tensors by their names' last part (``g``, ``wq``, ``in_proj``,
    ``router`` ...; ``ffn_g`` the FFN's gain)."""

    def __init__(self, cfg: dict, leaves):
        self.cfg = cfg
        leaves = list(leaves)
        names = [name for name, _ in layout(cfg)]
        if len(leaves) != len(names):
            raise ValueError(f"{len(leaves)} leaves for {len(names)} "
                             "parameters")
        self.embed = leaves[0]
        self.final_g, self.head_w, self.head_b = leaves[-3:]
        self.layers = []
        at = 1
        for mixer, ffn in kinds(cfg):
            n_mix = 4 if mixer == "attention" else len(MAMBA)
            n_ffn = 4 if ffn == "moe" else 3
            mix = zip(names[at + 1:at + 1 + n_mix],
                      leaves[at + 1:at + 1 + n_mix])
            layer = {"g": leaves[at], "mixer": mixer, "ffn": ffn}
            layer.update((k.split(".")[-1], v) for k, v in mix)
            at += 1 + n_mix
            layer["ffn_g"] = leaves[at]
            layer.update((k.split(".")[-1], v) for k, v in
                         zip(names[at + 1:at + 1 + n_ffn],
                             leaves[at + 1:at + 1 + n_ffn]))
            at += 1 + n_ffn
            self.layers.append(layer)


def rms(x, g, eps: float):
    return x / torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * g


def silu(x):
    return x / (1.0 + torch.exp(-x))


def attention(p, x, kv_dtype=None):
    """Causal GQA over ``x`` [b, t, dim], no positions; query head ``i``
    reads K/V head ``i // (heads / kv_heads)``."""
    q = torch.einsum("btc,hcd->bhtd", x, p["wq"])
    k = torch.einsum("btc,hcd->bhtd", x, p["wk"])
    v = torch.einsum("btc,hcd->bhtd", x, p["wv"])
    if kv_dtype is not None:
        k = k.to(kv_dtype).to(q.dtype)
        v = v.to(kv_dtype).to(q.dtype)
    b, h, t, d = q.shape
    group = h // k.shape[1]
    keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    outs = []
    for j in range(k.shape[1]):
        s = q[:, j * group:(j + 1) * group] @ k[:, j:j + 1].transpose(-1, -2)
        s = (s / math.sqrt(d)).masked_fill(~keep, float("-inf"))
        outs.append(torch.softmax(s, dim=-1) @ v[:, j:j + 1])
    return torch.einsum("bhtd,hde->bte", torch.cat(outs, dim=1), p["wo"])


def mamba(cfg, p, u):
    """The Mamba-1 mixer over ``u`` [b, t, dim] from a zero state, one
    position at a time."""
    eps = cfg["rms_norm_eps"]
    di, n = p["a_log"].shape
    r = p["dt_proj"].shape[0]
    k = p["conv_w"].shape[1]
    b, t, _ = u.shape
    x, z = (u @ p["in_proj"]).split(di, dim=-1)
    padded = torch.cat([x.new_zeros(b, k - 1, di), x], dim=1)
    conv = p["conv_b"] + sum(padded[:, j:j + t] * p["conv_w"][:, j]
                             for j in range(k))
    x = silu(conv)
    dt, bm, cm = (x @ p["x_proj"]).split([r, n, n], dim=-1)
    dt = rms(dt, p["dt_norm"], eps)
    bm = rms(bm, p["b_norm"], eps)
    cm = rms(cm, p["c_norm"], eps)
    delta = torch.nn.functional.softplus(dt @ p["dt_proj"] + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    s = u.new_zeros(b, di, n)
    ys = []
    for i in range(t):
        s = (torch.exp(delta[:, i, :, None] * a) * s
             + delta[:, i, :, None] * bm[:, i, None, :] * x[:, i, :, None])
        ys.append((s * cm[:, i, None, :]).sum(-1) + p["d"] * x[:, i])
    y = torch.stack(ys, dim=1)
    return (y * silu(z)) @ p["out_proj"]


def swiglu(x, wg, wu, wd):
    return (silu(x @ wg) * (x @ wu)) @ wd


def route(cfg, p, x):
    """(experts [.., k], probabilities [.., k]) of each token: the top
    ``num_experts_per_tok`` of the router's softmax, ties to the lower
    index, not renormalized."""
    probs = torch.softmax(x @ p["router"], dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg["num_experts_per_tok"]
    return order[..., :k], vals[..., :k]


def moe(cfg, p, x):
    """The routed experts: each expert on the tokens that chose it."""
    idx, weight = route(cfg, p, x)
    flat = x.reshape(-1, x.shape[-1])
    idx = idx.reshape(flat.shape[0], -1)
    weight = weight.reshape(flat.shape[0], -1)
    out = torch.zeros_like(flat)
    for j in range(idx.shape[1]):
        for e in range(p["router"].shape[1]):
            rows = (idx[:, j] == e).nonzero()[:, 0]
            if rows.numel():
                y = swiglu(flat[rows], p["wg"][e], p["wu"][e], p["wd"][e])
                out = out.index_add(0, rows, y * weight[rows, j, None])
    return out.reshape(x.shape)


def forward(w: Weights, tokens, kv_dtype=None, probs=None):
    """Logits [b, t, vocab] of token ids [b, t] (differentiable).
    ``probs`` (a list) gets each MoE layer's router probabilities [b, t,
    experts]."""
    cfg = w.cfg
    eps = cfg["rms_norm_eps"]
    x = w.embed[tokens.long()]
    for p in w.layers:
        rn = rms(x, p["g"], eps)
        if p["mixer"] == "attention":
            x = x + attention(p, rn, kv_dtype)
        else:
            x = x + mamba(cfg, p, rn)
        rn = rms(x, p["ffn_g"], eps)
        if p["ffn"] == "moe":
            if probs is not None:
                probs.append(torch.softmax(rn @ p["router"], dim=-1))
            x = x + moe(cfg, p, rn)
        else:
            x = x + swiglu(rn, p["wg"], p["wu"], p["wd"])
    return rms(x, w.final_g, eps) @ w.head_w + w.head_b


def logits(w: Weights, tokens, kv_dtype=None):
    """Logits [t, vocab] of one sequence of token ids [t] (no gradient)."""
    with torch.no_grad():
        return forward(w, tokens[None], kv_dtype)[0]


def loss(w: Weights, tokens, targets):
    """The DSL model's loss: softmax over the logits, then ``-sum(labels *
    ln(p + 1e-9)) / (batch * seq)`` with one-hot labels of ``targets``."""
    p = torch.softmax(forward(w, tokens), dim=-1)
    picked = torch.gather(p, -1, targets.long()[..., None])
    return -torch.log(picked + 1e-9).sum() / targets.numel()
