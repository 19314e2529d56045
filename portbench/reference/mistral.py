"""Plain PyTorch reference of the Mistral block as the configurations state
it: RMSNorm, rotate-half RoPE, grouped-query causal attention (optionally
sliding-window), SwiGLU, an untied LM head (with the port's head bias),
softmax cross entropy and Adam.

No kernel, cache or batching of the program: dense ``torch`` operations in
float32 with TF32 off (``precision``).  Only ``kv_dtype`` reproduces a
stated storage precision: a served model's keys and values are held in
bfloat16, so they are rounded to it before attention reads them.  The
weights come from ``portbench.weights`` (the same leaves the program is
given); everything the program derives (rotary angles, caches, optimizer
state) is worked out again here.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch.utils.checkpoint import checkpoint

PER_BLOCK = 9  # attn gain, wq, wk, wv, wo, ffn gain, wg, wu, wd


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


class Weights:
    """The leaves of ``weights.layout`` by role."""

    def __init__(self, cfg: dict, leaves):
        self.cfg = cfg
        self.leaves = list(leaves)
        n = cfg["num_hidden_layers"]
        self.embed = self.leaves[0]
        self.blocks = [self.leaves[1 + PER_BLOCK * b:1 + PER_BLOCK * (b + 1)]
                       for b in range(n)]
        self.final_g, self.head_w, self.head_b = self.leaves[-3:]


def rms(x, g, eps: float):
    return x / torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * g


def rope(x, positions, base: float):
    """Rotate-half RoPE of ``x`` [b, h, t, hd] at ``positions`` [t]: the
    angle of dimension i is ``pos * exp(i * -2 ln(base) / hd)``, in
    float32."""
    hd = x.shape[-1]
    half = hd // 2
    inv = torch.exp(torch.arange(half, dtype=torch.float32, device=x.device)
                    * (-2.0 * math.log(base) / hd))
    ang = positions.float()[:, None] * inv[None, :]
    c, s = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _proj(x, w):
    """``x`` [b, t, c] by ``w`` [h, c, e] -> [b, h, t, e]."""
    h, c, e = w.shape
    out = x @ w.permute(1, 0, 2).reshape(c, h * e)
    return out.view(x.shape[0], x.shape[1], h, e).transpose(1, 2)


def attend(q, k, v, window):
    """Causal grouped-query attention; query head ``i`` reads K/V head
    ``i // (heads / kv_heads)``.  One K/V head at a time, so a long
    sequence's scores fit."""
    b, h, t, d = q.shape
    hkv = k.shape[1]
    group = h // hkv
    pos = torch.arange(t, device=q.device)
    keep = pos[None, :] <= pos[:, None]
    if window:
        keep = keep & (pos[None, :] > pos[:, None] - window)
    outs = []
    for j in range(hkv):
        qj = q[:, j * group:(j + 1) * group]
        s = (qj @ k[:, j:j + 1].transpose(-1, -2)) / math.sqrt(d)
        s = s.masked_fill(~keep, float("-inf"))
        outs.append(torch.softmax(s, dim=-1) @ v[:, j:j + 1])
    return torch.cat(outs, dim=1)


def block(cfg, blk, x, positions, kv_dtype=None, remat=False):
    """One pre-norm block: ``x + attn(rms(x))``, then ``+ ffn(rms(.))``."""
    attn_g, wq, wk, wv, wo, ffn_g, wg, wu, wd = blk
    eps = cfg["rms_norm_eps"]
    base = cfg["rope_theta"]
    rn = rms(x, attn_g, eps)
    q = rope(_proj(rn, wq), positions, base)
    k = rope(_proj(rn, wk), positions, base)
    v = _proj(rn, wv)
    if kv_dtype is not None:
        k = k.to(kv_dtype).float()
        v = v.to(kv_dtype).float()
    window = cfg.get("sliding_window")
    if remat:
        att = checkpoint(attend, q, k, v, window, use_reentrant=False)
    else:
        att = attend(q, k, v, window)
    h, hd, d = wo.shape
    att = att.transpose(1, 2).reshape(x.shape[0], x.shape[1], h * hd)
    x = x + att @ wo.reshape(h * hd, d)
    rn2 = rms(x, ffn_g, eps)
    g = rn2 @ wg
    return x + (g / (1.0 + torch.exp(-g)) * (rn2 @ wu)) @ wd


def logits(w: Weights, tokens, kv_dtype=None):
    """Logits [t, vocab] of one sequence of token ids [t] (no gradient)."""
    cfg = w.cfg
    with torch.no_grad():
        positions = torch.arange(tokens.shape[0], device=tokens.device)
        x = w.embed[tokens.long()][None]
        for blk in w.blocks:
            x = block(cfg, blk, x, positions, kv_dtype)
        x = rms(x, w.final_g, cfg["rms_norm_eps"])
        return (x @ w.head_w + w.head_b)[0]


def loss(w: Weights, tokens, targets):
    """The DSL model's loss: softmax over the head's logits, then
    ``-sum(labels * ln(p + 1e-9)) / (batch * seq)`` with one-hot labels
    of ``targets``.  Attention is recomputed in the backward pass."""
    cfg = w.cfg
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = w.embed[tokens.long()]
    for blk in w.blocks:
        x = block(cfg, blk, x, positions, remat=True)
    x = rms(x, w.final_g, cfg["rms_norm_eps"])
    p = torch.softmax(x @ w.head_w + w.head_b, dim=-1)
    picked = torch.gather(p, -1, targets.long()[..., None])
    return -torch.log(picked + 1e-9).sum() / targets.numel()


class Adam:
    """``layers.adam``'s update with bias correction by the step count:
    m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
    p -= eta (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)."""

    def __init__(self, params, eta=0.01, beta1=0.9, beta2=0.999, eps=1e-8):
        self.params = params
        self.eta, self.b1, self.b2, self.eps = eta, beta1, beta2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.eta * (m / c1) / (torch.sqrt(v / c2) + self.eps))
