"""Mamba-1 mixer (Gu & Dao 2023, as Jamba uses it): the extern op, the two
kernels of the serving path and their plain twins.

The mixer of a ``[b, t, dim]`` input ``u``, with ``d_inner`` channels,
``d_state`` states a channel, a ``d_conv``-wide causal conv and a
``dt_rank``-wide step projection (Jamba's, with its inner RMSNorms)::

    [x, z]  = u @ in_proj                       x first
    x       = silu(causal depthwise conv(x) + conv_b)
    [dt, B, C] = x @ x_proj                     dt_rank, d_state, d_state
    dt, B, C = rms(dt) * dt_norm, rms(B) * b_norm, rms(C) * c_norm
    delta   = softplus(dt @ dt_proj + dt_bias)
    s_t     = exp(delta_t A) * s_{t-1} + delta_t B_t x_t,  A = -exp(a_log)
    y_t     = s_t . C_t + D * x_t
    out     = (y * silu(z)) @ out_proj

The state ``s`` [d_inner, d_state] and the conv window (the last
``d_conv - 1`` inputs of ``x``) start at zero.

* ``mamba`` / ``mamba_grad`` are the DSL's extern op (``layers.mamba``),
  modelled on ``ops/recurrent.py``: the forward runs the whole mixer from
  a zero state (through the kernels on the card in float32, where a
  float64 program is refused; :func:`mixer_plain` on the CPU); the
  backward is ``torch.autograd.grad`` of :func:`mixer_plain`, the
  sequential scan, on the CPU only: it has no kernel, and a CUDA tensor
  is refused.  The dtype rule is :mod:`.moe`'s.
* The serving path (``models/serve.py``) runs :func:`causal_conv` and
  :func:`selective_scan` on a :class:`MambaState` in place, with each
  row's true length: a prompt padded to its bucket, or a decode step in
  which a parked row has length 0.  Positions at or past a row's length
  give 0 and leave its state as it was.  On a CUDA tensor each launches
  its kernel (``csrc/selective_scan.cu``) or raises; on a CPU tensor it
  runs its plain twin, :func:`causal_conv_plain` and
  :func:`selective_scan_plain`, which is also what the kernels are
  checked against on the card (chip_smoke.py).  The mixer's four weight
  products (``in_proj``, ``x_proj``, ``dt_proj``, ``out_proj``) go
  through ``ops.matmul.weight_product`` (the weight-streaming kernel at
  a decode step's few rows); the inner norms are torch's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..errors import ModelRuntimeError
from ..registry import register_extern
from ..utils import kernels
from .matmul import weight_product
from .moe import compute_dtype

# kernel launches since the last reset (a CUDA graph's replays count the
# launches it captured); chip_smoke.py and the benchmark read them
scan_launches = 0
conv_launches = 0

_I32 = 2 ** 31 - 1


class MambaState(NamedTuple):
    """One Mamba layer's recurrent state for ``b`` rows, float32: the
    conv window (the last ``d_conv - 1`` inputs, oldest first) and the
    scan state."""

    conv: torch.Tensor  # [b, d_inner, d_conv - 1]
    ssm: torch.Tensor   # [b, d_inner, d_state]


def init_state(batch: int, d_inner: int, d_conv: int, d_state: int,
               device="cuda") -> MambaState:
    """A zero state of ``batch`` rows."""
    return MambaState(
        conv=torch.zeros((batch, d_inner, d_conv - 1), dtype=torch.float32,
                         device=device),
        ssm=torch.zeros((batch, d_inner, d_state), dtype=torch.float32,
                        device=device))


def silu(v):
    return v / (1.0 + torch.exp(-v))


def rms(v, g, eps: float):
    return v / torch.sqrt(torch.mean(v * v, dim=-1, keepdim=True) + eps) * g


def _live(lengths, t: int, device):
    """[b, t] bool: positions before each row's length."""
    return torch.arange(t, device=device)[None, :] < lengths.long()[:, None]


def conv_core(x, w, bias, window):
    """``silu(conv)`` [b, t, di] of inputs ``x`` [b, t, di] after the
    window ``[b, di, k-1]``, and the inputs with the window in front
    ``[b, k-1+t, di]``."""
    k = w.shape[1]
    t = x.shape[1]
    full = torch.cat([window.transpose(1, 2).to(x.dtype), x], dim=1)
    acc = bias + sum(full[:, j:j + t] * w[:, j] for j in range(k))
    return silu(acc), full


def scan_core(x, dt, z, B, C, a_log, d, dt_bias, s, lengths=None):
    """The gated scan outputs ``[b, t, di]`` from state ``s`` [b, di, n],
    and the state after each row's ``lengths`` (all ``t`` when None):
    one step a position, a Python loop (the sequential reference)."""
    A = -torch.exp(a_log)
    delta = torch.nn.functional.softplus(dt + dt_bias)
    live = None if lengths is None else _live(lengths, x.shape[1], x.device)
    ys = []
    for i in range(x.shape[1]):
        new = (torch.exp(delta[:, i, :, None] * A) * s
               + (delta[:, i] * x[:, i])[..., None] * B[:, i, None, :])
        y = ((new * C[:, i, None, :]).sum(-1) + d * x[:, i]) * silu(z[:, i])
        if live is None:
            s = new
        else:
            s = torch.where(live[:, i, None, None], new, s)
            y = torch.where(live[:, i, None], y, torch.zeros_like(y))
        ys.append(y)
    if not ys:
        return x.new_zeros(x.shape), s
    return torch.stack(ys, dim=1), s


def causal_conv_plain(x, w, bias, conv_state, lengths):
    """The plain version of the conv kernel: ``silu(bias + conv)`` [b, t,
    di] of ``x`` [b, t, di] (any strides) after each row's window in
    ``conv_state`` [b, di, k-1], 0 at or past the row's length; the
    window moves, in place, to the last ``k - 1`` inputs before the
    length."""
    keep = w.shape[1] - 1
    out, full = conv_core(x.float(), w.float(), bias.float(), conv_state)
    live = _live(lengths, x.shape[1], x.device)
    out = torch.where(live[..., None], out, torch.zeros_like(out))
    # the row's last keep inputs end at full index len + keep - 1
    at = lengths.long()[:, None] + torch.arange(keep, device=x.device)
    moved = torch.gather(full, 1, at[..., None].expand(-1, -1, x.shape[2]))
    conv_state.copy_(moved.transpose(1, 2))
    return out


def selective_scan_plain(x, dt, z, B, C, a_log, d, dt_bias, ssm_state,
                         lengths):
    """The plain version of the scan kernel: the gated outputs [b, t, di]
    (0 at or past each row's length) from ``ssm_state`` [b, di, n], which
    moves in place to the state after the row's length."""
    y, s = scan_core(x.float(), dt.float(), z.float(), B.float(),
                     C.float(), a_log.float(), d.float(), dt_bias.float(),
                     ssm_state, lengths)
    ssm_state.copy_(s)
    return y


def _check(name, x, ref, dims: int, strided: bool = False):
    if x.device != ref.device:
        raise ValueError(f"{name} is on {x.device}, x on {ref.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, not {x.dtype}")
    if x.dim() != dims:
        raise ValueError(f"{name} must have {dims} dims, not {x.dim()}")
    if strided:
        if x.stride(-1) != 1 or max(x.stride()) > _I32:
            raise ValueError(f"{name} needs unit channel stride")
    elif not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _lengths(lengths, b: int, device) -> torch.Tensor:
    lens = torch.as_tensor(lengths, device=device)
    if lens.dtype.is_floating_point or tuple(lens.shape) != (b,):
        raise ValueError(f"lengths must be {b} integers")
    return lens.to(torch.int32)


def causal_conv(x, w, bias, conv_state, lengths):
    """:func:`causal_conv_plain` through the conv kernel on a CUDA tensor
    (float32; ``x`` may be a view with a unit channel stride)."""
    if x.device.type == "cpu":
        return causal_conv_plain(x, w, bias, conv_state, lengths)
    b, t, di = x.shape
    _check("x", x, x, 3, strided=True)
    _check("w", w, x, 2)
    _check("bias", bias, x, 1)
    _check("conv_state", conv_state, x, 3)
    k = w.shape[1]
    if tuple(conv_state.shape) != (b, di, k - 1) or w.shape[0] != di:
        raise ValueError(
            f"conv_state {tuple(conv_state.shape)} / w {tuple(w.shape)} do "
            f"not fit x {tuple(x.shape)}")
    lens = _lengths(lengths, b, x.device)
    out = torch.empty((b, t, di), dtype=torch.float32, device=x.device)
    kernels.call("egt_mamba_conv", x.device, x.data_ptr(), w.data_ptr(),
                 bias.data_ptr(), conv_state.data_ptr(), lens.data_ptr(),
                 out.data_ptr(), b, t, di, k, x.stride(0), x.stride(1))
    global conv_launches
    conv_launches += 1
    return out


def selective_scan(x, dt, z, B, C, a_log, d, dt_bias, ssm_state, lengths):
    """:func:`selective_scan_plain` through the scan kernel on a CUDA
    tensor (float32; ``x`` and ``z`` may be views with a unit channel
    stride; ``d_state`` 8 or 16)."""
    if x.device.type == "cpu":
        return selective_scan_plain(x, dt, z, B, C, a_log, d, dt_bias,
                                    ssm_state, lengths)
    b, t, di = x.shape
    n = a_log.shape[1]
    for name, v, dims, strided in (
            ("x", x, 3, True), ("z", z, 3, True), ("dt", dt, 3, False),
            ("B", B, 3, False), ("C", C, 3, False), ("a_log", a_log, 2, False),
            ("d", d, 1, False), ("dt_bias", dt_bias, 1, False),
            ("ssm_state", ssm_state, 3, False)):
        _check(name, v, x, dims, strided)
    if (tuple(dt.shape) != (b, t, di) or tuple(z.shape) != (b, t, di)
            or tuple(B.shape) != (b, t, n) or tuple(C.shape) != (b, t, n)
            or tuple(ssm_state.shape) != (b, di, n)):
        raise ValueError("selective_scan: shapes do not fit x [b, t, d_inner]"
                         " and a_log [d_inner, d_state]")
    if n not in (8, 16):
        raise ValueError(f"the scan kernel takes d_state 8 or 16, not {n}")
    lens = _lengths(lengths, b, x.device)
    y = torch.empty((b, t, di), dtype=torch.float32, device=x.device)
    kernels.call("egt_mamba_scan", x.device, x.data_ptr(), dt.data_ptr(),
                 z.data_ptr(), B.data_ptr(), C.data_ptr(), a_log.data_ptr(),
                 d.data_ptr(), dt_bias.data_ptr(), ssm_state.data_ptr(),
                 lens.data_ptr(), y.data_ptr(), b, t, di, n, x.stride(0),
                 x.stride(1), z.stride(0), z.stride(1))
    global scan_launches
    scan_launches += 1
    return y


class Mixer(NamedTuple):
    """One Mamba layer's weights, in the order and under the names of the
    DSL's parameters (``mamba.<field>``)."""

    in_proj: torch.Tensor   # [dim, 2 * d_inner]
    conv_w: torch.Tensor    # [d_inner, d_conv]
    conv_b: torch.Tensor    # [d_inner]
    x_proj: torch.Tensor    # [d_inner, dt_rank + 2 * d_state]
    dt_norm: torch.Tensor   # [dt_rank]
    b_norm: torch.Tensor    # [d_state]
    c_norm: torch.Tensor    # [d_state]
    dt_proj: torch.Tensor   # [dt_rank, d_inner]
    dt_bias: torch.Tensor   # [d_inner]
    a_log: torch.Tensor     # [d_inner, d_state]
    d: torch.Tensor         # [d_inner]
    out_proj: torch.Tensor  # [d_inner, dim]


def _inner(p: Mixer, xc, eps: float):
    """(dt before its bias, B, C) of the conv's outputs."""
    rank, n = p.dt_proj.shape[0], p.a_log.shape[1]
    dbc = weight_product(xc, p.x_proj)
    dt = weight_product(rms(dbc[..., :rank], p.dt_norm, eps), p.dt_proj)
    return (dt, rms(dbc[..., rank:rank + n], p.b_norm, eps),
            rms(dbc[..., rank + n:], p.c_norm, eps))


def mixer(u, p: Mixer, state: MambaState, lengths, eps: float):
    """The mixer's output ``[b, t, dim]`` for ``u`` from ``state`` (moved
    in place to each row's ``lengths``), through :func:`causal_conv` and
    :func:`selective_scan` (float32)."""
    di = p.d.shape[0]
    xz = weight_product(u, p.in_proj)
    xc = causal_conv(xz[..., :di], p.conv_w, p.conv_b, state.conv, lengths)
    dt, B, C = _inner(p, xc, eps)
    y = selective_scan(xc, dt, xz[..., di:], B, C, p.a_log, p.d, p.dt_bias,
                       state.ssm, lengths)
    return weight_product(y, p.out_proj)


def mixer_plain(u, p: Mixer, eps: float):
    """The mixer from a zero state over every position, in ``u``'s dtype,
    differentiable (the backward's forward)."""
    b, _, _ = u.shape
    di, n = p.a_log.shape
    k = p.conv_w.shape[1]
    xz = u @ p.in_proj
    xc, _ = conv_core(xz[..., :di], p.conv_w, p.conv_b,
                      u.new_zeros((b, di, k - 1)))
    dt, B, C = _inner(p, xc, eps)
    y, _ = scan_core(xc, dt, xz[..., di:], B, C, p.a_log, p.d, p.dt_bias,
                     u.new_zeros((b, di, n)))
    return y @ p.out_proj


def _eps(attrs: dict) -> float:
    return float(attrs.get("eps", 1e-6))


def _mamba(args, attrs, ctx):
    u, *weights = args
    ct = compute_dtype(u.dtype)
    p = Mixer(*(w.to(ct) for w in weights))
    uf = u.to(ct)
    if uf.device.type != "cpu":
        if ct != torch.float32:
            raise ModelRuntimeError(
                f"the Mamba kernels run float32; a {u.dtype} program's "
                "mixer runs on the CPU only")
        b, t, _ = uf.shape
        di, n = p.a_log.shape
        state = init_state(b, di, p.conv_w.shape[1], n, uf.device)
        lens = torch.full((b,), t, dtype=torch.int32, device=uf.device)
        out = mixer(uf, p, state, lens, _eps(attrs))
    else:
        out = mixer_plain(uf, p, _eps(attrs))
    return out.to(u.dtype)


def _mamba_grad(args, attrs, ctx):
    *inputs, g = args
    if g.device.type != "cpu":
        raise ModelRuntimeError(
            "the Mamba mixer's backward has no kernel (a sequential scan "
            "in Python); train a model with Mamba layers on the CPU")
    ct = compute_dtype(inputs[0].dtype)
    with torch.enable_grad():
        leaves = [a.detach().to(ct).requires_grad_(True) for a in inputs]
        out = mixer_plain(leaves[0], Mixer(*leaves[1:]), _eps(attrs))
        grads = torch.autograd.grad(out, leaves, g.to(ct),
                                    allow_unused=True)
    return tuple(torch.zeros_like(a) if d is None else d.to(a.dtype)
                 for a, d in zip(inputs, grads))


register_extern("mamba", 1, _mamba)
register_extern("mamba_grad", 1 + len(Mixer._fields), _mamba_grad)
