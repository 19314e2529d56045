"""Fused row chains (kernel B6): IR -> Triton source, the plain version,
the wrapper and its launch count.

Counterpart of ``PallasRowChain.lower`` in
``exprgrad_tpu/backend/pallasgen.py``.  One ``@triton.jit`` source per
chain planned by :mod:`exprgrad_torch.backend.rowchain`: each program
owns a few whole rows (the axes no member reduces, flattened) and every
column of them (the axes the chain keeps whole, padded to a power of two
with a mask).  It loads each operand block once, computes the members in
order in registers (a reduction is ``tl.sum``/``tl.max``/``tl.min`` over
the columns, masked to the identity), and stores the final tensor and
each escaping intermediate, combined with its previous value.  The row
ops it fuses are bound by bytes: the input is read once instead of once
per member.

:func:`rowchain_impl` launches the kernel for CUDA tensors and raises on
any other device but the CPU, where it runs the plain version: the
members one after another through the port's own lowering.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import triton_build
from .mapreduce import (HEADER, _COMBINE, _REDUCE, _TL_DTYPE, Emitter,
                        Scope, _operands, contiguous_strides, identity_lit,
                        index_type, iterators, lit, pow2, program_ids)

# kernel launches since the last reset; chip_smoke.py reads it to prove
# the main path ran through the kernel
launches = 0


def emit_rowchain(chain) -> tuple[str, list[int], dict]:
    """The Triton source of a planned chain: ``(source, operand tensor
    ids, launch plan)``."""
    low = chain.members[0].low
    sizes = low.sizes
    p_axes, q_axes = chain.p_axes, chain.q_axes
    n_p = int(np.prod([sizes[a] for a in p_axes], dtype=np.int64))
    n_q = int(np.prod([sizes[a] for a in q_axes], dtype=np.int64))
    bp, bq = chain.block_p, pow2(n_q)
    shapes = [low.shapes[t] for m in chain.members
              for t in [m.kernel.write.tensor]
              + [r.tensor for r in m.kernel.reads]]
    itype = index_type(sizes, shapes)
    em = Emitter(low.shapes, p_axes, q_axes, itype, " " * 4, bp, bq)
    program_ids(em, bp, n_p, itype)
    iterators(em, p_axes, sizes, "p", "p")
    if q_axes:
        q_range = f"tl.arange(0, {bq})"
        if itype == "tl.int64":
            q_range += ".to(tl.int64)"
        em.line(f"q = {q_range}")
        em.line(f"q_ok = q < {n_q}")
        iterators(em, q_axes, sizes, "q", "q")
        em.line("P_ok = p_ok[:, None]")
        em.line("Q_ok = q_ok[None, :]")
        for a in p_axes:
            em.line(f"P{a} = p{a}[:, None]")
        for a in q_axes:
            em.line(f"Q{a} = q{a}[None, :]")

    out_members = chain.out_members
    produced: dict[int, object] = {}  # tensor id -> member value
    stores = []
    for mi, m in enumerate(chain.members):
        kern = m.kernel
        mode = kern.write.accumulate
        ident = identity_lit(mode)
        em.line(f"# member {mi}: the kernel writing "
                f"{low.program.tensors[kern.write.tensor].name or '?'!r}")
        scope = Scope(em, kern, m.low, m.setup_env, (),
                      {r.data: produced[r.tensor] for r in kern.reads
                       if r.tensor in produced})
        scope.run(kern.setup)
        value = scope.val(kern.expr.res)
        if m.red_axes and value.axes & set(q_axes):
            masked = em.tmp(f"tl.where(Q_ok, {value.f32()}, {ident})", "f",
                            value.axes)
            value = em.tmp(f"{_REDUCE[mode]}({masked.code}, axis=1)[:, None]",
                           "f", value.axes - set(q_axes))
        elif m.red_axes and mode == "add":
            value = em.tmp(f"{value.f32()} * {lit(float(n_q))}", "f",
                           value.axes)
        produced[kern.write.tensor] = value
        if mi in out_members:
            stores.append((mi, value))

    # the wrapper passes the outputs in out_members order
    stores.sort(key=lambda item: out_members.index(item[0]))
    dt = _TL_DTYPE[low.dtype]
    args = []
    out_elems = 0
    for k, (mi, value) in enumerate(stores):
        m = chain.members[mi]
        kern = m.kernel
        mode = kern.write.accumulate
        shape = low.shapes[kern.write.tensor]
        strides = contiguous_strides(shape)
        terms = [em.iterator(a).code + (f" * {s}" if s != 1 else "")
                 for a, s in zip(m.out_axes, strides)]
        mask = " & ".join(em.element_mask(m.out_axes))
        em.line(f"o = {' + '.join(terms)}")
        val = em.broadcast(value, m.out_axes)
        args.append(f"o{k}_ptr")
        elems = int(np.prod(shape, dtype=np.int64))
        out_elems += elems
        if not m.low.fresh_output:
            args.append(f"r{k}_ptr")
            out_elems += elems
            em.line(f"prev = tl.load(r{k}_ptr + o, mask={mask}, other=0.0)"
                    ".to(tl.float32)")
            val = _COMBINE[mode].format(a="prev", b=val)
        em.line(f"tl.store(o{k}_ptr + o, ({val}).to({dt}), mask={mask})")

    args = ", ".join(args + [f"x{j}_ptr" for j in range(len(em.args))])
    item = torch.tensor([], dtype=low.dtype).element_size()
    nbytes = item * (
        sum(int(np.prod(low.shapes[t], dtype=np.int64)) for t in em.args)
        + out_elems)
    source = (
        "# Generated by exprgrad_torch.ops.rowchain: kernel B6, the port "
        "of\n# exprgrad_tpu/backend/pallasgen.py:2375 PallasRowChain.lower"
        f" ({len(chain.members)} members).\n"
        f"# Bound: bytes; {nbytes} bytes read and written, "
        f"{nbytes / 3.35e12 * 1e3:.6f} ms at 3.35 TB/s.\n"
        f"# Design: each program owns {bp} of {n_p} rows and all {n_q} "
        "columns of them; every operand block is\n# loaded once, the "
        "members' values and reductions stay in registers, and only the "
        "final\n# tensor and the escaping intermediates are stored.\n"
        + HEADER + "\n\n"
        "@triton.jit\n"
        f"def egt_rowchain({args}):\n"
        + "\n".join(em.lines) + "\n"
    )
    plan = {"grid": (n_p + bp - 1) // bp, "num_warps": chain.num_warps,
            "block_p": bp, "block_q": bq, "bytes": nbytes}
    return source, list(em.args), plan


class RowChainKernel:
    """One generated B6 kernel: its source, operands, outputs and launch
    plan, and the plain version of the same chain."""

    def __init__(self, chain):
        self.source, self.tids, self.plan = emit_rowchain(chain)
        self.out_tids = [chain.kernels[mi].write.tensor
                         for mi in chain.out_members]
        self.fresh = [chain.members[mi].low.fresh_output
                      for mi in chain.out_members]
        self.dtype = chain.members[0].low.dtype
        self.plain = chain.plain
        self.handles = {}  # function name -> loaded Triton kernel


def rowchain_plain(kern: RowChainKernel, tensors: dict, epoch: int) -> dict:
    """The plain version: the members in order through the port's own
    lowering."""
    return kern.plain(tensors, epoch)


def rowchain_impl(kern: RowChainKernel, tensors: dict, epoch: int) -> dict:
    """``{tid: new value}`` of the chain's final tensor and escaping
    intermediates.  CUDA tensors launch the generated kernel or raise;
    CPU tensors run the plain version."""
    prevs = [tensors[t] for t in kern.out_tids]
    device = prevs[0].device
    if device.type == "cpu":
        return rowchain_plain(kern, tensors, epoch)
    if device.type != "cuda":
        raise ValueError(
            f"the row-chain kernel runs on CUDA tensors, not on {device}")
    if kern.dtype not in _TL_DTYPE or any(p.dtype != kern.dtype
                                          for p in prevs):
        raise ValueError(f"the row-chain kernel cannot store "
                         f"{[p.dtype for p in prevs]}")
    ops = _operands(kern, tensors, device)
    outs = [torch.empty_like(p, memory_format=torch.contiguous_format)
            for p in prevs]
    pairs = [t for out, prev, fresh in zip(outs, prevs, kern.fresh)
             for t in ((out,) if fresh else (out, prev.contiguous()))]
    fn = triton_build.handle(kern, "egt_rowchain")
    triton_build.launch(fn, (kern.plan["grid"],), kern.plan["num_warps"],
                        *pairs, *ops)
    global launches
    launches += 1
    return dict(zip(kern.out_tids, outs))
