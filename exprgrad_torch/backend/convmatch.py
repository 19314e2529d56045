"""Affine-contraction -> convolution pattern matching.

The port's copy of ``exprgrad_tpu/backend/convmatch.py``.  A
product-of-two-reads kernel whose access indices are affine sums of loop
iterators is a (possibly transposed) convolution.  Three kernel shapes come
out of the DSL + autodiff for ``conv2`` (reference layers/dnn.nim:45-53 and
the gradient kernels derived by passes/autodiff.py):

  forward:     out[n,y,x,f]       += img[n, y+dy, x+dx, c] * flt[f,dy,dx,c]
  filter grad: dflt[f,dy,dx,c]    += g[n,y,x,f] * img[n, y+dy, x+dx, c]
  image grad:  dimg[n,y+dy,x+dx,c]+= g[n,y,x,f] * flt[f,dy,dx,c]

The first two share one structure — the two-iterator dims live in a *read*
(case WINDOW); the third has them in the *write* (case SCATTER), which is a
full-padded convolution with a spatially flipped kernel (the classic
"backprop as transposed conv").  The classifier is the JAX package's, as
it is: it reads only the IR.  ``lower`` runs the match as one
``torch.nn.functional.conv1d/2d/3d`` (cuDNN on the card), where the JAX
package calls ``lax.conv_general_dilated``: no CNN kernel reaches the
general path, and the image gradient is no scatter.  A filter gradient
runs as ``torch.nn.grad.convNd_weight`` (:func:`_filter_gradient`).

torch has convolutions of 1 to 3 spatial dims; ``lax`` takes any number.
A match with more spatial dims declines (``ok`` False, the reason in
``why``) and the kernel takes the general path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ir import Kernel, Op, TensorOp

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_WEIGHT = {1: torch.nn.grad.conv1d_weight, 2: torch.nn.grad.conv2d_weight,
                3: torch.nn.grad.conv3d_weight}


def _filter_gradient(lhs, rhs, s_out, strides, dilations, groups):
    """``conv(lhs, rhs)`` computed as the filter gradient of another conv.

    A window whose kernel spans more points than its output is the
    gradient of a conv's filter: out[n,f,o] = sum_{c,k} lhs[n,c,o*s+k*d]
    rhs[f,c,k] with c the batch and k the image.  As a forward conv that
    is one implicit GEMM with a reduction as long as the batch times the
    image and an output of a few points, which cuDNN runs nearly serially
    (2.85 ms a launch in fashion_mnist_cnn's fit at batch 256, 88% of the
    epoch's device time, on an H100 80GB HBM3 at 700 W;
    scripts/profile_torch_cnn.py).  Swapping the batch with the contraction channels,
    and the stride with the dilation, makes it the filter gradient
    ``torch.nn.grad.convNd_weight`` computes (cuDNN's backward-filter
    kernels): dW[f,n,o] = sum_{c,k} rhs[c,f,k] lhs[c,n,k*d+o*s].  The
    JAX package leaves this choice to XLA."""
    n, channels = lhs.shape[:2]
    c = channels // groups
    spatial = tuple(lhs.shape[2:])
    # (n, g, c, S...) -> (c, g, n, S...): channels stay g-major
    x = lhs.reshape((n, groups, c) + spatial).transpose(0, 2).reshape(
        (c, groups * n) + spatial)
    dw = _CONV_WEIGHT[len(spatial)](
        x, (rhs.shape[0], n) + s_out, rhs.transpose(0, 1), stride=dilations,
        dilation=strides, groups=groups)
    return dw.transpose(0, 1)


@dataclass
class _OpInfo:
    op: TensorOp
    # per dim: list of (axis, coeff), sorted by axis
    dims: list[list[tuple[int, int]]]


def _affine_dims(op: TensorOp, axis_of_reg: dict[int, int]) -> Optional[_OpInfo]:
    dims = []
    for index in op.dims:
        if index.setup or index.constant != 0 or not index.factors:
            return None
        terms = []
        for reg, coeff in index.factors.items():
            if reg not in axis_of_reg or coeff < 1:
                return None
            terms.append((axis_of_reg[reg], coeff))
        if len(terms) > 2:
            return None
        dims.append(sorted(terms))
    return _OpInfo(op, dims)


class ConvMatch:
    """Attempt to classify a kernel as a convolution; see module docstring."""

    def __init__(self, lowering, kernel: Kernel):
        low = self.low = lowering
        self.kernel = kernel
        self.why: Optional[str] = None  # set when a conv match declines
        self.ok = self._classify()
        if self.ok and len(self.spatial) not in _CONV:
            self.ok = False
            self.why = (f"a convolution over {len(self.spatial)} spatial "
                        "dims (torch has conv1d to conv3d)")
        # a window whose kernel spans more points than its output: the
        # gradient of a conv's filter, whose "kernel" is the output
        # gradient (see _filter_gradient)
        self.filter_gradient = self.ok and self.case == "window" and (
            np.prod([low.sizes[s["ker"]] for s in self.spatial])
            > np.prod([low.sizes[s["out"]] for s in self.spatial]))

    def _classify(self) -> bool:
        low = self.low
        kernel = self.kernel
        write = kernel.write
        if write is None or write.is_raw or kernel.setup:
            return False
        if len(kernel.reads) != 2 or any(r.is_raw for r in kernel.reads):
            return False

        # expression: product of the two reads (scalar consts allowed)
        defs = {i.res: i for i in kernel.expr.instrs}
        read_regs = {r.data for r in kernel.reads}

        memo: dict = {}

        def walk(reg):
            if reg not in memo:
                memo[reg] = _walk(reg)
            return memo[reg]

        def _walk(reg):
            if reg in read_regs:
                return [reg], 1.0
            instr = defs.get(reg)
            if instr is None:
                return None
            if instr.op == Op.MUL:
                lhs, rhs = walk(instr.args[0]), walk(instr.args[1])
                if lhs and rhs:
                    return lhs[0] + rhs[0], lhs[1] * rhs[1]
            elif instr.op == Op.SCALAR:
                return [], instr.scalar_lit
            elif instr.op == Op.NEG:
                inner = walk(instr.args[0])
                if inner:
                    return inner[0], -inner[1]
            elif instr.op == Op.DIV:
                lhs, rhs = walk(instr.args[0]), walk(instr.args[1])
                if lhs and rhs and not rhs[0]:
                    return lhs[0], lhs[1] / rhs[1]
            return None

        parsed = walk(kernel.expr.res)
        if parsed is None or sorted(parsed[0]) != sorted(read_regs):
            return False
        self.const = parsed[1]

        infos = []
        for r in kernel.reads:
            info = _affine_dims(r, low.axis_of_reg)
            if info is None:
                return False
            infos.append(info)
        w_info = _affine_dims(write, low.axis_of_reg)
        if w_info is None:
            return False

        # all loops must start at 0
        if any(s != 0 for s in low.starts):
            return False

        # locate two-iterator dims
        pairs_in = [
            [d for d in info.dims if len(d) == 2] for info in infos
        ]
        pairs_w = [d for d in w_info.dims if len(d) == 2]

        if pairs_w and (pairs_in[0] or pairs_in[1]):
            return False

        if pairs_w:
            self.case = "scatter"
        elif pairs_in[0] or pairs_in[1]:
            self.case = "window"
            if pairs_in[0] and pairs_in[1]:
                return False
            if pairs_in[1]:  # canonicalize: pair-holding read is lhs (A)
                infos = [infos[1], infos[0]]
        else:
            return False
        self.a_info, self.b_info = infos
        self.w_info = w_info

        # occurrence bookkeeping: axis -> set of ops ("A","B","W") where the
        # axis appears ALONE, and pairs
        alone: dict[int, set[str]] = {}
        counts: dict[int, int] = {}
        for name, info in (("A", self.a_info), ("B", self.b_info), ("W", w_info)):
            for d in info.dims:
                for axis, coeff in d:
                    counts[axis] = counts.get(axis, 0) + 1
                if len(d) == 1:
                    axis, coeff = d[0]
                    if coeff != 1:
                        return False
                    if name in alone.setdefault(axis, set()):
                        return False  # same axis twice in one op
                    alone[axis].add(name)

        sizes = low.sizes
        self.spatial: list[dict] = []
        used_axes: set[int] = set()

        if self.case == "window":
            for d in [d for d in self.a_info.dims if len(d) == 2]:
                (ax1, c1), (ax2, c2) = d
                # one partner alone in W (out-spatial, may be strided),
                # the other alone in B (kernel)
                cand = None
                for (o_ax, o_c), (k_ax, k_c) in ((d[0], d[1]), (d[1], d[0])):
                    if (
                        alone.get(o_ax) == {"W"}
                        and counts[o_ax] == 2
                        and alone.get(k_ax) == {"B"}
                        and counts[k_ax] == 2
                    ):
                        cand = (o_ax, o_c, k_ax, k_c)
                        break
                if cand is None:
                    return False
                o_ax, stride, k_ax, dilation = cand
                self.spatial.append(
                    {"out": o_ax, "ker": k_ax, "stride": stride,
                     "dilation": dilation}
                )
                used_axes.update((o_ax, k_ax))
        else:
            for d in pairs_w:
                (ax1, c1), (ax2, c2) = d
                if c1 != 1 or c2 != 1:
                    return False
                cand = None
                for p_ax, q_ax in ((ax1, ax2), (ax2, ax1)):
                    if (
                        alone.get(p_ax, set()) <= {"A", "B"}
                        and counts[p_ax] == 2
                        and alone.get(q_ax, set()) <= {"A", "B"}
                        and counts[q_ax] == 2
                        and "A" in alone.get(p_ax, set())
                        and "B" in alone.get(q_ax, set())
                    ):
                        cand = (p_ax, q_ax)
                        break
                if cand is None:
                    return False
                p_ax, q_ax = cand
                self.spatial.append(
                    {"out": p_ax, "ker": q_ax, "stride": 1, "dilation": 1}
                )
                used_axes.update((p_ax, q_ax))

        # classify remaining single axes; an axis alone in ALL THREE ops is
        # a GROUP axis (depthwise/grouped convolution -> feature groups)
        self.n_axes: list[int] = []
        self.f_axes: list[int] = []
        self.c_axes: list[int] = []
        self.g_axes: list[int] = []
        for axis in range(low.nloops):
            if axis in used_axes:
                continue
            where = alone.get(axis, set())
            if counts.get(axis, 0) != len(where):
                return False
            if where == {"A", "W"}:
                self.n_axes.append(axis)
            elif where == {"B", "W"}:
                self.f_axes.append(axis)
            elif where == {"A", "B"}:
                self.c_axes.append(axis)
            elif where == {"A", "B", "W"}:
                self.g_axes.append(axis)
            else:
                return False

        # verify extents against tensor shapes
        shapes = low.shapes

        def check(info, roles_fn):
            shape = shapes[info.op.tensor]
            if len(shape) != len(info.dims):
                return False
            for dim, d in enumerate(info.dims):
                expected = roles_fn(d)
                if expected is None or shape[dim] != expected:
                    return False
            return True

        def extent(d):
            if len(d) == 1:
                axis, coeff = d[0]
                return coeff * (sizes[axis] - 1) + 1
            (a1, c1), (a2, c2) = d
            return c1 * (sizes[a1] - 1) + c2 * (sizes[a2] - 1) + 1

        for info in (self.a_info, self.b_info, self.w_info):
            shape = shapes[info.op.tensor]
            if len(shape) != len(info.dims):
                return False
            for dim, d in enumerate(info.dims):
                if shape[dim] != extent(d):
                    return False
        return True

    # ------------------------------------------------------------------
    def lower(self, tensors: dict):
        """Emit the conv; returns the value to accumulate into the output."""
        low = self.low
        sizes = low.sizes
        a, b, w = self.a_info, self.b_info, self.w_info

        def positions(info):
            pos = {}
            for i, d in enumerate(info.dims):
                if len(d) == 1:
                    pos[d[0][0]] = i
                else:
                    pos[tuple(sorted(ax for ax, _ in d))] = i
            return pos

        def total(axes):
            return int(np.prod([sizes[ax] for ax in axes], dtype=np.int64))

        a_pos, b_pos = positions(a), positions(b)
        spatial = self.spatial
        n_axes, f_axes, c_axes = self.n_axes, self.f_axes, self.c_axes
        g_axes = self.g_axes
        g_total, c_total = total(g_axes), total(c_axes)

        if self.case == "window":
            a_spatial_pos = [
                a_pos[tuple(sorted((s["out"], s["ker"])))] for s in spatial
            ]
            padding = [0] * len(spatial)
            strides = [s["stride"] for s in spatial]
            dilations = [s["dilation"] for s in spatial]
        else:
            a_spatial_pos = [a_pos[s["out"]] for s in spatial]
            padding = [sizes[s["ker"]] - 1 for s in spatial]
            strides = [1] * len(spatial)
            dilations = [1] * len(spatial)
        b_spatial_pos = [b_pos[s["ker"]] for s in spatial]

        # lhs: (N..., G..., C..., S...) -> (N, G*C, S...): channels g-major,
        # so group g of the conv reads input channels [g*C, (g+1)*C)
        lhs = tensors[a.op.tensor].permute(
            [a_pos[ax] for ax in n_axes + g_axes + c_axes] + a_spatial_pos)
        lhs = lhs.reshape((total(n_axes), g_total * c_total)
                          + tuple(lhs.shape[lhs.dim() - len(spatial):]))

        # rhs: (G..., F..., C..., S...) -> (G*F, C, S...): output channel
        # g*F+f belongs to group g
        rhs = tensors[b.op.tensor].permute(
            [b_pos[ax] for ax in g_axes + f_axes + c_axes] + b_spatial_pos)
        rhs = rhs.reshape((g_total * total(f_axes), c_total)
                          + tuple(rhs.shape[rhs.dim() - len(spatial):]))
        if self.case == "scatter":
            rhs = torch.flip(rhs, dims=list(range(2, rhs.dim())))

        if self.filter_gradient:
            out = _filter_gradient(lhs, rhs,
                                   tuple(sizes[s["out"]] for s in spatial),
                                   strides, dilations, g_total)
        else:
            out = _CONV[len(spatial)](lhs, rhs, stride=strides,
                                      padding=padding, dilation=dilations,
                                      groups=g_total)
        if self.const != 1.0:
            out = out * self.const

        # out: (N, G*F, S_out...) -> unmerge -> write order
        s_out = tuple(out.shape[2:])
        out = out.reshape(
            tuple(sizes[ax] for ax in n_axes + g_axes + f_axes) + s_out)
        cur_axis_order = n_axes + g_axes + f_axes
        perm = []
        for d in w.dims:
            if len(d) == 1 and d[0][0] in cur_axis_order:
                perm.append(cur_axis_order.index(d[0][0]))
            else:
                # a window case's strided out axis, or the scatter case's
                # pair: the conv's output spatial dim
                key = (d[0][0] if len(d) == 1
                       else tuple(sorted(ax for ax, _ in d)))
                for i, s in enumerate(spatial):
                    if key in (s["out"], tuple(sorted((s["out"],
                                                       s["ker"])))):
                        perm.append(len(cur_axis_order) + i)
                        break
        return out.permute(perm).to(low.dtype)
