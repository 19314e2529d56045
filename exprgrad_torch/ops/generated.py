"""The generated kernels (B5, B6) as ``torch.library`` ops.

A generated kernel lives in one executor: its Triton source, launch plan
and plain version come from the planner's objects.  An exported program
(``Model.export_compiled``) must run it in a process that never built
that executor, so the ops ``exprgrad_torch::mapreduce`` and
``exprgrad_torch::rowchain`` take the whole kernel as a *spec*: one
ASCII string holding the Triton source, the launch plan, the tensor ids
of the operands, and the IR of the kernel (or of each chain member) with
the shapes it runs at, written by the port's own checkpoint writer
(``io/serialize.py``).  The CUDA implementations are C++
(``csrc/launch.cpp``, loaded by ``utils/launcher.py``): a kernel's first
call on a device runs in Python through the op
``exprgrad_torch::generated_first`` (Triton compiles the source,
``utils/triton_build.py`` caches it by content, and the launch table is
registered), every later call launches from C++; the CPU
implementations run the plain version, the port's own lowering of the
same IR.

A kernel object registers itself under its spec when the planner makes
it (:func:`register`), so the executor's own calls find it again at the
cost of a dictionary lookup; a spec that no live object holds (a loaded
artifact) is rebuilt once from the string (:func:`lookup`).
"""

from __future__ import annotations

import base64
import io
import json
import sys
import types
import weakref
import zlib

import torch

from ..interp import accumulation_identity

LIB = torch.library.Library("exprgrad_torch", "FRAGMENT")

# (device type, spec) -> the live kernel object of an executor (dropped
# with it)
_live: weakref.WeakValueDictionary = weakref.WeakValueDictionary()
# (device type, spec) -> a kernel object rebuilt from the string (a loaded
# artifact's)
_rebuilt: dict = {}


def encode(fields: dict) -> str:
    """A spec string from JSON-able ``fields``."""
    data = json.dumps(fields, sort_keys=True, separators=(",", ":"))
    return base64.b64encode(zlib.compress(data.encode(), 9)).decode("ascii")


def decode(spec: str) -> dict:
    return json.loads(zlib.decompress(base64.b64decode(spec)))


def kernel_ir(kernel) -> str:
    """One IR kernel in the checkpoint format, base64."""
    from ..io.serialize import Writer, _w_kernel

    buf = io.BytesIO()
    _w_kernel(Writer(buf), kernel)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def read_kernel_ir(text: str):
    from ..io.serialize import Reader, _r_kernel

    return _r_kernel(Reader(io.BytesIO(base64.b64decode(text))))


def ir_fields(lowerings) -> dict:
    """The spec fields of the plain version: each kernel's IR, the shapes
    of the program the lowerings run at, the dtype."""
    low = lowerings[0]
    fields = {"kernels": [kernel_ir(x.kernel) for x in lowerings],
              "shapes": {str(t): [int(n) for n in s]
                         for t, s in sorted(low.shapes.items())},
              "dtype": str(low.dtype).split(".")[-1]}
    if low.shape_reads is not low.shapes or low.extents:
        # a data-parallel shard: the global shapes and the local extents
        fields["shape_reads"] = {str(t): [int(n) for n in s]
                                 for t, s in sorted(low.shape_reads.items())}
        fields["extents"] = {str(r): int(n) for r, n in low.extents.items()}
    return fields


def plain_from_fields(fields: dict):
    """The plain version rebuilt from a spec: ``(lowerings of device)``,
    one KernelLowering a kernel, made on first use for each device."""
    from ..backend.torcheval import KernelLowering

    kernels = [read_kernel_ir(text) for text in fields["kernels"]]
    shapes = {int(t): s for t, s in fields["shapes"].items()}
    reads = {int(t): s for t, s in fields.get("shape_reads", {}).items()}
    extents = {int(r): n for r, n in fields.get("extents", {}).items()}
    dtype = getattr(torch, fields["dtype"])
    made: dict = {}

    def lowerings(device):
        got = made.get(device)
        if got is None:
            got = made[device] = [
                KernelLowering(None, k, shapes, dtype, device,
                               shape_reads=reads or None, extents=extents)
                for k in kernels]
        return got

    return lowerings


def run_members(lowerings, out_tids, tensors: dict, epoch: int) -> dict:
    """Kernels one after another through their plain lowering; a tensor a
    member writes that is not in ``tensors`` (a chain's fused-away
    intermediate) starts at the accumulation identity.  Returns
    ``{tid: value}`` of ``out_tids``."""
    local = dict(tensors)
    for low in lowerings:
        write = low.kernel.write
        if write.tensor not in local:
            local[write.tensor] = torch.full(
                tuple(low.shapes[write.tensor]),
                accumulation_identity(write.accumulate), dtype=low.dtype,
                device=low.device)
        local[write.tensor] = low.run_plain(local, epoch)
    return {t: local[t] for t in out_tids}


def register(device, spec: str, kern) -> None:
    """Make ``kern`` the kernel object of ``spec`` on ``device``'s type
    while it lives."""
    _live[(torch.device(device).type, spec)] = kern


def lookup(device, spec: str, rebuild):
    """The kernel object of ``spec`` for tensors on ``device``: the live
    one, or ``rebuild(spec)`` made once and kept.  Keyed by the device's
    type as well: a live object's plain version runs on its executor's
    device."""
    key = (device.type, spec)
    kern = _live.get(key)
    if kern is None:
        kern = _rebuilt.get(key)
        if kern is None:
            kern = _rebuilt[key] = rebuild(spec)
    return kern


def fresh(out: torch.Tensor, inputs) -> torch.Tensor:
    """``out``, copied when it is one of the op's inputs: an op's output
    must not alias an input."""
    if any(out is t for t in inputs):
        return out.clone()
    return out


def counted(name: str, op: str) -> None:
    """Give module ``name`` the attribute ``launches``: the launcher's
    count of op ``op``'s launches (read and written, as a plain counter
    is)."""
    from ..utils import launcher

    class Counted(types.ModuleType):
        @property
        def launches(self) -> int:
            return launcher.count(op)

        @launches.setter
        def launches(self, n: int) -> None:
            launcher.set_count(op, n)

    sys.modules[name].__class__ = Counted


def _first(kind, spec, tensors, n_out, epoch):
    """The CUDA implementation of ``generated_first``: a generated
    kernel's first call on a device, which ``csrc/launch.cpp`` hands back
    to Python because it holds no launch table for it.  Triton compiles
    and launches the kernel through its table in Python, and the table is
    registered, so that later calls launch from C++."""
    from ..utils import launcher, triton_build
    from . import mapreduce, rowchain

    module = {"mapreduce": mapreduce, "rowchain": rowchain}[kind]
    prevs = list(tensors[:n_out])
    device = prevs[0].device
    kern = lookup(device, spec, module.KERNEL.from_spec)
    fresh = kern.fresh if isinstance(kern.fresh, list) else [kern.fresh]
    if kern.dtype not in mapreduce._TL_DTYPE or any(
            p.dtype != kern.dtype for p in prevs):
        raise ValueError(f"the generated kernel cannot store "
                         f"{[p.dtype for p in prevs]}")

    def check(index, t):
        if t.device != device or t.dtype != kern.dtype:
            raise ValueError(
                f"operand t{kern.args[index]} is {t.dtype} on {t.device}; "
                f"the kernel takes {kern.dtype} on {device}")

    outs = [torch.empty_like(p, memory_format=torch.contiguous_format)
            for p in prevs]
    tab = kern.launch_table()
    compiled = launcher.run_table(
        tab, lambda name: triton_build.handle(kern, name), outs,
        [None if f else launcher.aligned(p) for p, f in zip(prevs, fresh)],
        dict(enumerate(tensors)), epoch, check)
    launcher.register(kind, spec, device, tab, compiled, kern.dtype, fresh,
                      triton_build.source_path(kern.source))
    return outs


LIB.define("generated_first(str kind, str spec, Tensor[] tensors, "
           "int n_out, int epoch) -> Tensor[]")
LIB.impl("generated_first", _first, "CUDA")
