"""Checkpoints of port models, in the JAX package's formats.

Counterpart of ``exprgrad_tpu/io/serialize.py``, with its own copy of the
format code: a checkpoint is the *source IR program* plus parameter and
optimizer-cache tensors, the epoch and the host random stream, closed by
a CRC32 trailer; the program is recompiled on load.  A checkpoint written
by either package loads in the other.  The port's state is torch tensors
on a device: writing copies it to the host, loading puts it on the
``device`` asked for.

Loading a model executes its compiled program — do not load models from
untrusted sources.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import BinaryIO, Optional

import numpy as np

from .. import ir
from ..errors import ModelRuntimeError

MAGIC = b"EGTPU\x08\n"
_MAGIC_V7 = b"EGTPU\x07\n"  # pre-RNG-state format: still loadable
_MAGIC_V6 = b"EGTPU\x06\n"  # pre-CRC format: rejected with a clear error


class _CrcStream:
    """Wrap a binary stream, folding every byte written/read into a
    CRC32 (IEEE, as the JAX package's native codec computes it) —
    checkpoint files carry the CRC as a 4-byte little-endian trailer so
    load_model detects bit-rot/truncation instead of deserializing
    garbage."""

    def __init__(self, stream):
        self.stream = stream
        self.crc = 0

    def write(self, data):
        self.crc = zlib.crc32(bytes(data), self.crc)
        return self.stream.write(data)

    def read(self, n=-1):
        data = self.stream.read(n)
        self.crc = zlib.crc32(data, self.crc)
        return data


class Writer:
    def __init__(self, stream: BinaryIO) -> None:
        self.stream = stream

    def u8(self, v: int) -> None:
        self.stream.write(struct.pack("<B", v))

    def i64(self, v: int) -> None:
        self.stream.write(struct.pack("<q", v))

    def f64(self, v: float) -> None:
        self.stream.write(struct.pack("<d", v))

    def boolean(self, v: bool) -> None:
        self.u8(1 if v else 0)

    def string(self, v: str) -> None:
        data = v.encode("utf-8")
        self.i64(len(data))
        self.stream.write(data)

    def opt_int(self, v: Optional[int]) -> None:
        if v is None:
            self.boolean(False)
        else:
            self.boolean(True)
            self.i64(v)

    def int_list(self, vs) -> None:
        self.i64(len(vs))
        for v in vs:
            self.i64(v)

    def tensor(self, arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(arr)
        # extension dtypes (ml_dtypes bfloat16 etc.) stringify as raw
        # void ("<V2") through .str, which loses the type on reload;
        # their .name ("bfloat16") round-trips through np.dtype()
        tag = arr.dtype.str
        if "V" in tag:
            tag = arr.dtype.name
        self.string(tag)
        self.int_list(arr.shape)
        data = arr.tobytes()
        self.i64(len(data))
        self.stream.write(data)


class Reader:
    def __init__(self, stream: BinaryIO) -> None:
        self.stream = stream

    def _read(self, n: int) -> bytes:
        data = self.stream.read(n)
        if len(data) != n:
            raise ModelRuntimeError("truncated model file")
        return data

    def u8(self) -> int:
        return struct.unpack("<B", self._read(1))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self._read(8))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self._read(8))[0]

    def boolean(self) -> bool:
        return self.u8() != 0

    def string(self) -> str:
        return self._read(self.i64()).decode("utf-8")

    def opt_int(self) -> Optional[int]:
        return self.i64() if self.boolean() else None

    def int_list(self) -> list[int]:
        return [self.i64() for _ in range(self.i64())]

    def tensor(self) -> np.ndarray:
        dtype = np.dtype(self.string())
        shape = self.int_list()
        data = self._read(self.i64())
        return np.frombuffer(data, dtype=dtype).reshape(shape).copy()


# --- IR serialization ------------------------------------------------------

_OPS = list(ir.Op)
_OP_IDX = {op: i for i, op in enumerate(_OPS)}


def _r_op(r: Reader) -> ir.Op:
    """Decode an opcode through the file's own op-name table.

    The table is written by write_program, so inserting/reordering Op enum
    members cannot silently remap opcodes in old checkpoints: decode goes
    byte -> recorded name -> current Op, and an op that no longer exists
    raises instead of executing the wrong program.
    """
    code = r.u8()
    table = getattr(r, "op_table", _OPS)
    if code >= len(table):
        raise ValueError(f"corrupt checkpoint: opcode {code} out of range")
    return table[code]


def _w_instr(w: Writer, instr: ir.Instr) -> None:
    w.u8(_OP_IDX[instr.op])
    w.int_list(instr.args)
    w.opt_int(instr.res)
    w.opt_int(instr.tensor)
    w.i64(instr.index_lit)
    w.f64(instr.scalar_lit)
    w.boolean(instr.bool_lit)
    w.i64(instr.dim)
    w.string(instr.label)


def _r_instr(r: Reader) -> ir.Instr:
    return ir.Instr(
        op=_r_op(r),
        args=r.int_list(),
        res=r.opt_int(),
        tensor=r.opt_int(),
        index_lit=r.i64(),
        scalar_lit=r.f64(),
        bool_lit=r.boolean(),
        dim=r.i64(),
        label=r.string(),
    )


def _w_linear(w: Writer, index: ir.LinearIndex) -> None:
    w.i64(len(index.setup))
    for instr in index.setup:
        _w_instr(w, instr)
    w.i64(len(index.factors))
    for reg in sorted(index.factors):
        w.i64(reg)
        w.i64(index.factors[reg])
    w.i64(index.constant)


def _r_linear(r: Reader) -> ir.LinearIndex:
    setup = [_r_instr(r) for _ in range(r.i64())]
    factors = {}
    for _ in range(r.i64()):
        reg = r.i64()
        factors[reg] = r.i64()
    return ir.LinearIndex(setup=setup, factors=factors, constant=r.i64())


def _w_loop(w: Writer, loop: ir.Loop) -> None:
    w.i64(loop.iter_reg)
    w.u8(int(loop.mode))
    w.boolean(loop.has_bounds)
    _w_linear(w, loop.start)
    _w_linear(w, loop.stop)
    w.i64(loop.step)
    w.i64(loop.schedule.tile_size)
    w.boolean(loop.schedule.tile)
    w.boolean(loop.schedule.parallel)
    w.boolean(loop.schedule.share_cache)


def _r_loop(r: Reader) -> ir.Loop:
    loop = ir.Loop(iter_reg=r.i64())
    loop.mode = ir.LoopMode(r.u8())
    loop.has_bounds = r.boolean()
    loop.start = _r_linear(r)
    loop.stop = _r_linear(r)
    loop.step = r.i64()
    loop.schedule.tile_size = r.i64()
    loop.schedule.tile = r.boolean()
    loop.schedule.parallel = r.boolean()
    loop.schedule.share_cache = r.boolean()
    return loop


def _w_tensor_op(w: Writer, op: Optional[ir.TensorOp]) -> None:
    w.boolean(op is not None)
    if op is None:
        return
    w.i64(op.tensor)
    w.i64(len(op.dims))
    for dim in op.dims:
        _w_linear(w, dim)
    w.opt_int(op.data)
    w.boolean(op.is_raw)
    w.string(op.accumulate)
    w.boolean(op.schedule.cache)


def _r_tensor_op(r: Reader) -> Optional[ir.TensorOp]:
    if not r.boolean():
        return None
    op = ir.TensorOp(tensor=r.i64())
    op.dims = [_r_linear(r) for _ in range(r.i64())]
    op.data = r.opt_int()
    op.is_raw = r.boolean()
    op.accumulate = r.string()
    op.schedule.cache = r.boolean()
    return op


_ATTR_CODECS = {
    # tag -> (type check, write, read)
    0: (bool, lambda w, v: w.boolean(v), lambda r: r.boolean()),
    1: (int, lambda w, v: w.i64(v), lambda r: r.i64()),
    2: (float, lambda w, v: w.f64(v), lambda r: r.f64()),
    3: (str, lambda w, v: w.string(v), lambda r: r.string()),
}


def _w_attrs(w: Writer, attrs: dict) -> None:
    w.i64(len(attrs))
    for key in sorted(attrs):
        w.string(key)
        value = attrs[key]
        for tag, (typ, write, _read) in _ATTR_CODECS.items():
            if type(value) is typ:
                w.u8(tag)
                write(w, value)
                break
        else:
            raise ModelRuntimeError(
                f"extern attr {key!r} has unserializable type "
                f"{type(value).__name__} (use bool/int/float/str)"
            )


def _r_attrs(r: Reader) -> dict:
    out = {}
    for _ in range(r.i64()):
        key = r.string()
        tag = r.u8()
        if tag not in _ATTR_CODECS:
            raise ModelRuntimeError(
                f"corrupt checkpoint: extern attr {key!r} has unknown "
                f"type tag {tag} (written by an incompatible version?)"
            )
        out[key] = _ATTR_CODECS[tag][2](r)
    return out


def _w_extern(w: Writer, ext: Optional[ir.Extern]) -> None:
    w.boolean(ext is not None)
    if ext is None:
        return
    w.string(ext.name)
    w.int_list(ext.inputs)
    w.i64(ext.out_index)
    w.i64(ext.nout)
    _w_attrs(w, ext.attrs)


def _r_extern(r: Reader) -> Optional[ir.Extern]:
    if not r.boolean():
        return None
    return ir.Extern(
        name=r.string(),
        inputs=r.int_list(),
        out_index=r.i64(),
        nout=r.i64(),
        attrs=_r_attrs(r),
    )


def _w_kernel(w: Writer, kernel: ir.Kernel) -> None:
    gen = kernel.generator
    w.string(gen.kind.value)
    w.opt_int(gen.tensor)
    w.int_list(gen.reshape)
    w.i64(len(kernel.regs))
    for reg in kernel.regs:
        w.string(reg.name)
    w.i64(len(kernel.setup))
    for instr in kernel.setup:
        _w_instr(w, instr)
    w.i64(len(kernel.loops))
    for loop in kernel.loops:
        _w_loop(w, loop)
    w.i64(len(kernel.reads))
    for read in kernel.reads:
        _w_tensor_op(w, read)
    w.i64(len(kernel.expr.instrs))
    for instr in kernel.expr.instrs:
        _w_instr(w, instr)
    w.opt_int(kernel.expr.res)
    _w_tensor_op(w, kernel.write)
    _w_extern(w, kernel.extern)
    w.boolean(kernel.remat)
    w.opt_int(kernel.remat_anchor)
    w.boolean(kernel.custom_grad is not None)
    if kernel.custom_grad is not None:
        cg = kernel.custom_grad
        w.i64(len(cg.kernels))
        for sub in cg.kernels:
            _w_kernel(w, sub)
        w.i64(len(cg.grad_placeholders))
        for tid in sorted(cg.grad_placeholders):
            w.i64(tid)
            w.i64(cg.grad_placeholders[tid])
        w.i64(len(cg.subs))
        for tid in sorted(cg.subs):
            w.i64(tid)
            w.i64(cg.subs[tid])


def _r_kernel(r: Reader) -> ir.Kernel:
    kernel = ir.Kernel()
    kernel.generator = ir.Generator(
        kind=ir.GenKind(r.string()), tensor=r.opt_int(), reshape=r.int_list()
    )
    kernel.regs = [ir.Register(name=r.string()) for _ in range(r.i64())]
    kernel.setup = [_r_instr(r) for _ in range(r.i64())]
    kernel.loops = [_r_loop(r) for _ in range(r.i64())]
    kernel.reads = [_r_tensor_op(r) for _ in range(r.i64())]
    kernel.expr.instrs = [_r_instr(r) for _ in range(r.i64())]
    kernel.expr.res = r.opt_int()
    kernel.write = _r_tensor_op(r)
    kernel.extern = _r_extern(r)
    kernel.remat = r.boolean()
    kernel.remat_anchor = r.opt_int()
    if r.boolean():
        cg = ir.CustomGrad()
        cg.kernels = [_r_kernel(r) for _ in range(r.i64())]
        for _ in range(r.i64()):
            tid = r.i64()
            cg.grad_placeholders[tid] = r.i64()
        for _ in range(r.i64()):
            tid = r.i64()
            cg.subs[tid] = r.i64()
        kernel.custom_grad = cg
    return kernel


def _w_shape_constraint(w: Writer, constr: ir.ShapeConstraint) -> None:
    w.string(constr.kind.value)
    w.i64(constr.dest)
    w.u8(int(constr.priority))
    w.i64(constr.rank)
    w.i64(len(constr.dims))
    for dim in constr.dims:
        _w_linear(w, dim)
    w.i64(len(constr.reads))
    for tid in sorted(constr.reads):
        w.i64(tid)
        per_dim = constr.reads[tid]
        w.i64(len(per_dim))
        for indices in per_dim:
            w.i64(len(indices))
            for index in indices:
                _w_linear(w, index)
    w.i64(len(constr.write))
    for index in constr.write:
        _w_linear(w, index)
    w.opt_int(constr.src)


def _r_shape_constraint(r: Reader) -> ir.ShapeConstraint:
    constr = ir.ShapeConstraint(
        kind=ir.ShapeConstrKind(r.string()), dest=r.i64()
    )
    constr.priority = ir.ShapeConstrPriority(r.u8())
    constr.rank = r.i64()
    constr.dims = [_r_linear(r) for _ in range(r.i64())]
    for _ in range(r.i64()):
        tid = r.i64()
        constr.reads[tid] = [
            [_r_linear(r) for _ in range(r.i64())] for _ in range(r.i64())
        ]
    constr.write = [_r_linear(r) for _ in range(r.i64())]
    constr.src = r.opt_int()
    return constr


def write_program(w: Writer, program: ir.Program) -> None:
    # Opcode table: per-instr opcodes are u8 indices into THIS list of op
    # names, recorded in the file so the wire format survives Op enum
    # insertion/reordering (names are the stable identity, not positions).
    assert len(_OPS) <= 255, "opcode byte overflow; widen the opcode field"
    w.i64(len(_OPS))
    for op in _OPS:
        w.string(op.value)
    w.i64(len(program.tensors))
    for tensor in program.tensors:
        w.string(tensor.kind.value)
        w.int_list(tensor.shape)
        w.string(tensor.name)
        w.f64(tensor.init_range[0])
        w.f64(tensor.init_range[1])
        w.f64(tensor.random_range[0])
        w.f64(tensor.random_range[1])
        w.opt_int(tensor.cache_of)
        w.boolean(tensor.remat)
    w.i64(len(program.inputs))
    for name in sorted(program.inputs):
        w.string(name)
        w.i64(program.inputs[name])
    w.int_list(program.params)
    w.int_list(program.caches)
    w.string(program.scalar_type.value)
    w.i64(len(program.targets))
    for name in sorted(program.targets):
        target = program.targets[name]
        w.string(name)
        w.opt_int(target.output)
        w.int_list(sorted(target.tensors))
        w.i64(len(target.shapes))
        for constr in target.shapes:
            _w_shape_constraint(w, constr)
        w.i64(len(target.kernels))
        for kernel in target.kernels:
            _w_kernel(w, kernel)


def read_program(r: Reader) -> ir.Program:
    table = []
    for _ in range(r.i64()):
        name = r.string()
        try:
            table.append(ir.Op(name))
        except ValueError:
            raise ValueError(
                f"checkpoint uses unknown IR op {name!r}; it was written by "
                "an incompatible exprgrad_tpu version"
            ) from None
    r.op_table = table
    program = ir.Program()
    for _ in range(r.i64()):
        tensor = ir.TensorDef(kind=ir.TensorKind(r.string()))
        tensor.shape = r.int_list()
        tensor.name = r.string()
        tensor.init_range = (r.f64(), r.f64())
        tensor.random_range = (r.f64(), r.f64())
        tensor.cache_of = r.opt_int()
        tensor.remat = r.boolean()
        program.tensors.append(tensor)
    for _ in range(r.i64()):
        name = r.string()
        program.inputs[name] = r.i64()
    program.params = r.int_list()
    program.caches = r.int_list()
    program.scalar_type = ir.ScalarType(r.string())
    for _ in range(r.i64()):
        name = r.string()
        target = ir.Target(name=name)
        target.output = r.opt_int()
        target.tensors = set(r.int_list())
        target.shapes = [_r_shape_constraint(r) for _ in range(r.i64())]
        target.kernels = [_r_kernel(r) for _ in range(r.i64())]
        program.targets[name] = target
    return program


# --- public API ------------------------------------------------------------

def save_program(program: ir.Program, path: str) -> None:
    with open(path, "wb") as f:
        f.write(MAGIC)
        write_program(Writer(f), program)


def load_program(path: str) -> ir.Program:
    with open(path, "rb") as f:
        head = f.read(len(MAGIC))
        # program payloads are identical across v7/v8 (the bump only
        # added the model checkpoint's RNG-state block)
        if head not in (MAGIC, _MAGIC_V7):
            raise ModelRuntimeError(f"{path} is not an exprgrad-tpu file")
        return read_program(Reader(f))


def export_params_npz(model, path: str) -> None:
    """Every parameter and cache as a named array in a ``.npz``, under
    the JAX package's names: ``"<name>#<tensor id>"``, caches prefixed
    ``"cache:"``."""
    arrays = {}
    for tid, val in model.params.items():
        name = model.program.tensors[tid].name or "param"
        arrays[f"{name}#{tid}"] = val.cpu().numpy()
    for tid, val in model.caches.items():
        name = model.program.tensors[tid].name or "cache"
        arrays[f"cache:{name}#{tid}"] = val.cpu().numpy()
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def import_params_npz(model, path: str) -> None:
    """Load arrays written by :func:`export_params_npz` (of either
    package) into a model compiled from the same program; names, ids and
    shapes must match."""
    with np.load(path) as data:
        for key in data.files:
            name, sep, tid_s = key.rpartition("#")
            if not sep or not tid_s.isdigit():
                raise ModelRuntimeError(
                    f"npz entry {key!r} was not written by "
                    "export_params_npz (expected '<name>#<tensor id>')"
                )
            tid = int(tid_s)
            table = model.caches if name.startswith("cache:") else model.params
            if tid not in table:
                raise ModelRuntimeError(
                    f"npz entry {key!r} has no matching tensor in this "
                    "model (was it compiled from the same program?)"
                )
            want = tuple(table[tid].shape)
            if tuple(data[key].shape) != want:
                raise ModelRuntimeError(
                    f"npz entry {key!r} has shape {data[key].shape}, "
                    f"model expects {want}"
                )
            table[tid] = model._to_device(data[key])


def save_model(model, path: str) -> None:
    """Checkpoint = source program + params + caches + epoch + the host
    random stream, closed by a CRC32 trailer of the payload."""
    with open(path, "wb") as f:
        f.write(MAGIC)
        cs = _CrcStream(f)
        w = Writer(cs)
        write_program(w, model.source)
        w.i64(model.epoch)
        for table in (model.params, model.caches):
            w.i64(len(table))
            for tid in sorted(table):
                w.i64(tid)
                w.tensor(table[tid].cpu().numpy())
        w.string(json.dumps(model._rng.bit_generator.state))
        f.write(struct.pack("<I", cs.crc & 0xFFFFFFFF))


def load_model(path: str, device="cuda"):
    """Reload a checkpoint of either package as a port model on
    ``device``; the program is recompiled."""
    from ..model import from_state

    with open(path, "rb") as f:
        head = f.read(len(MAGIC))
        if head == _MAGIC_V6:
            raise ModelRuntimeError(
                f"{path} is a v6 checkpoint (pre-CRC format); re-save it "
                "with this version"
            )
        if head not in (MAGIC, _MAGIC_V7):
            raise ModelRuntimeError(f"{path} is not an exprgrad-tpu file")
        cs = _CrcStream(f)
        r = Reader(cs)
        rng_state = None
        try:
            source = read_program(r)
            epoch = r.i64()
            tables = []
            for _ in range(2):
                table = {}
                for _ in range(r.i64()):
                    tid = r.i64()
                    table[tid] = r.tensor()
                tables.append(table)
            if head == MAGIC:  # v8+: host RNG stream
                rng_state = json.loads(r.string())
        except (MemoryError, OverflowError, ValueError,
                TypeError) as err:
            # a corrupted length/shape field can demand an absurd
            # allocation before the CRC trailer is ever reached
            raise ModelRuntimeError(
                f"{path} is corrupted (invalid structure while reading: "
                f"{type(err).__name__})"
            ) from err
        trailer = f.read(4)
        if len(trailer) != 4 or struct.unpack("<I", trailer)[0] != (
            cs.crc & 0xFFFFFFFF
        ):
            raise ModelRuntimeError(
                f"{path} failed its CRC32 integrity check (truncated or "
                "corrupted checkpoint)"
            )
    model = from_state(source, tables[0], tables[1], epoch, device=device)
    if rng_state is not None:
        try:
            model._rng.bit_generator.state = rng_state
        except (ValueError, TypeError, KeyError) as err:
            raise ModelRuntimeError(
                f"{path} carries an RNG state this numpy cannot restore "
                f"({type(err).__name__}: {err})"
            ) from err
    return model
