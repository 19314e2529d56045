"""The launch path of the generated kernels (B5, B6): launch tables, and
the library that runs them (``exprgrad_torch/csrc/launch.cpp``).

A generated source (``ops/mapreduce.py``, ``ops/rowchain.py``) is
compiled by Triton at its first call on a device, which runs in Python
through Triton's own launcher (:func:`run_table`).  That call hands the
compiled functions and the kernel's *launch table* to the library
(:func:`register`), and every later call of the ops
``exprgrad_torch::mapreduce`` and ``exprgrad_torch::rowchain`` on that
device runs the table in C++: no Python, one ``cuLaunchKernel`` a
function on the current stream.

A launch table is plain data (:func:`table`): the buffers a call
allocates (a split reduction's partials, a scatter's keys, pieces and
counts) and the steps, each a launch (function, grid, warps, argument
slots) or a scatter's grouping.  The slots are read off the generated
function's own parameter list (``out_ptr``, ``prev_ptr``, ``x3_ptr``,
a buffer's ``<name>_ptr``, ``epoch``), so the table and the source
cannot disagree.  Triton appends hidden parameters to every function
(its scratch pointers, two in Triton 3.6): the library passes null for
each, after :func:`check_params` has held the function's parameter sizes
to the slots and found only pointer-sized ones past them, and
:func:`register` has found that the function asks for no scratch.  The
function is Triton's own (``CompiledKernel.function``), loaded in the
device's context by Triton, which also raised its dynamic shared memory
limit where it needs more than 48 KiB; a launch passes the compiled
``shared`` bytes.

Triton specialises a pointer argument on 16-byte alignment.  Every
first launch passes aligned pointers (:func:`aligned`), so the compiled
function assumes them; a later operand or previous value that is not
aligned (a view at an odd offset) is copied first, as one that is not
contiguous is, in both languages.  Nothing falls back: a launch the
driver refuses raises with the generated file's name.

The library is built with the host compiler against PyTorch's headers
into ``build/exprgrad_torch/`` (:func:`exprgrad_torch.utils.kernels.
load_launcher`), on first use; the CPU tests never build it.  The
launch counts of both ops live in it (``ops.mapreduce.launches`` and
``ops.rowchain.launches`` read and write them).
"""

from __future__ import annotations

import ctypes
import re

import torch

OPS = {"mapreduce": 0, "rowchain": 1}
SLOT = {"out": 0, "prev": 1, "op": 2, "buf": 3, "epoch": 4}
STEP = {"launch": 0, "group": 1}
BUFFER = {"empty": 0, "zeros": 1, "made": 2}  # zeros: made once and kept
# c10::ScalarType of the dtypes a table names
SCALAR_TYPE = {torch.int16: 2, torch.int32: 3, torch.int64: 4,
               torch.float32: 6, torch.bfloat16: 15}
POINTER_BYTES = 8
EPOCH_BYTES = 4  # Triton passes an int argument within int32 as i32
ALIGN = 16  # the pointer alignment Triton specialises on

_lib = None
_counts = [0, 0]  # launches counted while the library is not loaded
# (spec, device index) -> {function name: Triton's compiled kernel}: the
# functions a registered table holds (kept alive), their code in ``.asm``
_compiled: dict = {}
_SIGNATURE = re.compile(r"^def (\w+)\(([^)]*)\):", re.M)


def signatures(source: str) -> dict:
    """{function name: [parameter names]} of a generated source."""
    return {name: [p.strip() for p in params.split(",")]
            for name, params in _SIGNATURE.findall(source)}


def slot(param: str, op_index: dict, buffers: list) -> tuple:
    """The slot of one parameter of a generated function: ``out_ptr`` /
    ``o<k>_ptr`` the k-th output, ``prev_ptr`` / ``r<k>_ptr`` its previous
    value, ``x<j>_ptr`` the operand ``op_index[j]`` (its index among the
    op's tensors), ``<buffer>_ptr`` a buffer by name, ``epoch``."""
    if param == "epoch":
        return ("epoch", 0)
    m = re.fullmatch(r"(out|prev|o|r|x)(\d*)_ptr", param)
    if m and (m.group(2) or m.group(1) in ("out", "prev")):
        kind, k = m.group(1), int(m.group(2) or 0)
        if kind == "x":
            return ("op", op_index[k])
        return ("out" if kind in ("out", "o") else "prev", k)
    name = param[:-4] if param.endswith("_ptr") else None
    names = [b["name"] for b in buffers]
    if name not in names:
        raise ValueError(f"parameter {param!r} names no output, operand or "
                         f"buffer of the launch table")
    return ("buf", names.index(name))


def table(source: str, op_index: dict, buffers: list, steps: list) -> dict:
    """A launch table: ``buffers`` (dicts of name, dtype, numel, mode) and
    ``steps``, each ``("launch", function, grid, num_warps)`` or
    ``("group", keys, sorted, perm, offsets, K)`` by buffer name; a
    launch's slots come from the function's parameters in ``source``."""
    sigs = signatures(source)
    names = [b["name"] for b in buffers]
    out = []
    for step in steps:
        if step[0] == "group":
            _, keys, srt, perm, offs, K = step
            out.append({"kind": "group", "keys": names.index(keys),
                        "sorted": names.index(srt), "perm": names.index(perm),
                        "offsets": names.index(offs), "K": int(K)})
            continue
        _, fn, grid, warps = step
        grid = tuple(int(g) for g in (grid if isinstance(grid, (tuple, list))
                                      else (grid,)))
        out.append({"kind": "launch", "fn": fn,
                    "grid": grid + (1,) * (3 - len(grid)),
                    "num_warps": int(warps),
                    "slots": [slot(p, op_index, buffers) for p in sigs[fn]]})
    return {"buffers": buffers, "steps": out}


def check_params(sizes, slots, name: str) -> int:
    """The parameter count of a compiled function whose parameters have
    ``sizes`` bytes, held to its ``slots``: a pointer slot takes 8 bytes,
    the epoch 4, and every parameter past the slots (Triton's hidden
    scratch pointers) is a pointer, passed as null."""
    want = [EPOCH_BYTES if s[0] == "epoch" else POINTER_BYTES for s in slots]
    sizes = [int(s) for s in sizes]
    hidden = sizes[len(want):]
    if sizes[:len(want)] != want or any(h != POINTER_BYTES for h in hidden):
        raise RuntimeError(
            f"the compiled function {name} takes parameters of {sizes} "
            f"bytes; its launch table passes {want} and null pointers past "
            f"them")
    return len(sizes)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and at a 16-byte aligned address (copied when it is
    not), as the compiled functions take every pointer."""
    t = t.contiguous()
    if t.data_ptr() % ALIGN:
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def group_keys(keys: torch.Tensor, K: int) -> tuple:
    """A scatter's grouping of its keys (a launch table's ``group`` step,
    as ``csrc/launch.cpp`` runs it): the keys sorted stably, the
    positions in that order, and each row's segment start for the rows
    0..K (``offsets[K]`` counts the positions kept)."""
    skeys, perm = torch.sort(keys, stable=True)
    rows = torch.arange(K + 1, dtype=keys.dtype, device=keys.device)
    return skeys, perm, torch.searchsorted(
        skeys, rows, out_int32=keys.numel() <= 2 ** 31 - 1)


def encode(tab: dict, functions: dict, names: dict) -> tuple:
    """The flat int64 form of a table that ``egt_gen_register`` reads:
    ``(buffers, steps, step names)``; ``functions`` holds each launch's
    ``(CUfunction handle, threads, shared bytes, parameter count)`` by
    function name, ``names`` each step's name for errors."""
    bufs = []
    for b in tab["buffers"]:
        bufs += [SCALAR_TYPE[b["dtype"]], int(b["numel"]), BUFFER[b["mode"]]]
    steps, labels = [], []
    for step in tab["steps"]:
        if step["kind"] == "group":
            steps += [STEP["group"], step["keys"], step["sorted"],
                      step["perm"], step["offsets"], step["K"]]
            labels.append(names.get("group", "group"))
            continue
        handle, threads, shared, n_params = functions[step["fn"]]
        steps += [STEP["launch"], int(handle), *step["grid"], int(threads),
                  int(shared), int(n_params), len(step["slots"])]
        for kind, index in step["slots"]:
            steps += [SLOT[kind], int(index)]
        labels.append(names[step["fn"]])
    return bufs, steps, "".join(f"{n}\n" for n in labels)


def run_table(tab: dict, handle, outs, prevs, ops, epoch: int,
              check=None) -> dict:
    """Run a launch table in Python, each launch through Triton's launcher
    (``utils/triton_build.py``): a kernel's first call on a device, and
    the CPU tests' emulation.  ``outs`` and ``prevs`` by output (None for
    a fresh one), ``ops`` {op tensor index: tensor}, ``handle(name)`` the
    loaded function; ``check(index, tensor)`` raises for an operand the
    kernel does not take.  Returns the compiled kernels by function
    name."""
    from . import triton_build

    device = outs[0].device
    bufs = []
    for b in tab["buffers"]:
        if b["mode"] == "made":
            bufs.append(None)
        else:
            make = torch.zeros if b["mode"] == "zeros" else torch.empty
            bufs.append(make(int(b["numel"]), dtype=b["dtype"],
                             device=device))
    taken = {}
    compiled = {}
    for step in tab["steps"]:
        if step["kind"] == "group":
            (bufs[step["sorted"]], bufs[step["perm"]],
             bufs[step["offsets"]]) = group_keys(bufs[step["keys"]],
                                                 step["K"])
            continue
        args = []
        for kind, index in step["slots"]:
            if kind == "epoch":
                args.append(int(epoch))
            elif kind == "out":
                args.append(outs[index])
            elif kind == "prev":
                args.append(prevs[index])
            elif kind == "buf":
                args.append(bufs[index])
            else:
                if index not in taken:
                    if check is not None:
                        check(index, ops[index])
                    taken[index] = aligned(ops[index])
                args.append(taken[index])
        compiled[step["fn"]] = triton_build.launch(
            handle(step["fn"]), step["grid"], step["num_warps"], *args)
    return compiled


# --- the library ------------------------------------------------------

def loaded() -> bool:
    return _lib is not None


def load() -> ctypes.CDLL:
    """The launcher library: built on first use, its CUDA implementations
    of the ops registered with the dispatcher, bound once per process."""
    global _lib
    if _lib is None:
        from ..ops import generated, mapreduce, rowchain  # noqa: F401
        from . import kernels

        path = kernels.load_launcher()
        torch.ops.load_library(str(path))
        lib = ctypes.CDLL(str(path))
        lib.egt_gen_driver.restype = ctypes.c_int
        lib.egt_gen_param_sizes.restype = ctypes.c_int
        lib.egt_gen_param_sizes.argtypes = [
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
        lib.egt_gen_register.restype = ctypes.c_int
        lib.egt_gen_register.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_char_p]
        lib.egt_gen_launches.restype = ctypes.c_int64
        lib.egt_gen_launches.argtypes = [ctypes.c_int]
        lib.egt_gen_set_launches.restype = None
        lib.egt_gen_set_launches.argtypes = [ctypes.c_int, ctypes.c_int64]
        lib.egt_gen_registered.restype = ctypes.c_int64
        lib.egt_gen_first_calls.restype = ctypes.c_int64
        missing = lib.egt_gen_driver()
        if missing:
            raise RuntimeError(
                f"the launcher library {path} found no CUDA driver entry "
                f"points (missing bits {missing}: 1 cuLaunchKernel, 2 "
                f"cuFuncGetParamInfo, 4 the context calls)")
        for op, n in enumerate(_counts):
            lib.egt_gen_set_launches(op, n)
        _lib = lib
    return _lib


def count(op: str) -> int:
    if _lib is None:
        return _counts[OPS[op]]
    return int(_lib.egt_gen_launches(OPS[op]))


def set_count(op: str, n: int) -> None:
    if _lib is None:
        _counts[OPS[op]] = int(n)
    else:
        _lib.egt_gen_set_launches(OPS[op], int(n))


def registered() -> int:
    """The (spec, device) tables the library holds."""
    return 0 if _lib is None else int(_lib.egt_gen_registered())


def first_calls() -> int:
    """Calls that found no table (each ran in Python and registered
    one)."""
    return 0 if _lib is None else int(_lib.egt_gen_first_calls())


def compiled_kernels(spec: str, index: int = 0) -> dict:
    """{function name: Triton's compiled kernel} of the table registered
    for ``spec`` on CUDA device ``index`` (its PTX in ``.asm["ptx"]``),
    or {}."""
    return _compiled.get((spec, index), {})


def param_sizes(handle: int, cap: int = 256) -> list:
    sizes = (ctypes.c_int64 * cap)()
    n = load().egt_gen_param_sizes(int(handle), sizes, cap)
    if n < 0:
        raise RuntimeError("the CUDA driver has no cuFuncGetParamInfo")
    return list(sizes[:n])


def register(op: str, spec: str, device, tab: dict, compiled: dict,
             dtype, fresh, path) -> None:
    """Hand the library the table of ``spec`` on ``device`` with the
    functions Triton compiled for it; later calls launch from C++."""
    lib = load()
    functions, names = {}, {"group": f"{path}: the grouping of the keys"}
    for step in tab["steps"]:
        if step["kind"] != "launch":
            continue
        fn = step["fn"]
        ck = compiled[fn]
        md = ck.metadata
        names[fn] = f"{path}:{fn}"
        extra = {k: getattr(md, k, 0) for k in (
            "global_scratch_size", "profile_scratch_size")}
        if any(extra.values()) or getattr(md, "num_ctas", 1) != 1 or \
                getattr(md, "launch_cooperative_grid", False) or \
                getattr(md, "launch_pdl", False):
            raise RuntimeError(
                f"the compiled function {names[fn]} needs a launch the "
                f"launcher does not make ({extra}, num_ctas "
                f"{getattr(md, 'num_ctas', 1)})")
        if md.num_warps != step["num_warps"]:
            raise RuntimeError(f"{names[fn]} compiled for {md.num_warps} "
                               f"warps, its table launches "
                               f"{step['num_warps']}")
        n_params = check_params(param_sizes(ck.function), step["slots"],
                                names[fn])
        functions[fn] = (ck.function, 32 * md.num_warps, md.shared,
                         n_params)
    bufs, steps, labels = encode(tab, functions, names)
    index = torch.device(device).index or 0
    _compiled[(spec, index)] = dict(compiled)

    def arr(values):
        return (ctypes.c_int64 * max(len(values), 1))(*values)

    fresh = [int(bool(f)) for f in fresh]
    raw = spec.encode("ascii")
    err = lib.egt_gen_register(
        raw, len(raw), index, SCALAR_TYPE[dtype],
        len(fresh), arr(fresh), arr(bufs), len(tab["buffers"]), arr(steps),
        len(steps), labels.encode())
    if err:
        raise RuntimeError(f"the launcher refused the table of {path} "
                           f"(code {err})")
