"""Port parity: scheduled contractions through kernel B1
(exprgrad_torch/ops/matmul.py, exprgrad_torch/backend/scheduled.py).

* ``matmul_plain`` against the JAX package's ``_matmul_impl`` run in
  interpret mode, for plain, ragged and transposed stores and each extra
  operand pattern; float32 at ``rtol=1e-4, atol=1e-5`` (the JAX kernel
  accumulates in float32, the plain version in float64).
* The epilogue compiler: the golden program of dense+bias+relu, and a
  chain holding an op outside the epilogue set, which does not fold.
* The scheduled programs of tests/test_pallas.py, test_pallas_fusion.py
  and test_pallas_fusion_chains.py, built once with each package's
  builders and compiled with ``schedule_mode="force"`` in both: outputs
  and gradients agree (float32 ``rtol=1e-4, atol=1e-5``; float64
  ``rtol=1e-10``) and the lowering stats map one to one (``pallas`` to
  ``matmul``, ``pallas-fused`` to ``matmul-fused``; ``schedule-fallback``
  equal), as do the classifiers' decline reasons.
* ``scheduled_matmul``'s gradients against ``jax.grad`` of
  ``pallas_matmul``, and two train steps of the scheduled MLP.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exprgrad_torch as egt
import exprgrad_torch.layers
import exprgrad_tpu
import exprgrad_tpu.layers
from chip_smoke import epilogue as _prog, scheduled_mlp
from exprgrad_torch.backend.scheduled import ScheduledMatmul
from exprgrad_torch.backend.torcheval import KernelLowering
from exprgrad_torch.ops.matmul import (matmul_impl, matmul_plain,
                                       scheduled_matmul)
from exprgrad_tpu import compile
from exprgrad_tpu.backend.jaxeval import KernelLowering as JaxLowering
from exprgrad_tpu.backend.pallasgen import PallasMatmul
from exprgrad_tpu.ops.matmul import _matmul_impl, pallas_matmul

F32 = dict(rtol=1e-4, atol=1e-5)
F64 = dict(rtol=1e-10, atol=1e-12)
STAT_NAMES = {"pallas": "matmul", "pallas-fused": "matmul-fused"}

pytestmark = pytest.mark.filterwarnings(
    "ignore::exprgrad_tpu.ScheduleWarning",
    "ignore::exprgrad_torch.ScheduleWarning",
)


# --- the kernel's plain version against the Pallas kernel -------------

# (port program, JAX closure, extra patterns)
EPILOGUES = {
    "none": (None, None, ()),
    "bias_relu": (
        _prog([("extra", 1, 0, 0, 0), ("add", 2, 0, 1, 0),
               ("const", 3, 0, 0, 0), ("lt", 4, 3, 2, 0),
               ("select", 5, 4, 2, 3), ("mov", 0, 5, 0, 0)],
              consts=(0.0,), patterns=("row",)),
        lambda acc, row: jnp.where(0.0 < acc + row, acc + row, 0.0),
        ("row",)),
    "col_exp_residual": (
        _prog([("extra", 1, 0, 0, 0), ("sub", 2, 0, 1, 0),
               ("const", 3, 0, 0, 0), ("mul", 4, 2, 3, 0),
               ("exp", 5, 4, 0, 0), ("extra", 6, 1, 0, 0),
               ("add", 0, 5, 6, 0)],
              consts=(0.01,), patterns=("col", "full")),
        lambda acc, col, res: jnp.exp((acc - col) * 0.01) + res,
        ("col", "full")),
    "leaky_select": (
        _prog([("const", 1, 0, 0, 0), ("lt", 2, 0, 1, 0),
               ("const", 3, 1, 0, 0), ("mul", 4, 0, 3, 0),
               ("select", 0, 2, 4, 0)], consts=(0.0, 0.1)),
        lambda acc: jnp.where(acc < 0.0, acc * 0.1, acc),
        ()),
}


def _extras(rng, patterns, rows, cols):
    shapes = {"row": (1, cols), "col": (rows, 1), "full": (rows, cols)}
    return [rng.normal(size=shapes[p]).astype(np.float32) for p in patterns]


@pytest.mark.parametrize("shape", [(64, 128, 96), (30, 50, 70)],
                         ids=["aligned", "ragged"])
@pytest.mark.parametrize("transpose", [False, True],
                         ids=["store", "transposed"])
@pytest.mark.parametrize("epilogue", sorted(EPILOGUES))
def test_plain_matches_pallas_kernel(shape, transpose, epilogue):
    m, k, n = shape
    rng = np.random.default_rng(m + k + n)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    prog, fn, patterns = EPILOGUES[epilogue]
    rows, cols = (n, m) if transpose else (m, n)
    extra = _extras(rng, patterns, rows, cols)
    want = _matmul_impl(
        jnp.asarray(a), jnp.asarray(b), block_m=m, block_n=n, block_k=k,
        interpret=True, epilogue=fn,
        extra=tuple((jnp.asarray(x), p) for x, p in zip(extra, patterns)),
        transpose_out=transpose)
    got = matmul_plain(torch.from_numpy(a), torch.from_numpy(b),
                       epilogue=prog,
                       extra=[torch.from_numpy(x) for x in extra],
                       transpose_out=transpose)
    assert got.dtype == torch.float32 and tuple(got.shape) == (rows, cols)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # on CPU tensors the wrapper is the plain version
    again = matmul_impl(torch.from_numpy(a), torch.from_numpy(b),
                        epilogue=prog,
                        extra=[torch.from_numpy(x) for x in extra],
                        transpose_out=transpose)
    assert torch.equal(again, got)


def test_wrapper_checks_its_operands():
    a, b = torch.ones(4, 3), torch.ones(5, 2)
    with pytest.raises(ValueError, match="contraction mismatch"):
        matmul_plain(a, b)
    prog = EPILOGUES["bias_relu"][0]
    with pytest.raises(ValueError, match="extra operands"):
        matmul_plain(a, torch.ones(3, 2), epilogue=prog)
    with pytest.raises(ValueError, match="pattern 'row'"):
        matmul_plain(a, torch.ones(3, 2), epilogue=prog,
                     extra=[torch.ones(3)])


def test_epilogue_travels_as_the_ops_flat_arguments():
    """An epilogue crosses ``exprgrad_torch::matmul`` as flat ints and
    floats and comes back whole; the kernel's packed program holds each
    step as ``op | dst << 8, a, b, c``, the constants and the extras'
    pattern indices (the pointers are filled in per launch)."""
    from exprgrad_torch.ops.matmul import PATTERNS, Epilogue, _program

    prog = EPILOGUES["bias_relu"][0]
    code, consts, patterns = prog.flat
    assert Epilogue.from_flat(code, consts, patterns) == prog
    assert Epilogue.from_flat([], [], []) is None
    packed = _program(tuple(code), tuple(consts), tuple(patterns))
    assert packed is _program(tuple(code), tuple(consts), tuple(patterns))
    assert (packed.n_code, packed.n_extra) == (len(prog.code), 0)
    for i, (op, dst, a, b, c) in enumerate(prog.code):
        assert list(packed.code[i]) == [op | (dst << 8), a, b, c]
    assert list(packed.consts[:len(consts)]) == pytest.approx(consts)
    assert [PATTERNS[p] for p in packed.extra_pattern[:len(patterns)]] == \
        list(prog.patterns)
    with pytest.raises(ValueError, match="tables"):
        _program((0, 0, 0, 0, 0) * 65, (), ())


def test_scheduled_matmul_grads_match_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(64, 128)).astype(np.float32)
    b = rng.normal(size=(128, 96)).astype(np.float32)

    def loss(x, y):
        return jnp.sum(pallas_matmul(x, y, block_m=64, block_n=96,
                                     block_k=128, interpret=True) ** 2)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out = scheduled_matmul(ta, tb)
    np.testing.assert_allclose(out.detach().numpy(), a @ b, **F32)
    (out ** 2).sum().backward()
    for got, ref in ((ta.grad, want[0]), (tb.grad, want[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-3)


# --- the scheduled programs, built by each package -----------------------

def _matmul(m, schedule, shape, seed):
    y, x, it = m.iters("y", "x", "it")
    c = m.Fun("c")
    a, b = m.input("a"), m.input("b")
    c[y, x] = a[y, it] * b[it, x]
    c.schedule(**schedule)
    rng = np.random.default_rng(seed)
    (mm, k, n) = shape
    return c, {"a": rng.normal(size=(mm, k)).astype(np.float32),
               "b": rng.normal(size=(k, n)).astype(np.float32)}


def _cache_hint(m):
    y, x, it = m.iters("y", "x", "it")
    c = m.Fun("c")
    a, b = m.input("a"), m.input("b")
    c[y, x] = a[y, it] * b[it, x]
    c.schedule(cache=[a, b])
    rng = np.random.default_rng(2)
    return c, {"a": rng.normal(size=(32, 128)).astype(np.float32),
               "b": rng.normal(size=(128, 128)).astype(np.float32)}


TILE = dict(tile={"y": 64, "x": 128, "it": 128}, parallel=["y", "x"])


def _data(seed, m=64, k=128, n=128, extras=()):
    rng = np.random.default_rng(seed)
    out = {"a": rng.normal(size=(m, k)).astype(np.float32),
           "b": rng.normal(size=(k, n)).astype(np.float32)}
    for name, shape in extras:
        out[name] = rng.normal(size=shape).astype(np.float32)
    return out


def _scheduled_c(m, tile=TILE, transposed=False):
    y, x, it = m.iters("y", "x", "it")
    a, b = m.input("a"), m.input("b")
    c = m.Fun("c")
    if transposed:
        c[x, y] = a[y, it] * b[it, x]
    else:
        c[y, x] = a[y, it] * b[it, x]
    c.schedule(**tile)
    return c


def _dense_bias_relu(m):
    c = _scheduled_c(m, dict(tile={"y": 64, "x": 128, "it": 128},
                             parallel=["y", "x"]))
    y2, x2 = m.iters("y2", "x2")
    d = m.Fun("d")
    d[y2, x2] = m.maximum(c[y2, x2] + m.input("bias")[x2], 0.0)
    return d, _data(0, m=128, k=256, n=256, extras=[("bias", (256,))])


def _col_residual(m):
    c = _scheduled_c(m)
    y2, x2 = m.iters("y2", "x2")
    d = m.Fun("d")
    d[y2, x2] = (m.exp((c[y2, x2] - m.input("col")[y2]) * 0.01)
                 + m.input("res")[y2, x2])
    return d, _data(3, m=128, k=128, n=256,
                    extras=[("col", (128,)), ("res", (128, 256))])


def _reused_intermediate(m):
    c = _scheduled_c(m)
    y2, x2 = m.iters("y2", "x2")
    d = m.Fun("d")
    d[y2, x2] = m.maximum(c[y2, x2], 0.0)
    y3, x3 = m.iters("y3", "x3")
    e = m.Fun("e")
    e[y3, x3] = d[y3, x3] + c[y3, x3]
    return e, _data(4, m=128, k=128, n=256)


def _output_is_matmul(m):
    return _scheduled_c(m), _data(5, m=128, k=128, n=256)


def _select_epilogue(m):
    c = _scheduled_c(m)
    y2, x2 = m.iters("y2", "x2")
    d = m.Fun("d")
    d[y2, x2] = m.select(c[y2, x2] < 0.0, c[y2, x2] * 0.1, c[y2, x2])
    return d, _data(7, m=64, k=128, n=128)


def _bias_writer_relu(m):
    c = _scheduled_c(m)
    y2, x2 = m.iters("y2", "x2")
    c[y2, x2] = m.input("bias")[x2]
    i = m.iters("i")
    r = m.Fun("r")
    r.raw[i] = m.select(c.raw[i] >= 0.0, c.raw[i], 0.0)
    r.copy_shape(c)
    return r, _data(0, extras=[("bias", (128,))])


def _three_step_chain(m):
    c = _scheduled_c(m)
    y2, x2 = m.iters("y2", "x2")
    d = m.Fun("d")
    d[y2, x2] = c[y2, x2] + m.input("bias")[x2]
    i = m.iters("i")
    r = m.Fun("r")
    r.raw[i] = m.select(d.raw[i] >= 0.0, d.raw[i], 0.1 * d.raw[i])
    r.copy_shape(d)
    y3, x3 = m.iters("y3", "x3")
    e = m.Fun("e")
    e[y3, x3] = r[y3, x3] + m.input("res")[y3, x3]
    return e, _data(1, extras=[("bias", (128,)), ("res", (64, 128))])


def _dense_kernel0(m):
    h = m.layers.dense(m.input("a"), 128, 128).schedule(kernel=0, **TILE)
    rng = np.random.default_rng(2)
    return (m.layers.relu(h),
            {"a": rng.normal(size=(64, 128)).astype(np.float32)})


def _transposed_plain(m):
    return _scheduled_c(m, transposed=True), _data(3)


def _transposed_epilogue(m):
    c = _scheduled_c(m, transposed=True)
    p, q = m.iters("p", "q")
    d = m.Fun("d")
    d[p, q] = m.maximum(c[p, q] + m.input("rowm")[q], 0.0)
    return d, _data(4, extras=[("rowm", (64,))])


def _chain_stops_at_reuse(m):
    c = _scheduled_c(m)
    y2, x2 = m.iters("y2", "x2")
    r = m.Fun("r")
    r[y2, x2] = m.maximum(c[y2, x2], 0.0)
    y3, x3 = m.iters("y3", "x3")
    z = m.Fun("z")
    z[y3, x3] = r[y3, x3] * r[y3, x3]
    y4, x4 = m.iters("y4", "x4")
    w = m.Fun("w")
    w[y4, x4] = z[y4, x4] + r[y4, x4]
    return w, _data(5)


def _extra_written_after(m):
    c = _scheduled_c(m)
    x2, j = m.iters("x2", "j")
    s = m.Fun("s")
    s[x2] = m.input("d")[x2, j]
    y3, x3 = m.iters("y3", "x3")
    out = m.Fun("out")
    out[y3, x3] = c[y3, x3] * s[x3]
    return out, _data(7, extras=[("d", (128, 4))])


def _transposed_operand(m):
    y, x, it = m.iters("y", "x", "it")
    a, b = m.input("a"), m.input("b")
    c = m.Fun("c")
    c[y, x] = a[it, y] * b[it, x]
    c.schedule(tile={"y": 16, "x": 16, "it": 16})
    rng = np.random.default_rng(8)
    return c, {"a": rng.normal(size=(64, 32)).astype(np.float32),
               "b": rng.normal(size=(64, 48)).astype(np.float32)}


def _indivisible_fused(m):
    c = _scheduled_c(m, dict(tile={"y": 16, "x": 128, "it": 128},
                             parallel=["y", "x"]))
    y2, x2 = m.iters("y2", "x2")
    biased = m.Fun("biased")
    biased[y2, x2] = c[y2, x2] + m.input("bias")[x2]
    y3, x3 = m.iters("y3", "x3")
    out = m.Fun("out")
    out[y3, x3] = m.maximum(biased[y3, x3], 0.0)
    return out, _data(9, m=30, k=70, n=50, extras=[("bias", (50,))])


def _iterator_in_epilogue(m):
    c = _scheduled_c(m)
    y2, x2 = m.iters("y2", "x2")
    d = m.Fun("d")
    d[y2, x2] = c[y2, x2] + m.to_scalar(x2)
    return d, _data(10)


PROGRAMS = {
    "pallas_matmul_matches_einsum": lambda m: _matmul(
        m, {"tile": {"y": 32, "x": 128, "it": 128}, "parallel": ["y", "x"],
            "cache": []}, (64, 128, 256), 0),
    "masked_indivisible": lambda m: _matmul(
        m, {"tile": {"y": 16}, "parallel": ["y"]}, (30, 50, 70), 1),
    "masked_indivisible_all_dims": lambda m: _matmul(
        m, {"tile": {"y": 16, "x": 48, "it": 100}, "parallel": ["y", "x"]},
        (37, 211, 93), 11),
    "cache_tensor_hint": _cache_hint,
    "dense_bias_relu": _dense_bias_relu,
    "col_broadcast_and_residual": _col_residual,
    "reused_intermediate": _reused_intermediate,
    "output_is_matmul": _output_is_matmul,
    "select_epilogue": _select_epilogue,
    "bias_writer_plus_relu_chain": _bias_writer_relu,
    "three_step_chain_with_residual": _three_step_chain,
    "dense_layer_schedule_kernel0": _dense_kernel0,
    "transposed_store_plain": _transposed_plain,
    "transposed_store_with_epilogue": _transposed_epilogue,
    "chain_stops_at_reused_intermediate": _chain_stops_at_reuse,
    "extra_operand_written_after_matmul": _extra_written_after,
    "transposed_operand_declines": _transposed_operand,
    "indivisible_tile_fuses": _indivisible_fused,
    "iterator_in_epilogue": _iterator_in_epilogue,
}


def _both(name, dtype="float32"):
    """(port model, JAX model, args) of program ``name``, compiled with
    schedule_mode="force" from each package's own build."""
    port_graph, args = PROGRAMS[name](egt)
    jax_graph, _ = PROGRAMS[name](exprgrad_tpu)
    out = port_graph.name or "out"
    if dtype == "float64":
        args = {k: v.astype(np.float64) for k, v in args.items()}
    port = egt.compile(port_graph.target(out), dtype=dtype, seed=5,
                       schedule_mode="force", device="cpu")
    ref = compile(jax_graph.target(out), dtype=dtype, seed=5,
                  backend="jax", schedule_mode="force")
    return port, ref, args, out


def _grad_target(m, graph):
    """d sum(graph) / d a, through the scheduled forward."""
    i = m.iters("i")
    loss = m.Fun()
    loss[0] = graph.raw[i]
    return loss.target("loss").backwards().grad(m.input("a")).target("grad")


def _mapped(stats):
    return {STAT_NAMES.get(k, k): v for k, v in stats.items()}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_scheduled_program_matches_jax(name):
    port, ref, args, out = _both(name)
    got, want = port.call(out, args), ref.call(out, args)
    np.testing.assert_allclose(got, np.asarray(want), **F32)
    assert port.lowering_stats(out) == _mapped(ref.lowering_stats(out))


@pytest.mark.parametrize("name", ["dense_bias_relu", "three_step_chain_with_"
                                  "residual", "transposed_store_with_"
                                  "epilogue", "masked_indivisible",
                                  "transposed_operand_declines"])
def test_scheduled_gradients_match_jax(name):
    port_graph, args = PROGRAMS[name](egt)
    jax_graph, _ = PROGRAMS[name](exprgrad_tpu)
    port = egt.compile(_grad_target(egt, port_graph), seed=5,
                       schedule_mode="force", device="cpu")
    ref = compile(_grad_target(exprgrad_tpu, jax_graph), seed=5,
                  backend="jax", schedule_mode="force")
    got, want = port.call("grad", args), ref.call("grad", args)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    assert port.lowering_stats("grad") == _mapped(
        ref.lowering_stats("grad"))


@pytest.mark.parametrize("name", ["dense_bias_relu", "transposed_store_"
                                  "with_epilogue"])
def test_float64_keeps_the_exact_path(name):
    port, ref, args, out = _both(name, dtype="float64")
    np.testing.assert_allclose(port.call(out, args),
                               np.asarray(ref.call(out, args)), **F64)
    stats = port.lowering_stats(out)
    assert "matmul" not in stats and "matmul-fused" not in stats
    assert stats == _mapped(ref.lowering_stats(out))


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_classifier_declines_as_jax(name):
    """Every kernel of every program gets the same verdict and the same
    ``why`` from both classifiers."""
    port, ref, args, out = _both(name)
    port.call(out, args)
    ref.call(out, args)
    (shapes,) = [key[1] for key in port._executors]
    shapes = dict(shapes)
    target = port.program.targets[out]
    jax_target = ref.program.targets[out]
    for kernel, jax_kernel in zip(target.kernels, jax_target.kernels):
        if kernel.write is None or kernel.extern is not None:
            continue
        low = KernelLowering(port.program, kernel,
                             {t: list(s) for t, s in shapes.items()},
                             torch.float32, torch.device("cpu"))
        jlow = JaxLowering(ref.program, jax_kernel,
                           {t: list(s) for t, s in shapes.items()},
                           np.float32, jax.lax.Precision.HIGHEST)
        if not low._bounds_ok:
            continue
        sm, pm = ScheduledMatmul(low, kernel), PallasMatmul(jlow, jax_kernel)
        assert (sm.ok, sm.why) == (pm.ok, pm.why)


# --- the epilogue compiler ------------------------------------------------

DENSE_RELU_PROGRAM = """\
consts [0.0]
extras ['row']
r1 = extra x0
r0 = add r0, r1
r1 = const #0
r2 = le r1, r0
r3 = const #0
r4 = select r2, r0, r3
r0 = mov r4"""


def test_epilogue_program_of_dense_bias_relu():
    port, _, args, out = _both("dense_layer_schedule_kernel0")
    port.call(out, args)
    (executor,) = port._executors.values()
    ((sm, chain),) = executor.fused.values()
    assert chain.program.text() == DENSE_RELU_PROGRAM
    assert [s.kind for s in chain.steps] == ["add", "map"]
    assert port.lowering_stats(out) == {"matmul-fused": 1}


def test_op_outside_the_epilogue_set_does_not_fold():
    port, ref, args, out = _both("iterator_in_epilogue")
    port.call(out, args)
    (executor,) = port._executors.values()
    assert executor.fused == {}
    assert executor.epilogue_declines == [
        (1, "op to_scalar is outside the epilogue set")]
    assert port.lowering_stats(out)["matmul"] == 1


# --- the scheduled MLP (chip_smoke.py's program (b)), narrow ------------

def test_scheduled_mlp_train_steps_match_jax():
    kw = dict(dim=32, hidden=64, tile=16)
    ref = compile(scheduled_mlp(exprgrad_tpu, **kw), backend="jax", seed=0,
                  schedule_mode="force")
    port = egt.from_state(scheduled_mlp(egt, **kw), ref.params, ref.caches,
                          ref.epoch, ref._rng.bit_generator.state,
                          schedule_mode="force", device="cpu")
    rng = np.random.default_rng(0)
    args = {"v": rng.normal(size=(48, 32)).astype(np.float32),
            "t": rng.normal(size=(48, 32)).astype(np.float32)}
    np.testing.assert_allclose(port.call("predict", {"v": args["v"]}),
                               ref.call("predict", {"v": args["v"]}), **F32)
    for _ in range(2):
        for model in (port, ref):
            model.epoch += 1
            model.apply("train", args)
    np.testing.assert_allclose(port.call("loss", args),
                               ref.call("loss", args), **F32)
    for tid, value in ref.params.items():
        np.testing.assert_allclose(port.params[tid].numpy(),
                                   np.asarray(value), rtol=1e-4, atol=2e-5)
    for target in ("predict", "train"):
        assert port.lowering_stats(target) == _mapped(
            ref.lowering_stats(target))
    assert port.lowering_stats("predict") == {"matmul-fused": 2}


def test_auto_takes_the_kernel_where_jax_falls_back():
    """schedule_mode="auto": the JAX package's TPU-calibrated cost model
    sends a scheduled matmul to XLA with a ScheduleWarning; the port has
    no H100 cost model yet and takes the kernel whenever the classifier
    accepts (ROADMAP.md C)."""
    port_graph, args = PROGRAMS["dense_bias_relu"](egt)
    jax_graph, _ = PROGRAMS["dense_bias_relu"](exprgrad_tpu)
    port = egt.compile(port_graph.target("d"), device="cpu")
    ref = compile(jax_graph.target("d"), backend="jax")
    np.testing.assert_allclose(port.call("d", args),
                               np.asarray(ref.call("d", args)), **F32)
    assert port.lowering_stats("d") == {"matmul-fused": 1}
    assert ref.lowering_stats("d")["schedule-fallback"] == 1
