"""The einsum path's float32 contractions on B1's Hopper mainloop.

``backend/torcheval.py`` sends a two-operand float32 contraction of the
unscheduled einsum path on a CUDA device, under precision "highest", to
``ops/matmul.py::contract`` (lowering path ``einsum-b1``) where the cost
model says the kernel wins; everything else keeps ``torch.einsum``.  The
CPU tests hold :func:`plan_gemm`'s mapping of einsum specs onto one GEMM
(batch, m, n, k and the operands' layouts), the routing and its
declines (decided on a lowering made for a CUDA device, which decides
without touching one), the folding of constants and phantom axes into
``alpha``, and the kernel's split-TF32 arithmetic emulated with
``ops/tf32.py`` against float64.  The test marked ``gpu`` runs the
kernel against its plain version on the card (run there with
``python -m pytest --noconftest tests/test_torch_gemm.py -m gpu``,
which skips this directory's conftest and its import of jax).
"""

import math
import string

import numpy as np
import pytest
import torch

import exprgrad_torch as egt
from exprgrad_torch.backend.policy import SchedulePolicy
from exprgrad_torch.backend.torcheval import KernelLowering
from exprgrad_torch.ops import matmul as mm
from exprgrad_torch.ops import tf32
from exprgrad_torch.passes import infer_shapes

L = string.ascii_letters
# Codestral-22B's widths and the training cell's 4,096 tokens
T, D, H, KV, HD, F, V = 4096, 6144, 48, 8, 128, 16384, 32768


def _plan(spec, sa, sb, extra=()):
    """``(plan, reason, out_shape)`` of einsum ``spec`` over operands of
    shapes ``sa`` and ``sb``; ``extra`` gives ``(letter, size)`` of
    output axes that no operand reads."""
    ins, out = spec.split("->")
    ia, ib = ins.split(",")
    sizes = {L.index(c): n for c, n in extra}
    for axes, shape in ((ia, sa), (ib, sb)):
        for c, s in zip(axes, shape):
            sizes[L.index(c)] = s
    ext = [sizes.get(i, 1) for i in range(max(sizes) + 1)]
    plan, why = mm.plan_gemm([tuple(L.index(c) for c in ia),
                              tuple(L.index(c) for c in ib)],
                             tuple(L.index(c) for c in out), ext)
    return plan, why, tuple(ext[L.index(c)] for c in out)


def _gemm(plan, sa, sb):
    """(batch, m, n, k) of a plan."""
    a, b = (sb, sa) if plan.swap else (sa, sb)
    batch, m, k = (math.prod(a[d] for d in g) for g in plan.a)
    return batch, m, math.prod(b[d] for d in plan.b[1]), k


# the training cell's contractions (flash_transformer's einsum specs at
# Codestral's widths): spec, operand shapes, (batch, m, n, k), layout
CELL = {
    "ffn up, forward": ("abc,cd->abd", (1, T, D), (D, F), (1, T, F, D),
                        "nn"),
    "head, forward (flattened m)": ("abc,cd->abd", (1, T, D), (D, V),
                                    (1, T, V, D), "nn"),
    "q, forward (heads into n)": ("acd,bde->abce", (1, T, D), (H, D, HD),
                                  (1, T, H * HD, D), "nn"),
    "o, forward (heads into k)": ("abcd,bde->ace", (1, H, T, HD),
                                  (H, HD, D), (1, T, D, H * HD), "nn"),
    "ffn down, dW": ("abd,abc->cd", (1, T, D), (1, T, F), (1, F, D, T),
                     "tn"),
    "head, dW": ("abd,abc->cd", (1, T, V), (1, T, D), (1, D, V, T), "tn"),
    "ffn down, dX": ("abd,cd->abc", (1, T, D), (F, D), (1, T, F, D), "nt"),
    "head, dX": ("abd,cd->abc", (1, T, V), (D, V), (1, T, D, V), "nt"),
    "kv, dW": ("abce,acd->bde", (1, KV, T, HD), (1, T, D),
               (1, D, KV * HD, T), "tn"),
    "q, dX": ("abce,bde->acd", (1, H, T, HD), (H, D, HD),
              (1, T, D, H * HD), "nt"),
    "o, dW": ("ace,abcd->bde", (1, T, D), (1, H, T, HD),
              (1, H * HD, D, T), "tn"),
    "o, dX": ("ace,bde->abcd", (1, T, D), (H, HD, D), (1, T, H * HD, D),
              "nt"),
    "batched": ("bmk,bnk->bmn", (3, 200, 96), (3, 72, 96),
                (3, 200, 72, 96), "nt"),
}


@pytest.mark.parametrize("name", sorted(CELL))
def test_plan_maps_the_einsum_onto_one_gemm(name):
    spec, sa, sb, want, layout = CELL[name]
    plan, why, _ = _plan(spec, sa, sb)
    assert why is None and plan is not None
    assert _gemm(plan, sa, sb) == want
    assert plan.layout == layout


DECLINED = {
    "narrower than half a tile": ("abc,abc->ab", (1, T, D), (1, T, D),
                                  "m or n under"),
    "no summed axis": ("ab,cd->abcd", (256, 256), (256, 256),
                       "no summed axis"),
    "summed in one operand alone": ("abc,cd->d", (4, 256, 256), (256, 256),
                                    "summed in one operand alone"),
    "an output axis in neither operand": ("ab,bc->acd", (256, 256),
                                          (256, 256), "in neither"),
    "an output axis of size 1 in neither operand is no axis": (
        "ab,bc->acd", (256, 256), (256, 256), None),
    "more than three axes a group": ("abcdk,ke->abcde",
                                     (2, 2, 2, 64, 64), (64, 64),
                                     "more than 3"),
}


@pytest.mark.parametrize("name", sorted(DECLINED))
def test_plan_declines(name):
    spec, sa, sb, why = DECLINED[name]
    plan, reason, _ = _plan(spec, sa, sb,
                            extra=[("d", 256 if why else 1)])
    if why is None:  # a broadcast of extent 1 is no broadcast
        assert plan is not None and reason is None
    else:
        assert plan is None and why in reason


def test_plan_declines_three_operands():
    plan, reason = mm.plan_gemm([(0, 1), (1, 2), (2, 3)], (0, 3),
                                [256] * 4)
    assert plan is None and "3 operands" in reason


SMALL = [
    ("abc,cd->abd", (1, 200, 77), (77, 333), 1.0, False),
    ("abc,cd->abd", (2, 130, 64), (64, 96), 0.5, True),
    ("abd,abc->cd", (1, 300, 90), (1, 300, 70), 2.0, True),
    ("abd,cd->abc", (1, 129, 257), (65, 257), 1.0, False),
    ("bmk,bnk->bmn", (3, 130, 50), (3, 70, 50), -1.5, True),
    ("acd,bde->abce", (1, 100, 96), (6, 96, 16), 1.0, False),
    ("abcd,bde->ace", (1, 6, 100, 16), (6, 16, 96), 1.0, False),
    ("abce,acd->bde", (1, 6, 100, 16), (1, 100, 96), 1.0, False),
    ("abce,bde->acd", (1, 6, 100, 16), (6, 96, 16), 1.0, True),
    ("ace,abcd->bde", (1, 100, 96), (1, 6, 100, 16), 1.0, False),
    ("ace,bde->abcd", (1, 100, 96), (6, 16, 96), 1.0, False),
]


@pytest.mark.parametrize("case", SMALL, ids=[c[0] for c in SMALL])
def test_contract_plain_is_the_einsum(case):
    """On CPU tensors :func:`contract` is its plain version: the einsum
    in float64, times alpha, plus c."""
    spec, sa, sb, alpha, with_c = case
    gen = torch.Generator().manual_seed(0)
    a, b = torch.randn(sa, generator=gen), torch.randn(sb, generator=gen)
    plan, _, out_shape = _plan(spec, sa, sb)
    c = torch.randn(out_shape, generator=gen) if with_c else None
    got = mm.contract(a, b, plan, out_shape, alpha, c)
    want = alpha * torch.einsum(spec, a.double(), b.double())
    if c is not None:
        want = want + c.double()
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want.float(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", SMALL[:5], ids=[c[0] for c in SMALL[:5]])
def test_kmajor_split_keeps_float32_accuracy(case):
    """The kernel's arithmetic (``tf32.kmajor_gemm``: the K-major big and
    small planes, 32-deep slices in fresh accumulators) against float64:
    within a few float32 steps of the products' scale, where one TF32
    pass errs by about 2^-11 of it."""
    spec, sa, sb, _, _ = case
    gen = torch.Generator().manual_seed(1)
    a, b = torch.randn(sa, generator=gen), torch.randn(sb, generator=gen)
    plan, _, _ = _plan(spec, sa, sb)
    if plan.swap:
        a, b = b, a
    ga, gb = mm._as_gemm(a, plan.a), mm._as_gemm(b, plan.b)
    want = ga.double() @ gb.double().transpose(1, 2)
    scale = (ga.double().abs() @ gb.double().abs().transpose(1, 2)).max()
    got = tf32.kmajor_gemm(ga, gb)
    single = tf32.tf32_round(ga) @ tf32.tf32_round(gb).transpose(1, 2)
    err = ((got.double() - want).abs().max() / scale).item()
    err_tf32 = ((single.double() - want).abs().max() / scale).item()
    assert err < 4 * 2.0 ** -24 * math.sqrt(ga.shape[-1]) + 2.0 ** -22
    assert err_tf32 > 16 * err


@pytest.mark.parametrize("name", sorted(CELL))
def test_plan_travels_as_the_ops_ints(name):
    spec, sa, sb, _, _ = CELL[name]
    plan, _, _ = _plan(spec, sa, sb)
    assert mm._plan_from_flat(plan.flat) == plan


def test_contraction_exports_as_its_op():
    """``torch.export`` keeps the contraction as the op
    ``exprgrad_torch::contract`` (its fake implementation gives the
    shape), as it keeps B1's ``exprgrad_torch::matmul``."""
    spec, sa, sb, alpha, _ = SMALL[1]
    plan, _, out_shape = _plan(spec, sa, sb)

    class Contract(torch.nn.Module):
        def forward(self, a, b):
            return mm.contract(a, b, plan, out_shape, alpha)

    a, b = torch.randn(sa), torch.randn(sb)
    program = torch.export.export(Contract(), (a, b), strict=False)
    calls = [n.target for n in program.graph.nodes
             if n.op == "call_function"]
    assert calls == [torch.ops.exprgrad_torch.contract.default]
    assert torch.equal(program.module()(a, b), Contract()(a, b))


# --- routing: lowerings made for a CUDA device decide without one ----------

def _dense(n_in, n_out, scale=None, rows=T):
    """``c[y, x] = a[y, it] * w[it, x]`` (times ``scale`` if given)."""
    y, x, it = egt.iters("y", "x", "it")
    c = egt.Fun("c")
    prod = egt.input("a")[y, it] * egt.input("w")[it, x]
    c[y, x] = prod if scale is None else scale(prod)
    return c.target("c"), {"a": [rows, n_in], "w": [n_in, n_out]}


def _three(n):
    y, x, it = egt.iters("y", "x", "it")
    c = egt.Fun("c")
    c[y, x] = (egt.input("a")[y, it] * egt.input("w")[it, x]
               * egt.input("s")[it])
    return c.target("c"), {"a": [n, n], "w": [n, n], "s": [n]}


def _sum_of_products(n):
    y, x, it = egt.iters("y", "x", "it")
    c = egt.Fun("c")
    c[y, x] = egt.input("a")[y, it] * egt.input("w")[it, x] + 1.0
    return c.target("c"), {"a": [n, n], "w": [n, n]}


def _lowering(built, dtype=torch.float32, device="cuda", mode="auto",
              kernel_wins=False):
    """The lowering of ``built``'s one kernel for ``device``;
    ``kernel_wins`` gives the cost model a free kernel (small shapes that
    CPU tensors can run)."""
    graph, sizes = built
    model = egt.compile(graph, seed=0, device="cpu")
    prog = model.program
    shapes = infer_shapes(prog, "c", [(prog.inputs[k], v)
                                      for k, v in sizes.items()])
    (kernel,) = prog.targets["c"].kernels
    policy = SchedulePolicy(mode)
    if kernel_wins:
        policy.constants["einsum_kernel_launch_us"] = 0.0
    return KernelLowering(prog, kernel, shapes, dtype, torch.device(device),
                          policy), prog


@pytest.mark.parametrize("mode", ["auto", "force", "ignore"])
def test_routes_the_cells_dense_layers_in_every_mode(mode):
    """A float32 dense layer at the cell's width on a CUDA device goes to
    the kernel: no schedule asked for it, so the cost model decides in
    every schedule mode."""
    for n_out in (F, V):
        low, _ = _lowering(_dense(D, n_out), mode=mode)
        plan, alpha = low.einsum_gemm()
        assert plan.layout == "nn" and alpha == 1.0


@pytest.mark.parametrize("why", ["bfloat16", "float64", "cpu", "three",
                                 "not a product", "small"])
def test_declines_to_torch_einsum(why):
    built = {"three": lambda: _three(D),
             "not a product": lambda: _sum_of_products(D),
             "small": lambda: _dense(64, 64)}.get(why, lambda: _dense(D, F))()
    dtype = {"bfloat16": torch.bfloat16,
             "float64": torch.float64}.get(why, torch.float32)
    low, _ = _lowering(built, dtype=dtype,
                       device="cpu" if why == "cpu" else "cuda")
    assert low.einsum_gemm() is None
    if why == "small":  # the cost model keeps it: the kernel's launches
        pol = low.policy
        assert not pol.einsum_contraction(T, 64, 64).use_pallas
        assert pol.einsum_contraction(T, F, D).use_pallas


def _scheduled_dense(n, relu=False):
    """``_dense`` scheduled as B1 takes it, with a relu epilogue if
    ``relu``."""
    y, x, it = egt.iters("y", "x", "it")
    c = egt.Fun("c")
    c[y, x] = egt.input("a")[y, it] * egt.input("w")[it, x]
    c.schedule(tile={"y": 128, "x": 128, "it": 128}, parallel=["y", "x"])
    out = egt.layers.relu(c) if relu else c
    return out.target("c"), {"a": [n, n], "w": [n, n]}


# B1's mma.sync mainloop faster than torch.einsum and slower than the
# einsum path's Hopper mainloop, no per-call costs
RATES = dict(kernel_matmul_tflops_float32=60.0,
             plain_matmul_tflops_float32=50.0,
             einsum_kernel_tflops_float32=110.0, matmul_kernel_launch_us=0.0,
             matmul_plain_launch_us=0.0, einsum_kernel_launch_us=0.0,
             einsum_plain_launch_us=0.0)


@pytest.mark.parametrize("device,route", [("cuda", None), ("cpu", "matmul")])
def test_scheduled_decision_prices_the_plain_side_as_it_runs(device, route):
    """A scheduled float32 matmul under "auto" weighs B1 against the plain
    lowering it would fall back to: on a CUDA device the einsum path's
    Hopper mainloop, on the CPU torch.einsum."""
    low, _ = _lowering(_scheduled_dense(D), device=device)
    low.policy.constants.update(RATES)
    assert (low.einsum_gemm() is not None) == (device == "cuda")
    got, reason = low.scheduled_decision()
    assert got == route
    sm = low.scheduled_matmul()
    assert low.policy.contraction(sm.m, sm.n, sm.k, "float32",
                                  plain_gemm=device == "cuda").use_pallas \
        == (route == "matmul")
    if route is None:
        assert reason.startswith("cost model: plain")


@pytest.mark.parametrize("device,mode,plain_us,fused", [
    ("cuda", "auto", 0.0, False), ("cuda", "auto", 1e4, True),
    ("cuda", "force", 0.0, True), ("cpu", "auto", 0.0, True),
    ("cpu", "auto", 1e4, True)])
def test_epilogue_planner_decides_as_the_kernel_does(device, mode, plain_us,
                                                     fused):
    """The matmul+epilogue planner folds the relu into B1 only where the
    scheduled decision keeps B1, its plain side priced as it runs: where
    that is the einsum path's kernel, the relu is a plain call of its own
    (``plain_launch_us``); a plain call of 10 ms keeps B1."""
    from exprgrad_torch.backend.scheduled import plan_epilogue_fusions

    graph, sizes = _scheduled_dense(D, relu=True)
    prog = egt.compile(graph, seed=0, device="cpu").program
    shapes = infer_shapes(prog, "c", [(prog.inputs[k], v)
                                      for k, v in sizes.items()])
    policy = SchedulePolicy(mode)
    policy.constants.update(RATES, plain_launch_us=plain_us)
    fusions, _, _, declines = plan_epilogue_fusions(
        prog, prog.targets["c"], shapes, torch.float32,
        torch.device(device), policy)
    assert bool(fusions) == fused, declines
    for sm, chain in fusions.values():
        assert len(chain.steps) == 1


def _run_spied(low, tensors, monkeypatch, allow_tf32):
    """Run the lowering's contraction on CPU tensors with the kernel's
    wrapper replaced by its plain version; returns (value, path, calls)."""
    calls = []

    def spy(a, b, plan, out_shape, alpha=1.0, c=None):
        calls.append((plan, tuple(out_shape), alpha, c is None))
        return mm.contract_plain(a, b, plan, out_shape, alpha, c)

    monkeypatch.setattr(mm, "contract", spy)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    try:
        value, path = low._try_contraction(tensors)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return value, path, calls


@pytest.mark.parametrize("allow_tf32,path", [(False, "einsum-b1"),
                                              (True, "einsum")])
def test_precision_highest_alone_takes_the_kernel(allow_tf32, path,
                                                  monkeypatch):
    """TF32 allowed (precision "high" or "default") keeps torch.einsum:
    TF32 cuBLAS is faster there than any float32-exact kernel."""
    low, prog = _lowering(_dense(96, 80, rows=72), kernel_wins=True)
    a, w = torch.randn(72, 96), torch.randn(96, 80)
    tensors = {prog.inputs["a"]: a, prog.inputs["w"]: w,
               low.kernel.write.tensor: torch.zeros(72, 80)}
    low.fresh_output = True
    value, got_path, calls = _run_spied(low, tensors, monkeypatch,
                                        allow_tf32)
    assert got_path == path and len(calls) == (path == "einsum-b1")
    torch.testing.assert_close(value, a @ w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fresh", [True, False])
def test_alpha_folds_constants_and_phantom_axes(fresh, monkeypatch):
    """``-(a w * 3) / 4`` with a phantom loop axis of 5: the kernel gets
    alpha = -0.75 * 5 and, where the output was written before, c; the
    value equals the torch.einsum path's."""
    built = _dense(40, 90, scale=lambda p: -(p * 3.0) / 4.0, rows=70)
    low, prog = _lowering(built, kernel_wins=True)
    low.nloops += 1
    low.sizes = [*low.sizes, 5]
    plan, alpha = low.einsum_gemm()
    assert alpha == -0.75 * 5
    gen = torch.Generator().manual_seed(2)
    a, w = torch.randn(70, 40, generator=gen), torch.randn(40, 90,
                                                          generator=gen)
    out = low.kernel.write.tensor
    c = torch.zeros(70, 90) if fresh else torch.randn(70, 90, generator=gen)
    tensors = {prog.inputs["a"]: a, prog.inputs["w"]: w, out: c}
    low.fresh_output = fresh
    value, path, calls = _run_spied(low, tensors, monkeypatch, False)
    assert path == "einsum-b1" and calls[0][2] == alpha
    assert calls[0][3] == fresh  # c is passed only where it may hold data
    plain, how = low._try_contraction(tensors, route=False)
    assert how == "einsum"
    torch.testing.assert_close(value, plain, rtol=1e-5, atol=1e-5)


def test_cpu_models_keep_the_einsum_path():
    """A model on the CPU counts ``einsum`` as before: the parity tests
    of ``lowering_stats`` against the JAX package see no change."""
    graph, _ = _dense(32, 48)
    model = egt.compile(graph, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    out = model.call("c", {"a": rng.standard_normal((16, 32)).astype(
        np.float32), "w": rng.standard_normal((32, 48)).astype(np.float32)})
    assert out.shape == (16, 48)
    assert model.lowering_stats("c") == {"einsum": 1}


# --- on the card -----------------------------------------------------------

CARD = [
    ("abc,cd->abd", (1, T, D), (D, F)),     # nn
    ("abd,cd->abc", (1, T, D), (F, D)),     # nt
    ("abd,abc->cd", (1, T, D), (1, T, F)),  # tn
    ("abcd,bde->ace", (1, H, T, HD), (H, HD, D)),   # heads into k
    ("abce,acd->bde", (1, KV, T, HD), (1, T, D)),   # heads into n
    ("abc,cd->abd", (1, 200, 77), (77, 333)),       # ragged m, n, k
    ("abd,abc->cd", (1, 301, 91), (1, 301, 70)),
    ("bmk,bnk->bmn", (3, 130, 50), (3, 70, 50)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD, ids=[f"{c[0]}{c[1]}" for c in CARD])
def test_kernel_matches_plain_on_the_card(case):
    """The kernel against its plain version (float64): within split
    TF32's bound, the same bits twice, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("runs the CUDA kernel: needs an NVIDIA GPU")
    spec, sa, sb = case
    gen = torch.Generator(device="cuda").manual_seed(3)
    a = torch.randn(sa, device="cuda", generator=gen)
    b = torch.randn(sb, device="cuda", generator=gen)
    plan, _, out_shape = _plan(spec, sa, sb)
    c = torch.randn(out_shape, device="cuda", generator=gen)
    before = mm.gemm_launches
    got = mm.contract(a, b, plan, out_shape, 0.5, c)
    again = mm.contract(a, b, plan, out_shape, 0.5, c)
    torch.cuda.synchronize()
    assert mm.gemm_launches == before + 2
    assert torch.equal(got, again)
    want = mm.contract_plain(a.double(), b.double(), plan, out_shape, 0.5,
                             c.double())
    k = _gemm(plan, sa, sb)[3]
    scale = 0.5 * (torch.einsum(spec, a.double().abs(),
                                b.double().abs())).max() + c.abs().max()
    err = ((got.double() - want).abs().max() / scale).item()
    assert err < 4 * 2.0 ** -24 * math.sqrt(k) + 2.0 ** -21, err
