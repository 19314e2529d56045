"""Port parity: the routing cost model (exprgrad_torch/backend/policy.py).

The port's model takes the JAX package's form as one case of its own: a
set of the JAX package's constants carried to the port's keys, with the
kernel side's per-call costs at its ``pallas_launch_us``, the plain
side's at 0, one rate for every dtype, the work charged to the kernel
side at its elementwise rate (``kernel_work_gbps``).  Under such a set the
port's ``Decision.use_pallas`` must equal the JAX package's on
parametrised grids of each decision's arguments, and every program of
the parity tables of ``test_torch_matmul.py``, ``test_torch_mapreduce.py``
and ``test_torch_rowchain.py`` must route the same way in both packages
under ``schedule_mode="auto"``: the same ``lowering_stats`` (mapped) and
values within each table's float32 tolerance.  That holds the port's
byte counts to the JAX package's (``pallasgen.py:1782-1800,
2362-2372``).

The sets: the JAX package's ``_DEFAULTS`` (uncalibrated), its loaded
calibration, and two whose thresholds fall inside the grids and the test
programs' sizes, so both outcomes occur.  Then the committed
``calibration.json``: it loads, names an NVIDIA card and its power limit,
sets ``calibrated``, and ``_DEFAULTS`` is the block the calibration script
renders from it.  Then the script's derivation: ties and the card's peaks.
"""

import itertools
import json
import warnings

import numpy as np
import pytest

import exprgrad_torch as egt
import exprgrad_torch.layers  # noqa: F401
import exprgrad_tpu
import exprgrad_tpu.layers  # noqa: F401
from chip_smoke import (MAPREDUCE_FAMILIES, ROWCHAIN_FAMILIES,
                        calibrate_module)
from exprgrad_torch.backend import policy as port_policy
from exprgrad_tpu import compile
from exprgrad_tpu.backend import policy as jax_policy
from test_torch_mapreduce import GRADS
from test_torch_matmul import PROGRAMS

# each table's own tolerance (its parity test's)
TOL = {"matmul": dict(rtol=1e-4, atol=1e-5),
       "mapreduce": dict(rtol=1e-5, atol=1e-6),
       "mapreduce_grad": dict(rtol=1e-5, atol=1e-5),
       "rowchain": dict(rtol=1e-5, atol=1e-6)}
STAT_NAMES = {"pallas": "matmul", "pallas-fused": "matmul-fused",
              "pallas-mapreduce": "mapreduce", "pallas-rowchain": "rowchain"}


def _synthetic(launch_us):
    """JAX-keyed constants whose thresholds fall at the test sizes."""
    return {"xla_matmul_tflops": 0.1, "pallas_matmul_tflops": 0.2,
            "xla_elementwise_gbps": 1.0, "pallas_elementwise_gbps": 2.0,
            "pallas_rowchain_gbps": 1.5, "flash_attention_tflops": 0.4,
            "xla_attention_tflops": 0.1, "pallas_launch_us": launch_us,
            "calibrated": True}


SETS = {
    "jax_defaults": dict(jax_policy._DEFAULTS, calibrated=False),
    "jax_calibration": jax_policy._load_constants(),
    "thresholds_20us": _synthetic(20.0),
    "thresholds_200us": _synthetic(200.0),
}


def port_constants(j: dict) -> dict:
    """The JAX package's model in the port's keys."""
    launch = j["pallas_launch_us"]
    c = {
        "kernel_elementwise_gbps": j["pallas_elementwise_gbps"],
        "plain_elementwise_gbps": j["xla_elementwise_gbps"],
        "kernel_work_gbps": j["pallas_elementwise_gbps"],
        "kernel_rowchain_gbps": j["pallas_rowchain_gbps"],
        "flash_attention_tflops": j["flash_attention_tflops"],
        "plain_attention_tflops": j["xla_attention_tflops"],
        "kernel_launch_us": launch, "matmul_kernel_launch_us": launch,
        "attention_flash_launch_us": launch,
        "plain_launch_us": 0.0, "matmul_plain_launch_us": 0.0,
        "attention_plain_launch_us": 0.0,
        "calibrated": j["calibrated"], "card": None,
        # the einsum path's kernel, which the JAX package does not have:
        # its matmul kernel's constants
        "einsum_kernel_tflops_float32": j["pallas_matmul_tflops"],
        "einsum_kernel_launch_us": launch, "einsum_plain_launch_us": 0.0,
    }
    for dtype in ("float32", "bfloat16"):
        c[f"kernel_matmul_tflops_{dtype}"] = j["pallas_matmul_tflops"]
        c[f"plain_matmul_tflops_{dtype}"] = j["xla_matmul_tflops"]
    return c


def test_port_constants_cover_the_port_keys():
    assert set(port_constants(SETS["jax_defaults"])) >= set(
        port_policy._DEFAULTS)


def _policies(set_name, mode="auto"):
    jpol = jax_policy.SchedulePolicy(mode)
    jpol.constants = dict(SETS[set_name])
    ppol = port_policy.SchedulePolicy(mode)
    ppol.constants = port_constants(SETS[set_name])
    return ppol, jpol


def _same(got, want):
    assert got.use_pallas == want.use_pallas, (got, want)
    suffix = "(uncalibrated defaults)"
    assert got.reason.endswith(suffix) == want.reason.endswith(suffix)


SIZES = (8, 128, 1024, 8192)


@pytest.mark.parametrize("set_name", sorted(SETS))
@pytest.mark.parametrize("m,n,k", list(itertools.product(SIZES, repeat=3)))
def test_contraction_decides_as_jax(set_name, m, n, k):
    ppol, jpol = _policies(set_name)
    want = jpol.contraction(m, n, k)
    for dtype in ("float32", "bfloat16"):
        _same(ppol.contraction(m, n, k, dtype), want)


@pytest.mark.parametrize("set_name", sorted(SETS))
@pytest.mark.parametrize("total,work", list(itertools.product(
    (10**3, 10**5, 10**7, 10**9, 10**11), (0, 10**5, 10**8, 10**11))))
def test_mapreduce_decides_as_jax(set_name, total, work):
    ppol, jpol = _policies(set_name)
    _same(ppol.mapreduce(total, work), jpol.mapreduce(total, work))


@pytest.mark.parametrize("set_name", sorted(SETS))
@pytest.mark.parametrize("operand,out,members", list(itertools.product(
    (10**3, 10**5, 10**7, 10**9), (10**3, 10**7, 10**9), (2, 3, 4, 6))))
def test_rowchain_decides_as_jax(set_name, operand, out, members):
    ppol, jpol = _policies(set_name)
    _same(ppol.rowchain(operand, out, members),
          jpol.rowchain(operand, out, members))


ATTENTION = [(1, 1, 64, 64, 64), (8, 4, 256, 256, 128),
             (2, 4, 4096, 4096, 128), (1, 8, 2048, 512, 64),
             (8, 4, 1, 256, 128),
             (4, 32, 8192, 8192, 128)]  # 34 GB of float32 weights


@pytest.mark.parametrize("set_name", sorted(SETS))
@pytest.mark.parametrize("shape", ATTENTION, ids=str)
def test_attention_decides_as_jax(set_name, shape):
    for mode in ("auto", "force", "ignore"):  # independent of the mode
        ppol, jpol = _policies(set_name, mode)
        _same(ppol.attention(*shape), jpol.attention(*shape))
    ppol, _ = _policies(set_name)
    if 4.0 * np.prod(shape[:4]) > 2e9:
        assert ppol.attention(*shape).use_pallas


@pytest.mark.parametrize("mode", ["force", "ignore"])
def test_modes_short_cut_as_jax(mode):
    ppol, jpol = _policies("thresholds_20us", mode)
    for got, want in ((ppol.contraction(8, 8, 8), jpol.contraction(8, 8, 8)),
                      (ppol.mapreduce(10**9), jpol.mapreduce(10**9)),
                      (ppol.rowchain(10, 10, 3), jpol.rowchain(10, 10, 3))):
        assert (got.use_pallas, got.reason) == (want.use_pallas, want.reason)


def test_calibration_loads_names_the_card_and_equals_the_defaults():
    with open(port_policy._CALIBRATION_PATH) as f:
        data = json.load(f)
    constants = port_policy._load_constants()
    assert constants["calibrated"] is True
    assert "NVIDIA" in data["card"] and data["card"].endswith(" W")
    assert constants["card"] == data["card"]
    assert data["torch"] and data["date"]
    assert set(port_policy._DEFAULTS) <= set(data)
    for key, value in port_policy._DEFAULTS.items():
        assert value == data[key], key
    # _DEFAULTS is the block the script renders from the same run
    calib = calibrate_module()
    result = dict(data, constants={k: data[k] for k in port_policy._DEFAULTS})
    with open(port_policy.__file__) as f:
        assert calib.defaults_block(result) in f.read()
    missing = port_policy._load_constants("/nonexistent/calibration.json")
    assert missing["calibrated"] is False
    pol = port_policy.SchedulePolicy("auto")
    pol.constants = dict(missing, kernel_elementwise_gbps=1e-3)
    assert pol.mapreduce(10**6).reason.endswith("(uncalibrated defaults)")


def _fake_cases(gap=0.0):
    """The calibration's fitted cases with made-up walls: every pair
    apart by ``gap`` ms (the kernel slower), walls spread by 0.01 ms."""
    calib = calibrate_module()
    work = {"matmul 4096^3": 2.0 * 4096 ** 3,
            "elementwise map 8192^2": 2 * 8192 * 8192 * 4,
            "softmax 8192^2": (8192 * 8192 * 4, 8192 * 8192 * 4),
            "causal attention [2, 4, 4096, 128]": 4.0 * 8 * 4096 ** 2 * 128}
    cases = []
    names = [(n, "float32") for n, *_ in calib.TINY] + [
        (n, dt) for n, dt, *_ in calib.RATES]
    for name, dtype in names:
        ms = 0.1 if name.startswith("tiny") else 5.0
        cases.append({"name": name, "dtype": dtype, "work": work.get(name, 0),
                      "kernel_ms": ms + gap, "plain_ms": ms,
                      "kernel_walls": [ms + gap - 0.005, ms + gap + 0.005],
                      "plain_walls": [ms - 0.005, ms + 0.005]})
    return calib, cases


@pytest.mark.parametrize("gap,tie", [(0.005, True), (0.5, False)])
def test_calibration_derives_rates_from_walls_and_keeps_ties(gap, tie):
    """Each rate is its case's work over the wall time a call; a gap
    within the walls' spread is a tie, and the plain side then takes the
    kernel's rate, so the per-call costs decide."""
    calib, cases = _fake_cases(gap)
    c = calib.derive(cases)
    assert set(c) == set(port_policy._DEFAULTS)
    assert c["kernel_launch_us"] == pytest.approx((0.1 + gap) * 1e3)
    plain_ms = 5.0 + gap if tie else 5.0  # a tie: the kernel's rate
    assert c["plain_elementwise_gbps"] == pytest.approx(
        2 * 8192 * 8192 * 4 / (plain_ms * 1e-3) / 1e9)
    big = calib._case(cases, "matmul 4096^3")
    assert calib.winner(big) == ("tie" if tie else "plain")
    same = c["plain_matmul_tflops_float32"] == c[
        "kernel_matmul_tflops_float32"]
    assert same == tie
    assert calib.fitted(big) == ["kernel_matmul_tflops_float32",
                                 "plain_matmul_tflops_float32"]


def test_calibration_refuses_a_rate_above_the_peak():
    calib, cases = _fake_cases()
    for case in cases:
        if case["name"] == "elementwise map 8192^2":
            case["kernel_ms"] = 0.01  # 54 TB/s
    with pytest.raises(ValueError, match="kernel_elementwise_gbps"):
        calib.derive(cases)


# --- routing of the parity tables' programs under auto ---------------------

def _mapped(stats):
    return {STAT_NAMES.get(k, k): v for k, v in stats.items()}


def _matmul_program(name):
    def build(m):
        graph, args = PROGRAMS[name](m)
        out = graph.name or "out"
        return graph.target(out), args, out
    return build


def _out(build):
    def wrapped(m):
        return (*build(m), "out")
    return wrapped


CASES = {f"matmul/{n}": _matmul_program(n) for n in sorted(PROGRAMS)}
CASES.update({f"mapreduce/{n}": _out(MAPREDUCE_FAMILIES[n])
              for n in sorted(MAPREDUCE_FAMILIES)})
CASES.update({f"mapreduce_grad/{n}": _out(GRADS[n]) for n in sorted(GRADS)})
CASES.update({f"rowchain/{n}": _out(ROWCHAIN_FAMILIES[n])
              for n in sorted(ROWCHAIN_FAMILIES)})


def _auto_models(build, set_name, monkeypatch):
    """(port, JAX, inputs, target) of ``build`` compiled under
    schedule_mode="auto" with constant set ``set_name`` in both."""
    monkeypatch.setattr(jax_policy, "_load_constants",
                        lambda: dict(SETS[set_name]))
    monkeypatch.setattr(port_policy, "_load_constants",
                        lambda: port_constants(SETS[set_name]))
    port_graph, args, target = build(egt)
    ref_graph, _, _ = build(exprgrad_tpu)
    port = egt.compile(port_graph, seed=0, device="cpu")
    ref = compile(ref_graph, seed=0, backend="jax")
    for model in (port, ref):
        model.epoch = 3
    return port, ref, args, target


@pytest.mark.parametrize("set_name", ["jax_calibration", "thresholds_20us",
                                      "thresholds_200us"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_auto_routes_as_jax(case, set_name, monkeypatch):
    port, ref, args, target = _auto_models(CASES[case], set_name,
                                           monkeypatch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", egt.ScheduleWarning)
        warnings.simplefilter("ignore", exprgrad_tpu.ScheduleWarning)
        got = port.call(target, args)
        want = np.asarray(ref.call(target, args))
    assert port.lowering_stats(target) == _mapped(ref.lowering_stats(target))
    np.testing.assert_allclose(got, want, **TOL[case.split("/")[0]])


def test_calibration_script_imports_only_the_port_and_needs_a_gpu(tmp_path):
    """scripts/calibrate_torch.py with jax and the JAX package blocked: on
    a machine without a GPU it raises and writes nothing."""
    import subprocess
    import sys
    import textwrap
    from pathlib import Path

    script = Path(__file__).resolve().parents[1] / "scripts" / \
        "calibrate_torch.py"
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.modules["jax"] = None
        sys.modules["exprgrad_tpu"] = None
        sys.argv = ["calibrate_torch.py", "--json", "c.json", "--perf",
                    "p.md"]
        runpy.run_path({str(script)!r}, run_name="__main__")
    """)
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300)
    assert run.returncode != 0
    assert "needs an NVIDIA GPU" in run.stderr, run.stderr[-2000:]
    assert not list(tmp_path.iterdir())


# --- the byte counts the decisions take ------------------------------------

BYTE_CASES = {f"mapreduce/{n}": _out(MAPREDUCE_FAMILIES[n])
              for n in sorted(MAPREDUCE_FAMILIES)}
BYTE_CASES.update({f"mapreduce_grad/{n}": _out(GRADS[n])
                   for n in sorted(GRADS)})
BYTE_CASES.update({f"rowchain/{n}": _out(ROWCHAIN_FAMILIES[n])
                   for n in sorted(ROWCHAIN_FAMILIES)})


@pytest.mark.parametrize("case", sorted(BYTE_CASES))
def test_byte_counts_equal_jax(case):
    """Each B5 kernel's ``total_bytes`` and ``gather_work`` and each B6
    chain's ``operand_bytes`` and ``out_bytes`` equal the JAX package's
    ``PallasMapReduce`` and ``PallasRowChain`` counts of the same kernel
    (``pallasgen.py:1782-1800, 2362-2372``), under schedule_mode="force"
    in both."""
    port_graph, args, target = BYTE_CASES[case](egt)
    ref_graph, _, _ = BYTE_CASES[case](exprgrad_tpu)
    port = egt.compile(port_graph, seed=0, schedule_mode="force",
                       device="cpu")
    ref = compile(ref_graph, seed=0, backend="jax", schedule_mode="force")
    for model in (port, ref):
        model.epoch = 3
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", egt.ScheduleWarning)
        warnings.simplefilter("ignore", exprgrad_tpu.ScheduleWarning)
        port.call(target, args)
        ref.call(target, args)
    (pex,) = [ex for (n, _), ex in port._executors.items() if n == target]
    (jex,) = [ex for (n, _), ex in ref._executors.items() if n == target]
    pchains = {i: (c.operand_bytes, c.out_bytes)
               for i, c in pex.row_fused.items()}
    jchains = {i: (c.operand_bytes, c.out_bytes)
               for i, c in jex.row_fused.items()}
    assert pchains == jchains
    from exprgrad_tpu.backend.jaxeval import KernelLowering as JaxLowering
    from exprgrad_tpu.backend.pallasgen import PallasMapReduce
    import jax

    counted = 0
    for i, low in pex._lowerings.items():
        if not (low._bounds_ok and low.kernel.extern is None
                and low.kernel.write is not None):
            continue
        mr = low.scheduled_mapreduce()
        jk = ref.program.targets[target].kernels[i]
        jlow = JaxLowering(ref.program, jk, {t: list(s) for t, s in
                                              low.shapes.items()},
                           np.float32, jax.lax.Precision.HIGHEST)
        pmr = PallasMapReduce(jlow, jk)
        if not (mr.ok and pmr.ok):
            continue
        assert (mr.total_bytes, mr.gather_work) == (
            pmr.total_bytes, pmr.gather_work), (i, low._kernel_desc())
        counted += 1
    assert counted or pchains, "no kernel was counted"
