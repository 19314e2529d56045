"""The serving step's float32 weight products on the weight-streaming
kernel (``csrc/gemm_skinny_sm90.cu``).

``ops.matmul.weight_product`` sends a product whose weight sees at most
32 rows, with float32 CUDA operands in a layout the kernel reads, to the
kernel, and everything else to ``torch.matmul`` / ``torch.einsum`` as
the call sites ran before.  The CPU tests hold the routing rule (shapes,
dtypes, devices, strides, autograd), the counters, the plain twin (the
operands read as the kernel reads them, one float64 ``bmm``) against
torch, the kernel's block plan, and its split-TF32 summation emulated
with ``ops/tf32.py``'s split against float64.  The tests marked ``gpu``
run the kernel at every decode shape of the serving cells (Mistral-7B
and Jamba2-Mini, ``chip_smoke.DECODE_GEMMS``) against float64, twice for the same bits, and inside a
chunk's CUDA graph (run on the card with ``python -m pytest --noconftest
tests/test_torch_skinny_gemm.py -m gpu``, which skips this directory's
conftest and its import of jax).
"""

import numpy as np
import pytest
import torch

from chip_smoke import DECODE_GEMMS, decode_weight, decode_x_shape
from exprgrad_torch.ops import matmul as mm
from exprgrad_torch.ops.tf32 import split, tf32_matmul

SLOTS = 2 * 132  # the kernel's blocks an H100 holds at once


def _rand(*shape, scale=1.0, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape) * scale).to(dtype)


# -- routing (CPU) --------------------------------------------------------

def _reason(x, w, spec=None):
    return mm.skinny_decision(x, w, spec)[1]


ON_CPU = "tensors on cpu and cpu"

ROUTES = {
    # name: (x shape, w shape, spec, reason)
    "32 rows": ((32, 64), (64, 96), None, ON_CPU),
    "32 rows over two axes": ((4, 8, 64), (64, 96), None, ON_CPU),
    "one row": ((64,), (64, 96), None, ON_CPU),
    "16 experts of 32 rows, shared x": ((32, 64), (16, 64, 96), None,
                                        ON_CPU),
    "16 experts of 32 rows each": ((16, 32, 64), (16, 64, 96), None,
                                   ON_CPU),
    "q heads": ((32, 1, 256), (2, 256, 128), mm.HEADS_IN, ON_CPU),
    "o heads": ((32, 2, 1, 128), (2, 128, 256), mm.HEADS_OUT, ON_CPU),
    "32-token prompt, q heads": ((1, 32, 256), (2, 256, 128), mm.HEADS_IN,
                                 ON_CPU),
    "head width 64": ((8, 1, 256), (4, 256, 64), mm.HEADS_IN,
                      "head width 64 is not a multiple of 128"),
    "k 66": ((8, 66), (66, 96), None, "k 66 is not a multiple of 4"),
    "a 1-d weight": ((8, 64), (64,), None, "no kernel form for these shapes"),
    "33 rows": ((33, 64), (64, 96), None, None),
    "33 rows a expert": ((33, 64), (4, 64, 96), None, None),
    "no rows": ((0, 64), (64, 96), None, None),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_route_by_shape(name):
    xs, ws, spec, want = ROUTES[name]
    x, w = torch.zeros(xs), torch.zeros(ws)
    assert _reason(x, w, spec) == want


def test_float64_goes_to_torch():
    x, w = torch.zeros(8, 64, dtype=torch.float64), torch.zeros(64, 96)
    assert _reason(x, w) == "torch.float64 and torch.float32, not float32"
    assert _reason(x.float(), w.double()).startswith("torch.float32 and")


@pytest.mark.parametrize("which", ["columns", "k stride", "address"])
def test_weight_layouts_it_does_not_take(which):
    x = torch.zeros(8, 64)
    wide = torch.zeros(64, 200)
    if which == "columns":  # [k, n] read through its transpose
        w, want = torch.zeros(96, 64).t(), "columns are not unit-stride"
    elif which == "k stride":  # rows 198 floats apart: not 16-byte
        w, want = wide.as_strided((64, 96), (198, 1)), "not 16-byte"
    else:  # one float in: 4 bytes off the 16-byte grid
        w, want = wide[:, 1:97], "not 16-byte"
    assert want in _reason(x, w)


def test_a_slice_of_a_wider_weight_is_taken():
    """A weight read at a 16-byte offset with a wider row: the layout is
    the kernel's (only the device sends it to torch here)."""
    w = torch.zeros(64, 200)[:, 4:100]
    assert _reason(torch.zeros(8, 64), w) == ON_CPU


def test_o_weight_whose_heads_do_not_merge():
    w = torch.zeros(2, 256, 128).transpose(0, 1).contiguous().transpose(0, 1)
    assert _reason(torch.zeros(4, 2, 1, 128), w[:, :128], mm.HEADS_OUT) == (
        "the weight's head and width axes do not merge")


def test_autograd_goes_to_torch():
    x = torch.zeros(8, 64, requires_grad=True)
    assert _reason(x, torch.zeros(64, 96)) == "autograd records the product"
    with torch.no_grad():
        assert _reason(x, torch.zeros(64, 96)) == ON_CPU


def test_an_einsum_it_does_not_know_raises():
    with pytest.raises(ValueError, match="takes no einsum"):
        mm.skinny_decision(torch.zeros(4, 64), torch.zeros(64, 8), "ab,bc->ac")


@pytest.mark.parametrize("rows,declined", [(32, 1), (33, 0), (1, 1)])
def test_counters_on_the_cpu(rows, declined):
    """On the CPU every product goes to torch, bit for bit as before; one
    of at most 32 rows counts as declined."""
    x, w = _rand(rows, 64), _rand(64, 96, seed=1)
    launches, before = mm.skinny_launches, mm.skinny_declined
    got = mm.weight_product(x, w)
    assert torch.equal(got, x @ w)
    assert mm.skinny_declined - before == declined
    assert mm.skinny_launches == launches


def test_einsums_on_the_cpu_are_torch_einsum():
    x, wq = _rand(4, 1, 256), _rand(2, 256, 128, seed=1)
    assert torch.equal(mm.weight_product(x, wq, mm.HEADS_IN),
                       torch.einsum(mm.HEADS_IN, x, wq))
    att, wo = _rand(4, 2, 1, 128, seed=2), _rand(2, 128, 256, seed=3)
    assert torch.equal(mm.weight_product(att, wo, mm.HEADS_OUT),
                       torch.einsum(mm.HEADS_OUT, att, wo))


# -- the plain twin against torch (CPU, reduced k) ------------------------

TWIN = {
    # name: (x shape, w shape, spec)
    "decode rows": ((23, 1, 64), (64, 320), None),
    "one row": ((64,), (64, 96), None),
    "experts, shared x": ((32, 64), (16, 64, 96), None),
    "experts, own x": ((16, 23, 64), (16, 64, 96), None),
    "experts, x broadcast from one": ((1, 8, 64), (4, 64, 96), None),
    "q, head-strided [h, c, d]": ((32, 1, 64), (4, 64, 128), mm.HEADS_IN),
    "q, 32-token prompt": ((1, 32, 64), (2, 64, 128), mm.HEADS_IN),
    "q, two rows of 16 tokens": ((2, 16, 64), (2, 64, 128), mm.HEADS_IN),
    "o, decode": ((32, 4, 1, 16), (4, 16, 96), mm.HEADS_OUT),
    "o, 32-token prompt": ((1, 4, 32, 16), (4, 16, 96), mm.HEADS_OUT),
}


@pytest.mark.parametrize("name", list(TWIN))
def test_plain_twin_matches_torch(name):
    xs, ws, spec = TWIN[name]
    x = _rand(*xs, dtype=torch.float64)
    w = _rand(*ws, seed=1, dtype=torch.float64)
    got = mm.weight_product_plain(x, w, spec)
    want = mm._torch_product(x, w, spec)
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_plain_twin_reads_a_strided_weight():
    """A weight with a wider row (a slice) and a head-strided [h, c, d]
    cut from a bigger one: the twin reads them through their strides."""
    x = _rand(8, 64, dtype=torch.float64)
    wide = _rand(64, 200, seed=1, dtype=torch.float64)
    torch.testing.assert_close(mm.weight_product_plain(x, wide[:, 4:100]),
                               x @ wide[:, 4:100], rtol=1e-12, atol=1e-12)
    heads = _rand(4, 64, 256, seed=2, dtype=torch.float64)[:, :, :128]
    xq = _rand(8, 1, 64, seed=3, dtype=torch.float64)
    torch.testing.assert_close(
        mm.weight_product_plain(xq, heads, mm.HEADS_IN),
        torch.einsum(mm.HEADS_IN, xq, heads), rtol=1e-12, atol=1e-12)


def test_plain_twin_keeps_the_input_dtype():
    x, w = _rand(8, 64), _rand(64, 96, seed=1)
    got = mm.weight_product_plain(x, w)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, (x.double() @ w.double()).float())


# -- the block plan (CPU) -------------------------------------------------

def _plan_shape(x_shape, w_shape, spec):
    """(weight columns, k, groups) of a product, as the kernel reads it."""
    form, why = mm._skinny_form(torch.empty(x_shape, device="meta"),
                                torch.empty(w_shape, device="meta"), spec)
    assert why is None, why
    return form.n, form.k, form.g


# every decode product of the two chat cells, and a small one
CELL_SHAPES = {label: _plan_shape(decode_x_shape(xs, 32), ws, spec)
               for label, xs, ws, spec, *_ in DECODE_GEMMS}
CELL_SHAPES["small"] = (96, 64, 1)


@pytest.mark.parametrize("name", list(CELL_SHAPES))
def test_plan_covers_every_stage_once(name):
    n, k, g = CELL_SHAPES[name]
    tiles, k_tiles = g * -(-n // 128), -(-k // 32)
    per, grid = mm.skinny_plan(tiles, k_tiles, SLOTS)
    units = tiles * k_tiles
    assert (grid - 1) * per < units <= grid * per
    # whole tiles, or a tile's k in equal parts (blocks in step along k)
    assert per % k_tiles == 0 or (k_tiles % per == 0
                                  and k_tiles // per <= mm.SKINNY_PIECES)

    def time(per):  # rounds of blocks, each its stages and its start
        return -(-(-(-units // per)) // SLOTS) * (per + mm.SKINNY_BLOCK_COST)

    # no whole number of tiles a block gives less time
    assert all(time(per) <= time(j * k_tiles) for j in range(1, tiles + 1))


# (tiles, k_tiles): per, grid
PLANS = {
    "mistral w1 [4096, 14336]: each tile's k in 2": ((112, 128), (64, 224)),
    "mistral w2 [14336, 4096]: each tile's k in 8": ((32, 448), (56, 256)),
    "mistral wq [4096, 4096]: each tile's k in 8": ((32, 128), (16, 256)),
    "mistral head: a tile a block": ((250, 128), (128, 250)),
    "jamba head: two tiles a block": ((512, 128), (256, 256)),
    "jamba experts wd: two tiles a block": ((512, 448), (896, 256)),
    "jamba x_proj: k in 16 at most": ((3, 256), (16, 48)),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_plan_at_the_cells_shapes(name):
    (tiles, k_tiles), want = PLANS[name]
    assert mm.skinny_plan(tiles, k_tiles, SLOTS) == want


def test_plan_of_a_tiny_product():
    assert mm.skinny_plan(1, 1, SLOTS) == (1, 1)
    assert mm.skinny_plan(3, 2, SLOTS) == (1, 6)
    assert mm.skinny_plan(5, 129, SLOTS) == (43, 15)  # 129 = 3 x 43


# -- the kernel's arithmetic, emulated (CPU) ------------------------------

def skinny_gemm(x, w, per, group=32):
    """``x @ w`` (``x`` [m, k], ``w`` [k, n]: one column tile) as the
    kernel sums it when each of its blocks takes ``per`` stages of
    ``group`` k: a stage's w.big . x.big and w.small . x.big in one fresh
    float32 accumulator, w.big . x.small in another, their sum (the
    small term first) added to the block's running sum, and the blocks'
    pieces added in k order from 0."""
    (x_big, x_small), (w_big, w_small) = split(x), split(w)
    stages = -(-x.shape[-1] // group)
    pieces = []
    for first in range(0, stages, per):
        run = None
        for st in range(first, min(stages, first + per)):
            s = slice(st * group, (st + 1) * group)
            low = x_big[:, s] @ w_big[s] + x_big[:, s] @ w_small[s]
            part = x_small[:, s] @ w_big[s] + low
            run = part if run is None else run + part
        pieces.append(run)
    total = pieces[0]
    for piece in pieces[1:]:
        total = total + piece
    return total


@pytest.mark.parametrize("k,per", [(4096, 32), (4096, 128), (14336, 109),
                                   (256, 3)])
def test_emulated_sum_within_the_cards_tolerance(k, per):
    """Split TF32 with a fresh accumulator a 32-deep stage and the blocks'
    pieces added in k order stays within rtol = atol = 1e-5 of float64 at
    the cells' widths (weights at the configurations' 0.02, activations
    of unit scale); one TF32 pass does not."""
    x = _rand(32, k, seed=k)
    w = _rand(k, 256, scale=0.02, seed=k + 1)
    want = x.double() @ w.double()
    got = skinny_gemm(x, w, per)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    single = tf32_matmul(x, w).double()
    assert not torch.allclose(single, want, rtol=1e-5, atol=1e-5)


# -- on the card ----------------------------------------------------------

CARD = [(label, m) for label, *_ in DECODE_GEMMS for m in (1, 8, 23, 32)]
_weights: dict = {}


def _weight(label, shape):
    """One weight a product for the module (a few GB at most together)."""
    if label not in _weights:
        _weights.clear()
        gen = torch.Generator(device="cuda").manual_seed(len(label))
        _weights[label] = decode_weight(shape, "cuda", gen)
    return _weights[label]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("runs the CUDA kernel: needs an NVIDIA GPU")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD, ids=[f"{n} m{m}" for n, m in CARD])
def test_kernel_at_the_decode_shapes(case):
    """Within rtol = atol = 1e-5 of float64, the same bits twice, one
    launch a call and none declined."""
    _need_card()
    label, m = case
    _, xs, ws, spec, *_ = next(s for s in DECODE_GEMMS if s[0] == label)
    w = _weight(label, ws)
    gen = torch.Generator(device="cuda").manual_seed(m)
    x = torch.randn(decode_x_shape(xs, m), device="cuda", generator=gen)
    form, why = mm.skinny_decision(x, w, spec)
    assert form is not None and why is None, why
    launches, declined = mm.skinny_launches, mm.skinny_declined
    got = mm.weight_product(x, w, spec)
    again = mm.weight_product(x, w, spec)
    torch.cuda.synchronize()
    assert (mm.skinny_launches - launches, mm.skinny_declined) == (
        2, declined)
    assert torch.equal(got, again)
    want = mm.weight_product_plain(x.double(), w, spec)
    assert got.shape == want.shape
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_kernel_in_a_chunk_graph():
    """Captured in a chunk graph (models/_chunk.py) the kernel gives the
    eager result at each replay, and each replay adds its launches back
    to ``skinny_launches``."""
    _need_card()
    from exprgrad_torch.models._chunk import ChunkGraph

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    w = torch.randn(4096, 3 * 1024, device=dev, generator=gen) * 0.02
    x = torch.randn(32, 1, 4096, device=dev, generator=gen)
    box = torch.zeros(32, 1, 3 * 1024, device=dev)
    slots, width, steps_n = 4, 2, 3

    def steps(tok, pos, stop_at, table, temp, top_k, top_p, n=steps_n):
        for _ in range(n):
            box.copy_(mm.weight_product(x, w))
            x.add_(0.0)
        return tok.new_zeros((n, slots)), tok, pos

    ints = np.zeros(3 * slots + slots * width, dtype=np.int32)
    floats = np.zeros(3 * slots, dtype=np.float32)
    before = mm.skinny_launches
    graph = ChunkGraph(steps, slots, width, [], dev, ints, floats)
    assert mm.skinny_launches - before == 1  # the eager warm-up step
    eager = mm.weight_product(x, w)
    for replay in range(2):
        box.zero_()
        graph.launch(ints, floats, []).tokens()
        assert torch.equal(box, eager)
        assert mm.skinny_launches - before == 2 + steps_n * (replay + 1)
