"""Port parity: the data, checkpoint and IO modules (exprgrad_torch/io,
exprgrad_torch/graphics, exprgrad_torch/utils, ``Model.summary``).

``Batches``, ``Prefetcher`` and ``fit_epochs`` on the CPU train to the
same parameters as a per-batch loop, and as the JAX package's
``fit_epochs``; ``CheckpointManager`` keeps the last K, finds the latest,
restores onto a device, and ``train(checkpoint=)`` resumes to the same
parameters as an unbroken run.  The file formats (IDX, PPM, CSV, JSON),
the BPE tokenizer, DOT graphs, SVG canvases and the summary text equal
the JAX package's output on the same input, and each package reads the
other's files.
"""

import dataclasses
import importlib
import os
import threading

import numpy as np
import pytest
import torch

import exprgrad_torch as egt
import exprgrad_torch.models
import exprgrad_tpu
import exprgrad_tpu.models
from exprgrad_torch import graphics as port_graphics
from exprgrad_torch import io as port_io
from exprgrad_torch.io import csvfmt as port_csv
from exprgrad_torch.io import jsonformat as port_json
from exprgrad_torch.io import tokenizer
from exprgrad_torch.utils import native as port_native
from exprgrad_tpu import graphics as jax_graphics
from exprgrad_tpu import io as jax_io
from exprgrad_tpu.io import csvfmt as jax_csv
from exprgrad_tpu.io import jsonformat as jax_json
from exprgrad_tpu.utils import native as jax_native


def _graph(m, opt="adam"):
    y, x, it = m.iters("y", "x", "it")
    w = m.param([6, 4], (-0.5, 0.5), name="w")
    inp, lbl = m.input("inp"), m.input("lbl")
    pred = m.Fun("pred")
    pred[y, x] = inp[y, it] * w[it, x]
    layers = importlib.import_module(m.__name__ + ".layers")
    loss = layers.mse(pred, lbl)
    step = (m.make_opt(layers.adam, eta=0.01) if opt == "adam"
            else m.make_opt(layers.gradient_descent, rate=0.1))
    return loss.target("loss").backwards().optimize(step).target("train")


def _data(n=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"inp": rng.normal(size=(n, 6)).astype(np.float32),
            "lbl": rng.normal(size=(n, 4)).astype(np.float32)}


def _port(seed, opt="adam"):
    return egt.compile(_graph(egt, opt), seed=seed, device="cpu")


def _params(model):
    return {t: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for t, v in model.params.items()}


# --- native data plumbing ------------------------------------------------

def test_native_library_builds_outside_the_source_tree():
    lib = port_native.native_lib()
    if lib is not None:
        assert "build" in str(port_native._LIB_PATH).split(os.sep)
        assert not str(port_native._LIB_PATH).startswith(
            str(port_native._SOURCE.parent))


@pytest.mark.parametrize("fn,args", [
    ("shuffle_indices", (37, 5)),
    ("gather_rows", (np.arange(60, dtype=np.float32).reshape(12, 5),
                     np.array([3, 0, 11, 3, 7]))),
    ("u8_to_f32", (np.arange(256, dtype=np.uint8).reshape(16, 16),
                   1 / 255.0, -0.5)),
    ("one_hot_native", (np.array([3, 0, 9, 1]), 10)),
    ("crc32", (b"exprgrad", 7)),
])
def test_native_entry_points_match_the_jax_package(fn, args):
    got = getattr(port_native, fn)(*args)
    want = getattr(jax_native, fn)(*args)
    if port_native.have_native() == jax_native.have_native():
        np.testing.assert_array_equal(got, want)
    if fn == "shuffle_indices":
        assert sorted(got) == list(range(args[0]))


# --- Batches, Prefetcher, fit_epochs --------------------------------------

def test_batches_match_the_jax_package():
    data = _data(50)
    for shuffle in (False, True):
        port = list(port_io.Batches(data, 16, shuffle=shuffle, seed=3))
        ref = list(jax_io.Batches(data, 16, shuffle=shuffle, seed=3))
        assert len(port) == len(ref) == 3
        for a, b in zip(port, ref):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    assert len(port_io.Batches(data, 16, drop_tail=False)) == 4


def test_prefetcher_yields_identical_batches_on_the_cpu():
    data = _data(50)
    direct = list(port_io.Batches(data, 16, shuffle=True, seed=3))
    fetched = list(port_io.Prefetcher(
        port_io.Batches(data, 16, shuffle=True, seed=3), depth=2,
        dtype=np.float64, placement="cpu"))
    assert len(fetched) == 3
    for a, b in zip(direct, fetched):
        for k in a:
            assert isinstance(b[k], torch.Tensor)
            assert b[k].device.type == "cpu" and b[k].dtype == torch.float64
            np.testing.assert_array_equal(a[k], b[k].numpy())
    hosted = list(port_io.Prefetcher(port_io.Batches(data, 16), depth=1,
                                     to_device=False))
    assert isinstance(hosted[0]["inp"], np.ndarray)


def test_prefetcher_refuses_a_mesh_placement():
    with pytest.raises(NotImplementedError, match="A14"):
        port_io.Prefetcher([], placement=object())


def test_prefetcher_producer_error_reraises_and_thread_stops():
    def bad():
        yield {"x": np.zeros((2, 2))}
        raise ValueError("boom in producer")

    it = iter(port_io.Prefetcher(bad(), depth=1, placement="cpu"))
    next(it)
    with pytest.raises(ValueError, match="boom in producer"):
        next(it)
    it = iter(port_io.Prefetcher(port_io.Batches(_data(64), 4), depth=1,
                                 placement="cpu"))
    next(it)
    it.close()
    assert not [t for t in threading.enumerate()
                if t.name == "egt-prefetch" and t.is_alive()]
    with pytest.raises(ValueError):
        port_io.Prefetcher([], depth=0)


def test_fit_epochs_matches_the_per_batch_loop_and_jax():
    data = _data(64)
    looped = _port(11)
    batches = port_io.Batches(data, 16, shuffle=True, seed=5)
    for _ in range(3):
        looped.epoch += 1
        for batch in batches:
            looped.apply("train", batch)
    epochs = _port(11)
    port_io.fit_epochs(epochs, "train",
                       port_io.Batches(data, 16, shuffle=True, seed=5),
                       epochs=3, prefetch=2)
    ref = exprgrad_tpu.compile(_graph(exprgrad_tpu), backend="jax", seed=11)
    jax_io.fit_epochs(ref, "train",
                      jax_io.Batches(data, 16, shuffle=True, seed=5),
                      epochs=3)
    assert looped.epoch == epochs.epoch == ref.epoch == 3
    for tid, value in _params(ref).items():
        np.testing.assert_array_equal(epochs.params[tid].numpy(),
                                      looped.params[tid].numpy())
        np.testing.assert_allclose(epochs.params[tid].numpy(), value,
                                   rtol=1e-5, atol=1e-6)


def test_model_apply_takes_a_device_batch_without_a_copy():
    model = _port(2)
    batch = {k: torch.from_numpy(v) for k, v in _data(16).items()}
    assert model._to_device(batch["inp"]) is batch["inp"]
    host = model.call("loss", _data(16))
    np.testing.assert_array_equal(model.call("loss", batch), host)


# --- CheckpointManager ----------------------------------------------------

def test_rotation_and_latest(tmp_path):
    mgr = port_io.CheckpointManager(str(tmp_path), keep=2)
    m = _port(0)
    for _ in range(5):
        m.fit("train", _data(), batch_size=16, log_status=False)
        mgr.save(m)
    assert mgr.steps() == [4, 5] and mgr.latest() == 5
    assert sorted(os.listdir(tmp_path)) == ["step_4.egt", "step_5.egt"]


@pytest.mark.parametrize("shuffle", [False, True])
def test_resume_matches_uninterrupted(tmp_path, shuffle):
    data = _data()
    kw = dict(batch_size=16, log_status=False, shuffle=shuffle)
    straight = _port(9)
    for _ in range(6):
        straight.fit("train", data, **kw)
    mgr = port_io.CheckpointManager(str(tmp_path), keep=2)
    first = _port(9)
    for _ in range(3):
        first.fit("train", data, **kw)
    mgr.save(first)
    resumed = mgr.restore(device="cpu")
    assert resumed.epoch == 3 and resumed.device.type == "cpu"
    for _ in range(3):
        resumed.fit("train", data, **kw)
    for tid, value in _params(straight).items():
        np.testing.assert_array_equal(resumed.params[tid].numpy(), value)


def test_train_checkpoint_resumes_like_an_unbroken_run(tmp_path):
    data, val = _data(), _data(16, seed=1)
    kw = dict(batch_size=16, monitor="loss", validation=val)
    unbroken = _port(3)
    egt.train(unbroken, "train", data, epochs=4, restore_best=False, **kw)
    mgr = port_io.CheckpointManager(str(tmp_path), keep=10)
    first = _port(3)
    egt.train(first, "train", data, epochs=2, checkpoint=mgr,
              checkpoint_every=1, restore_best=False, **kw)
    assert mgr.steps() == [1, 2]
    resumed = mgr.restore(device="cpu")
    history = egt.train(resumed, "train", data, epochs=2, checkpoint=mgr,
                        checkpoint_every=2, restore_best=False, **kw)
    assert [h["epoch"] for h in history] == [3, 4]
    assert mgr.steps() == [1, 2, 4]
    for tid, value in _params(unbroken).items():
        np.testing.assert_array_equal(resumed.params[tid].numpy(), value)
        np.testing.assert_array_equal(
            mgr.restore(step=4, device="cpu").params[tid].numpy(), value)


def test_checkpoints_cross_packages(tmp_path):
    port = _port(4)
    port.fit("train", _data(), batch_size=16, log_status=False)
    port_io.CheckpointManager(str(tmp_path / "p")).save(port)
    ref = jax_io.CheckpointManager(str(tmp_path / "p")).restore()
    for tid, value in _params(port).items():
        np.testing.assert_array_equal(np.asarray(ref.params[tid]), value)
    jax_io.CheckpointManager(str(tmp_path / "j")).save(ref, step=7)
    back = port_io.CheckpointManager(str(tmp_path / "j")).restore(
        device="cpu")
    assert back.epoch == 1
    for tid, value in _params(port).items():
        np.testing.assert_array_equal(back.params[tid].numpy(), value)


def test_checkpoint_manager_errors(tmp_path):
    mgr = port_io.CheckpointManager(str(tmp_path), keep=1)
    with pytest.raises(egt.ModelRuntimeError, match="no checkpoints"):
        mgr.restore(device="cpu")
    with pytest.raises(egt.ModelRuntimeError, match="keep must be"):
        port_io.CheckpointManager(str(tmp_path), keep=0)
    with pytest.raises(NotImplementedError, match="A14"):
        port_io.CheckpointManager(str(tmp_path), sharded=True)
    m = _port(4)
    with pytest.raises(egt.ModelRuntimeError, match="sharded=True"):
        mgr.save(m, async_save=True)
    mgr.save(m)
    with pytest.raises(egt.ModelRuntimeError, match="not found"):
        mgr.restore(step=999, device="cpu")
    with pytest.raises(NotImplementedError, match="A14"):
        mgr.restore(mesh=object(), device="cpu")


# --- file formats ---------------------------------------------------------

@pytest.mark.parametrize("name,array", [
    ("u8.idx", np.arange(60, dtype=np.uint8).reshape(3, 4, 5)),
    ("f32.idx.gz", np.linspace(-1, 1, 24, dtype=np.float32).reshape(4, 6)),
    ("i32.idx", np.arange(-5, 5, dtype=np.int32)),
])
def test_idx_round_trip_equals_the_jax_package(tmp_path, name, array):
    port_path, jax_path = tmp_path / ("p" + name), tmp_path / ("j" + name)
    port_io.save_idx(array, str(port_path))
    jax_io.save_idx(array, str(jax_path))
    if not name.endswith(".gz"):  # gzip headers carry a time stamp
        assert port_path.read_bytes() == jax_path.read_bytes()
    for path in (port_path, jax_path):
        got = port_io.load_idx(str(path))
        assert got.dtype == jax_io.load_idx(str(path)).dtype
        np.testing.assert_array_equal(got, array)


@pytest.mark.parametrize("shape", [(5, 7, 3), (6, 4)])
def test_ppm_round_trip_equals_the_jax_package(tmp_path, shape):
    image = np.random.default_rng(0).integers(0, 256, shape).astype(
        np.uint8)
    port_io.save_ppm(image, str(tmp_path / "p.ppm"))
    jax_io.save_ppm(image, str(tmp_path / "j.ppm"))
    assert ((tmp_path / "p.ppm").read_bytes()
            == (tmp_path / "j.ppm").read_bytes())
    np.testing.assert_array_equal(port_io.load_ppm(str(tmp_path / "p.ppm")),
                                  jax_io.load_ppm(str(tmp_path / "j.ppm")))
    np.testing.assert_array_equal(port_io.load_ppm(str(tmp_path / "j.ppm")),
                                  image)
    (tmp_path / "a.ppm").write_text("P2\n2 1\n255\n7 200\n")
    np.testing.assert_array_equal(port_io.load_ppm(str(tmp_path / "a.ppm")),
                                  jax_io.load_ppm(str(tmp_path / "a.ppm")))


def test_csv_equals_the_jax_package(tmp_path):
    path = tmp_path / "rows.csv"
    path.write_text("label,score,flag,name\n3,0.5,yes,a\n1,,0,b\n")

    def rows(csvfmt):
        @dataclasses.dataclass
        class Row:
            label: int
            value: float = csvfmt.csv_column("score")
            flag: bool = False
            name: str = ""
        return [dataclasses.astuple(r)
                for r in csvfmt.iter_csv(str(path), Row)]

    assert rows(port_csv) == rows(jax_csv) == [(3, 0.5, True, "a"),
                                               (1, 0.0, False, "b")]
    cols = {"label": int, "score": float}
    assert (port_csv.load_csv_columns(str(path), cols)
            == jax_csv.load_csv_columns(str(path), cols))


def test_json_equals_the_jax_package(tmp_path):
    value = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
             "n": np.int64(4), "tag": "x", "list": [1.5, 2]}
    text = port_json.dumps(value, sort_keys=True)
    assert text == jax_json.dumps(value, sort_keys=True)
    back = port_json.loads(text)
    np.testing.assert_array_equal(back["w"], value["w"])
    port_json.save_json(value, str(tmp_path / "v.json"))
    np.testing.assert_array_equal(
        jax_json.load_json(str(tmp_path / "v.json"))["w"], value["w"])


TEXT = ("the cat sat on the mat. the dog sat on the log. " * 4
        + "naïve café — ünïcode ✓")


def test_tokenizer_equals_the_jax_package(tmp_path):
    port = port_io.BPETokenizer.train(TEXT, vocab_size=300)
    ref = jax_io.BPETokenizer.train(TEXT, vocab_size=300)
    assert port.merges == ref.merges and port.vocab_size == ref.vocab_size
    ids = port.encode(TEXT)
    np.testing.assert_array_equal(ids, ref.encode(TEXT))
    # the Python merge loop (the path without the native library)
    python_ids = [t for chunk in tokenizer._SPLIT.findall(TEXT)
                  for t in port._encode_chunk(chunk.encode("utf-8"))]
    np.testing.assert_array_equal(ids, python_ids)
    assert port.decode(ids) == TEXT
    port.save(str(tmp_path / "tok.json"))
    loaded = jax_io.BPETokenizer.load(str(tmp_path / "tok.json"))
    np.testing.assert_array_equal(loaded.encode(TEXT), ids)
    assert port_io.BPETokenizer.load(str(tmp_path / "tok.json")).merges \
        == port.merges


# --- graphics and the summary ---------------------------------------------

def test_dot_graph_equals_the_jax_package():
    port = egt.compile(egt.models.fashion_mnist_cnn(), seed=0, device="cpu")
    ref = exprgrad_tpu.compile(exprgrad_tpu.models.fashion_mnist_cnn(),
                               seed=0, backend="interp")
    for target in ("predict", "loss"):
        got = port_graphics.to_dot_graph(port.program, target)
        assert got == jax_graphics.to_dot_graph(ref.program, target)
        assert got.startswith("digraph")


def test_canvas_equals_the_jax_package():
    def draw(graphics):
        grid = graphics.GridLayout(columns=2, cell_width=120, cell_height=90)
        c = grid.add()
        c.line(0, 0, 50, 40, color="red", width=2.0)
        c.rect(5, 5, 30, 20, fill="#eee")
        c.circle(60, 30, 8)
        c.text(10, 80, "loss <1>", size=10.0)
        c.polyline([(0, 0), (10, 5), (20, 2)])
        c.plot([3.0, 1.5, 0.75, 0.5])
        grid.add().image(0, 0, 4, 4, np.arange(0, 256, 16).reshape(4, 4))
        return grid.render().to_svg()

    assert draw(port_graphics) == draw(jax_graphics)


def test_summary_equals_the_jax_package():
    kw = dict(vocab=8, dim=16, heads=2, hidden=32, max_seq=16)
    ref = exprgrad_tpu.compile(exprgrad_tpu.models.flash_transformer(**kw),
                               backend="jax", seed=0)
    port = egt.from_state(egt.models.flash_transformer(**kw), ref.params,
                          ref.caches, ref.epoch, device="cpu")
    assert port.summary() == ref.summary()
    assert port.summary().startswith("Model: ")
    ref.epoch += 1
    toks = np.zeros((2, 8), np.float32)
    ref.apply("train", {"tokens": toks,
                        "labels": np.eye(8, dtype=np.float32)[toks.astype(
                            int)]})
    port = egt.from_state(egt.models.flash_transformer(**kw), ref.params,
                          ref.caches, ref.epoch, device="cpu")
    assert port.summary() == ref.summary()
