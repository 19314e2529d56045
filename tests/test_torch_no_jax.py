"""The port runs without jax and without the JAX package: import,
compile, predict and generate, continuous batching over a paged pool
through the paged-attention kernel's plain version, the server's int8
weights, ragged, scoring, beam, speculative and lookup modes and the
batcher's speculative rounds, weight quantization, a scheduled MLP
(chip_smoke.py's program, narrow), a scheduled softmax row chain and
scatter-add (the generated kernels' plain versions), and train (steps,
fit, the scan epoch, checkpoints, EMA, the training driver), the
encoder-decoder server and batcher (plain and lookup), the recurrent
server, and ``export_compiled``/``load_compiled`` of a seq2seq predict,
on the CPU in a fresh interpreter where ``import jax`` and
``import exprgrad_tpu`` fail.  The CUDA sources define every entry point the ctypes binding
names, with its parameter types (nvcc cannot run here).

The check runs in a subprocess because this test process already holds
both (the parity tests import them); ``sys.modules[name] = None`` makes
any later import of ``name`` raise ImportError.
"""

import ctypes
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import exprgrad_torch as egt
from exprgrad_torch.models import flash_transformer

REPO = Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None
    sys.modules["exprgrad_tpu"] = None
    import numpy as np
    import torch
    import exprgrad_torch as egt
    from exprgrad_torch.models import FlashLMServer, flash_transformer

    model = egt.compile(flash_transformer(vocab=12, dim=16, heads=2,
                                          kv_heads=1, blocks=1, max_seq=32),
                        seed=0, device="cpu")
    toks = np.random.default_rng(0).integers(0, 12, (2, 16)).astype(
        np.float32)
    probs = model.call("predict", {"tokens": toks})
    assert probs.shape == (2, 16, 12), probs.shape
    assert np.allclose(probs.sum(-1), 1.0, atol=1e-5)
    assert model.lowering_stats("predict")["attention-impl:flash"] == 1
    out = FlashLMServer(model).generate(toks[:, :8], n_new=5)
    assert out.shape == (2, 5), out.shape

    # continuous batching over a paged int8 pool, attending the pages
    # through the paged-attention kernel's plain version
    from exprgrad_torch.models import ContinuousBatcher
    from exprgrad_torch.ops import paged, paged_attention
    b = ContinuousBatcher(FlashLMServer(model, cache_dtype=torch.int8),
                          slots=2, capacity=32, paged=True, page_size=4,
                          pool_pages=6, attention="flash")
    rids = [b.submit(t, 6) for t in toks[:3, :9]]
    done = b.run()
    assert all(done[r].shape == (6,) for r in rids), done
    assert b.stats["preemptions"] > 0, b.stats
    assert b.stats["free_pages"] == 6 and paged_attention.launches == 0

    # the decoder server's other modes and the speculative rounds: int8
    # weights, ragged prompts, scoring, beam, speculative and lookup
    # decoding, and the batcher's draft and lookup rounds through the
    # paged-attention kernel's plain version
    import exprgrad_torch.quant, exprgrad_torch.models._quant
    import exprgrad_torch.models._beam, exprgrad_torch.models._spec
    srv = FlashLMServer(model, cache_dtype=torch.float32)
    q8 = FlashLMServer(model, weight_dtype=torch.int8)
    assert q8.weight_bytes() < srv.weight_bytes() / 2
    assert q8.generate(toks[:, :8], n_new=3, lengths=[8, 5]).shape == (2, 3)
    assert srv.score(toks).shape == (2,)
    seqs, scores = srv.generate_beam(toks[:1, :8], n_new=3, beams=2)
    assert seqs.shape == (1, 2, 3) and scores.shape == (1, 2)
    spec, _ = srv.generate_speculative(srv, toks[:1, :8], n_new=6, k=2)
    look, _ = srv.generate_lookup(toks[:1, :8], n_new=6, k=2)
    want = srv.generate(toks[:1, :8], n_new=6).numpy()
    assert np.array_equal(spec.numpy(), want), (spec, want)
    assert np.array_equal(look.numpy(), want), (look, want)
    for kw in (dict(draft=srv), dict(lookup=True)):
        b = ContinuousBatcher(srv, slots=2, capacity=32, paged=True,
                              page_size=4, attention="flash", spec_k=2, **kw)
        rids = [b.submit(t, 5) for t in toks[:3, :9]]
        done = b.run()
        assert all(done[r].shape == (5,) for r in rids), done
        assert b.stats["spec_rounds"] > 0, b.stats
    quant = egt.compile(flash_transformer(vocab=12, dim=16, heads=2,
                                          blocks=1, max_seq=32),
                        seed=0, device="cpu")
    assert quant.quantize_weights(min_size=64)
    assert quant.call("predict", {"tokens": toks}).shape == (2, 16, 12)

    import exprgrad_torch.layers
    from chip_smoke import scheduled_mlp
    mlp = egt.compile(scheduled_mlp(egt, dim=8, hidden=16, tile=8), seed=0,
                      schedule_mode="force", device="cpu")
    rows = np.random.default_rng(1).normal(size=(12, 8)).astype(np.float32)
    assert mlp.call("predict", {"v": rows}).shape == (12, 8)
    assert mlp.lowering_stats("predict") == {"matmul-fused": 2}

    # the generated map/reduce and row-chain kernels (their plain
    # versions on the CPU), built by the modules of B5 and B6
    from chip_smoke import fam_scatter_add, softmax_chain
    import exprgrad_torch.backend.mapreduce, exprgrad_torch.backend.rowchain
    import exprgrad_torch.ops.mapreduce, exprgrad_torch.ops.rowchain
    import exprgrad_torch.utils.triton_build
    for build, stat in ((lambda m: softmax_chain(m, {"y": 16}, 32, 64),
                         {"rowchain": 1}), (fam_scatter_add,
                                            {"mapreduce": 1})):
        graph, args = build(egt)
        prog = egt.compile(graph, seed=0, schedule_mode="force",
                           device="cpu")
        name = next(iter(prog.program.targets))
        assert np.isfinite(prog.call(name, args)).all()
        assert prog.lowering_stats(name) == stat, prog.lowering_stats(name)
    assert "triton" not in sys.modules  # imported only at a launch
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "exprgrad_tpu")
                    and sys.modules[m] is not None)
    assert not loaded, loaded
    print("NO_JAX_OK")
""")


TRAIN_SCRIPT = textwrap.dedent("""
    import os, sys, tempfile
    sys.modules["jax"] = None
    sys.modules["exprgrad_tpu"] = None
    import numpy as np
    import exprgrad_torch as egt
    from exprgrad_torch import io, make_opt
    from exprgrad_torch.layers import adam, with_ema
    from exprgrad_torch.models import flash_transformer

    graph = flash_transformer(vocab=8, dim=16, heads=2, kv_heads=1,
                              blocks=1, max_seq=16,
                              opt=with_ema(make_opt(adam, eta=0.01), 0.9))
    model = egt.compile(graph, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 8, (4, 8))
    data = {"tokens": toks.astype(np.float32),
            "labels": np.eye(8, dtype=np.float32)[(toks + 1) % 8]}
    model.epoch += 1
    model.apply("train", data)
    assert model.lowering_stats("train")["attention-grad-impl:flash"] == 1
    model.fit("train", data, batch_size=2, log_status=False,
              scan_batches=True)
    history = egt.train(model, "train", data, epochs=2, batch_size=2,
                        validation=data, patience=1)
    assert history and model.ema_params()
    path = os.path.join(tempfile.mkdtemp(), "model.egt")
    io.save_model(model, path)
    loaded = io.load_model(path, device="cpu")
    assert np.allclose(loaded.call("predict", {"tokens": data["tokens"]}),
                       model.call("predict", {"tokens": data["tokens"]}))

    # a CNN fit step on the conv path, an MoE and an LSTM train step
    from exprgrad_torch.models import fashion_mnist_cnn, tiny_recurrent_lm
    cnn = egt.compile(fashion_mnist_cnn(), seed=0, device="cpu")
    images = rng.normal(size=(4, 28, 28)).astype(np.float32)
    cnn.fit("fit", {"x": images, "y": np.eye(10, dtype=np.float32)[:4]},
            batch_size=4, log_status=False)
    assert cnn.lowering_stats("fit")["conv"] == 5
    for graph, op in ((flash_transformer(vocab=8, dim=16, heads=2,
                                         blocks=1, max_seq=16,
                                         moe_experts=4), "moe"),
                      (tiny_recurrent_lm(vocab=8, cell="lstm"), "lstm")):
        lm = egt.compile(graph, seed=0, device="cpu")
        lm.fit("train", data, batch_size=2, log_status=False)
        assert lm.lowering_stats("train")[f"extern:{op}_grad"] >= 1
    # fit_epochs, then a CheckpointManager round trip
    batches = io.Batches({"x": images, "y": np.eye(10, dtype=np.float32)[
        :4]}, 2, seed=1)
    io.fit_epochs(cnn, "fit", batches, epochs=1, prefetch=2)
    manager = io.CheckpointManager(tempfile.mkdtemp(), keep=1)
    manager.save(cnn)
    back = manager.restore(device="cpu")
    assert back.epoch == cnn.epoch == 2 and manager.steps() == [2]
    assert np.array_equal(back.call("predict", {"x": images}),
                          cnn.call("predict", {"x": images}))
    mods = sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "exprgrad_tpu")
                  and sys.modules[m] is not None)
    assert not mods, mods
    print("NO_JAX_OK")
""")


SEQ2SEQ_SCRIPT = textwrap.dedent("""
    import sys, tempfile
    sys.modules["jax"] = None
    sys.modules["exprgrad_tpu"] = None
    import numpy as np
    import torch
    import exprgrad_torch as egt
    from exprgrad_torch.models import (RecurrentServer, Seq2SeqBatcher,
                                       Seq2SeqServer, greedy_decode,
                                       tiny_recurrent_lm, tiny_seq2seq)

    s2s = egt.compile(tiny_seq2seq(vocab=8, dim=16, heads=2, max_src=16,
                                   max_tgt=16), seed=0, device="cpu")
    src = np.random.default_rng(0).integers(1, 8, (2, 6)).astype(np.float32)
    srv = Seq2SeqServer(s2s)
    out = srv.generate(src, n_new=5)
    assert np.array_equal(out.numpy(), greedy_decode(s2s, src, 5))
    assert srv.generate_beam(src, n_new=3, beams=2)[0].shape == (2, 2, 3)
    spec, _ = srv.generate_speculative(srv, src[:1], n_new=5, k=2)
    assert np.array_equal(spec.numpy(), out.numpy()[:1])
    assert srv.score(src, out.numpy())[0].shape == (2,)
    for kw in ({}, dict(lookup=True, spec_k=2)):
        b = Seq2SeqBatcher(srv, slots=2, **kw)
        rids = [b.submit(s, 5) for s in (src[0], src[1], src[0, :3])]
        done = b.run()
        assert np.array_equal(done[rids[0]], out.numpy()[0]), done
    rnn = egt.compile(tiny_recurrent_lm(vocab=8, cell="gru"), seed=0,
                      device="cpu")
    assert RecurrentServer(rnn).generate(src[:, :3], n_new=4).shape == (2, 4)

    data = s2s.export_compiled("predict", {"src": [2, 6], "tgt": [2, 3]})
    fn = egt.load_compiled(data)
    args = {"src": src, "tgt": src[:, :3]}
    assert np.allclose(fn(args).numpy(), s2s.call("predict", args),
                       rtol=1e-5, atol=1e-6)
    mods = sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "exprgrad_tpu")
                  and sys.modules[m] is not None)
    assert not mods, mods
    print("NO_JAX_OK")
""")


def _run_blocked(script):
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout


def test_port_runs_with_jax_blocked():
    _run_blocked(SCRIPT)


def test_port_trains_with_jax_blocked():
    _run_blocked(TRAIN_SCRIPT)


def test_port_serves_seq2seq_and_exports_with_jax_blocked():
    _run_blocked(SEQ2SEQ_SCRIPT)


def _c_type(param: str):
    """The ctypes type a C parameter declaration is bound with."""
    from exprgrad_torch.utils import kernels

    if "*" in param:
        return kernels._P
    kind = param.split()[-2] if len(param.split()) > 1 else param
    return {"int": kernels._I, "float": ctypes.c_float,
            "EpiProgram": kernels.EpiProgram}[kind]


def test_cuda_sources_define_every_bound_entry_point():
    """Each name in ``utils/kernels._SIGNATURES`` is an ``extern "C"``
    function of exactly one ``csrc/*.cu`` file, whose parameters have
    the bound argtypes in order — a mismatch would pass garbage through
    ctypes on the card."""
    from exprgrad_torch.utils import kernels

    sources = {src.name: src.read_text() for src in
               sorted(kernels._CSRC.glob("*.cu"))}
    assert "paged_attention.cu" in sources
    for name, argtypes in kernels._SIGNATURES.items():
        decl = f'extern "C" int {name}('
        found = [text for text in sources.values() if decl in text]
        assert len(found) == 1, name
        head = found[0][found[0].index(decl) + len(decl):]
        params = [p.strip() for p in head[:head.index(")")].split(",")]
        assert [_c_type(p) for p in params] == list(argtypes), name


def test_packed_argument_layouts_match_the_sources():
    """The packed launches of B2 and B1 (``egt_flash_fwd_packed``,
    ``egt_matmul_packed``) pass one struct each: the Python packing is as
    long as the C struct, whose size the sources assert, and the packed
    entry hands every field to the unpacked entry in order."""
    import re

    from exprgrad_torch.ops import attention, matmul
    from exprgrad_torch.utils import kernels

    for src, name, packer, entry in (
            ("flash_fwd.cu", "FlashFwdArgs", attention._FWD_ARGS,
             "egt_flash_fwd"),
            ("matmul.cu", "MatmulArgs", matmul._MATMUL_ARGS, "egt_matmul")):
        text = (kernels._CSRC / src).read_text()
        size = re.search(rf"sizeof\({name}\) == (\d+)", text)
        assert size and int(size.group(1)) == packer.size, (name, size)
        body = text[text.index(f"struct {name} {{"):]
        fields = re.findall(r"\b(\w+)(?=[,;])", body[:body.index("};")])
        call = text[text.index(f"{entry}_packed("):]
        call = call[call.index(f"return {entry}("):call.index(");")]
        assert re.findall(r"->(\w+)", call) == fields, (name, fields)


def test_compile_on_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    graph = flash_transformer(vocab=8, dim=8, heads=2, blocks=1)
    with pytest.raises(RuntimeError, match="is_available"):
        egt.compile(graph, seed=0)  # device="cuda" is the default
    with pytest.raises(RuntimeError, match="is_available"):
        egt.compile(graph, seed=0, device="cuda:0")
