"""The plain references against the port at tiny widths on the CPU."""

import numpy as np
import pytest
import torch

import exprgrad_torch as egt
from exprgrad_torch.model import Model
from exprgrad_torch.models import FlashLMServer

from portbench import weights
from portbench.drivers.serve_open import give_weights
from portbench.drivers.train_steps import build as build_train
from portbench.drivers.train_steps import first_moments, leaf_gaps
from portbench.reference import mistral as reference

from helpers import tiny_cell

CPU = torch.device("cpu")


def tiny_model(name, window=None):
    _, wl, cfg = tiny_cell(name)
    if window is not None:
        cfg["sliding_window"] = cfg["build"]["window"] = window
    source = egt.to_program(egt.models.flash_transformer(**cfg["build"]),
                            schedule_scope="cpu")
    model = Model(source, init_params=False, device="cpu")
    give_weights(model, cfg, 5, CPU)
    return cfg, wl, model


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("kv", [torch.float32, torch.bfloat16])
def test_serving_logits_match_the_server(window, kv):
    cfg, _, model = tiny_model("mistral7b.chat", window)
    server = FlashLMServer(model, cache_dtype=kv, eps=cfg["rms_norm_eps"])
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, 64, 20))
    got, _ = server.prefill(toks[None].float(), server.init_caches(1, 32))
    ref = reference.Weights(cfg, weights.make(cfg, 5, CPU))
    want = reference.logits(ref, toks, None if kv == torch.float32 else kv)
    assert torch.allclose(got[0], want, rtol=1e-5, atol=1e-5)


def test_predict_matches_the_reference_softmax():
    cfg, _, model = tiny_model("codestral22b.train")
    toks = np.random.default_rng(2).integers(0, 64, (1, 24))
    got = model.call("predict", {"tokens": toks.astype(np.float32)})
    ref = reference.Weights(cfg, weights.make(cfg, 5, CPU))
    want = torch.softmax(reference.logits(ref, torch.as_tensor(toks[0])), -1)
    assert np.allclose(got[0], want.numpy(), rtol=1e-5, atol=1e-7)


def test_train_step_matches_the_reference():
    _, wl, cfg = tiny_cell("codestral22b.train")
    ctx = type("C", (), {"config": cfg, "seed": 9, "device": CPU})
    model = build_train(ctx)
    ids = torch.as_tensor(np.random.default_rng(3).integers(0, 64, (2, 33)))
    labels = torch.nn.functional.one_hot(ids[:, 1:], 64).float()
    args = {"tokens": ids[:, :-1].float(), "labels": labels}
    loss = float(model.call("loss", args)[0])
    model.epoch = 1
    model.apply("train", args)
    params = [p.clone().requires_grad_(True)
              for p in weights.make(cfg, 9, CPU)]
    w = reference.Weights(cfg, params)
    ref_loss = reference.loss(w, ids[:, :-1], ids[:, 1:])
    grads = torch.autograd.grad(ref_loss, params)
    assert loss == pytest.approx(ref_loss.item(), rel=1e-5)
    for m, g in zip(first_moments(model), grads):
        assert torch.allclose(m / 0.1, g, rtol=1e-3, atol=1e-7)
    before = [p.detach().clone() for p in params]
    opt = reference.Adam(params, eta=cfg["build"]["eta"])
    opt.step(grads)
    prog = model.program
    # by the norm of each leaf's change: adam moves an entry by about eta
    # whatever its gradient's size, so entries whose gradient is round-off
    # may move either way on the two sides
    got = [float((model.params[t] - b).norm())
           for t, b in zip(prog.params, before)]
    want = [float((p.detach() - b).norm()) for p, b in zip(params, before)]
    assert leaf_gaps(got, want).max() < 1e-3


def test_adam_reference_follows_the_formula():
    p = torch.tensor([1.0, -2.0])
    opt = reference.Adam([p], eta=0.1)
    g = torch.tensor([0.5, -0.25])
    opt.step([g])
    # one step: m_hat = g, v_hat = g^2, so p -= eta * g / (|g| + eps)
    assert torch.allclose(p, torch.tensor([0.9, -1.9]), atol=1e-6)
