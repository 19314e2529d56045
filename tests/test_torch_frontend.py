"""The port's own front end against the JAX package's.

``exprgrad_torch`` carries its own copy of the front end (DSL, IR,
passes, layers, the numpy oracle and the DSL model builders).  Built with
either package, every model builder and the scheduled programs of
chip_smoke.py give the same program text (``irprint.fmt_program``), the
same tensor ids, and ``compile(seed=s)`` draws bitwise-equal initial
parameters.  No source file of the port imports jax or the JAX package.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

import exprgrad_torch as egt
import exprgrad_torch.models as port_models
import exprgrad_tpu
import exprgrad_tpu.models as jax_models
from exprgrad_torch import irprint as port_irprint
from exprgrad_torch.model import _source
from exprgrad_tpu import irprint as jax_irprint
from exprgrad_tpu.fun import to_program as jax_to_program
from chip_smoke import matmul_graph, scheduled_mlp

REPO = Path(__file__).resolve().parents[1]


def _patchify(models, pkg):
    return models.patchify(pkg.input("images"), 12, 4).target("patches")


# name -> graph(models module, package); small widths
BUILDERS = {
    "conv_autoencoder": lambda m, p: m.conv_autoencoder(size=12),
    "fashion_mnist_cnn": lambda m, p: m.fashion_mnist_cnn(),
    "flash_transformer": lambda m, p: m.flash_transformer(
        vocab=16, dim=32, heads=4, kv_heads=2, hidden=32, blocks=2,
        max_seq=64, rope=True),
    "mnist_gan": lambda m, p: m.mnist_gan(latent=8, image_size=16),
    "mobile_cnn": lambda m, p: m.mobile_cnn(),
    "patchify": _patchify,
    "tiny_diffusion": lambda m, p: m.tiny_diffusion(hidden=16),
    "tiny_mixer": lambda m, p: m.tiny_mixer(),
    "tiny_recurrent_lm": lambda m, p: m.tiny_recurrent_lm(cell="gru"),
    "tiny_seq2seq": lambda m, p: m.tiny_seq2seq(),
    "tiny_transformer": lambda m, p: m.tiny_transformer(),
    "tiny_vae": lambda m, p: m.tiny_vae(),
    "tiny_vit": lambda m, p: m.tiny_vit(),
    "xor_from_scratch": lambda m, p: m.xor_from_scratch(),
    "xor_mlp": lambda m, p: m.xor_mlp(),
    "scheduled_matmul": lambda m, p: matmul_graph(p, 512),
    "scheduled_mlp": lambda m, p: scheduled_mlp(p, dim=32, hidden=64,
                                                tile=16),
}


def test_every_exported_builder_is_covered():
    exported = set(port_models.__all__) - {"FlashLMServer"}
    assert exported <= set(BUILDERS)
    assert set(jax_models.__all__) >= exported


def _programs(name):
    port = BUILDERS[name](port_models, egt)
    ref = BUILDERS[name](jax_models, exprgrad_tpu)
    return (_source(port, "float32"),
            jax_to_program(ref, schedule_scope="cpu"), port, ref)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_program_text_and_tensor_ids_match(name):
    port, ref, _, _ = _programs(name)
    assert port_irprint.fmt_program(port) == jax_irprint.fmt_program(ref)
    assert [(t.name, t.kind.value, list(t.shape or []))
            for t in port.tensors] == [
        (t.name, t.kind.value, list(t.shape or [])) for t in ref.tensors]
    assert port.inputs == ref.inputs
    assert sorted(port.targets) == sorted(ref.targets)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_seeded_compile_draws_the_same_parameters(name):
    _, _, port_graph, ref_graph = _programs(name)
    port = egt.compile(port_graph, seed=7, device="cpu")
    ref = exprgrad_tpu.compile(ref_graph, seed=7, backend="interp")
    assert port_irprint.fmt_program(port.program) == \
        jax_irprint.fmt_program(ref.program)
    assert port.params.keys() == ref.params.keys()
    assert port.caches.keys() == ref.caches.keys()
    for tid, value in ref.params.items():
        np.testing.assert_array_equal(port.params[tid].numpy(), value)


def _port_sources():
    files = sorted((REPO / "exprgrad_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py"]
    files += sorted((REPO / "scripts").glob("profile_torch_*.py"))
    return files


def test_no_port_source_imports_jax_or_the_jax_package():
    bad = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "exprgrad_tpu"):
                    bad.append(f"{path.relative_to(REPO)}:{node.lineno} "
                               f"{name}")
    assert len(_port_sources()) > 40
    assert not bad, bad
