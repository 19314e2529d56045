"""Seeded weights of a configuration, made on the device.

The same ``(config, seed)`` gives the same tensors to the program and
to the plain reference.  Leaves are listed in the order of the port's
``flash_transformer`` parameters; leaves of one name and shape are drawn
together, one stacked tensor a group from a generator of its own, so a
group can be drawn again alone (the training check rebuilds the initial
weights group by group) and the whole model takes a dozen large calls.
"""

from __future__ import annotations

import hashlib

import torch

from . import flops

GAIN = "rms.g"
HEAD_BIAS = "bias"


def layout(cfg: dict) -> list[tuple[str, tuple]]:
    """(name, shape) of every parameter in the program's order: embed,
    then per block the attention gain, wq, wk, wv, wo, the FFN gain, the
    SwiGLU gate, up and down matrices, then the final gain, the head's
    weights and its bias."""
    s = flops.sizes(cfg)
    d, hd, h, hkv = s["dim"], s["head_dim"], s["heads"], s["kv_heads"]
    block = [(GAIN, (d,)), ("wq", (h, d, hd)), ("wk", (hkv, d, hd)),
             ("wv", (hkv, d, hd)), ("wo", (h, hd, d)), (GAIN, (d,)),
             ("ffn.wg", (d, s["hidden"])), ("ffn.wu", (d, s["hidden"])),
             ("ffn.wd", (s["hidden"], d))]
    return ([("embed", (s["vocab"], d))] + block * s["layers"]
            + [(GAIN, (d,)), ("weights", (d, s["vocab"])),
               (HEAD_BIAS, (s["vocab"],))])


def groups(cfg: dict) -> list[tuple[str, tuple, list[int]]]:
    """(name, shape, leaf indices) of each group, in first-seen order."""
    out: dict = {}
    for i, (name, shape) in enumerate(layout(cfg)):
        out.setdefault((name, shape), []).append(i)
    return [(n, sh, idx) for (n, sh), idx in out.items()]


def stream_seed(seed: int, *parts) -> int:
    """A 63-bit generator seed for one stream of a run's seed."""
    text = ":".join(str(p) for p in (int(seed),) + parts)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def draw_group(cfg: dict, seed: int, g: int, device) -> torch.Tensor:
    """Group ``g``'s stacked leaves ``[count, *shape]``: gains 1, the head
    bias 0, every other leaf uniform with the configuration's
    ``initializer_range`` as its standard deviation."""
    name, shape, idx = groups(cfg)[g]
    full = (len(idx),) + tuple(shape)
    if name == GAIN:
        return torch.ones(full, dtype=torch.float32, device=device)
    if name == HEAD_BIAS:
        return torch.zeros(full, dtype=torch.float32, device=device)
    half = cfg["initializer_range"] * 3 ** 0.5
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, "weights", g))
    out = torch.empty(full, dtype=torch.float32, device=device)
    return out.uniform_(-half, half, generator=gen)


def make(cfg: dict, seed: int, device) -> list[torch.Tensor]:
    """Every leaf, in ``layout`` order (views of the stacked groups)."""
    leaves: list = [None] * len(layout(cfg))
    for g, (_, _, idx) in enumerate(groups(cfg)):
        for i, leaf in zip(idx, draw_group(cfg, seed, g, device).unbind(0)):
            leaves[i] = leaf
    return leaves
