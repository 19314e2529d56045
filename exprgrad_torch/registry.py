"""The port's table of extern ops, keyed by the same names as the JAX
package's (``exprgrad_tpu/registry.py``).

An extern op is an opaque fused primitive called from the DSL (fused
attention, ...).  Here each name maps to a torch implementation
``fn(args, attrs, ctx)``: tensors in, a tensor (or a tuple of tensors when
the op has several outputs) out.  The port never looks an op up in the
JAX package's registry: its first lookup imports ``exprgrad_tpu.ops``,
which loads jax.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from exprgrad_tpu.errors import ModelRuntimeError


@dataclass
class ExternContext:
    """What the executor hands an extern implementation."""

    stats: Optional[dict] = None  # executor lowering-stats dict or None

    def record(self, key: str) -> None:
        """Count a lowering decision (e.g. which attention impl ran) into
        the executor's lowering_stats."""
        if self.stats is not None:
            self.stats[key] = self.stats.get(key, 0) + 1


@dataclass
class ExternDef:
    name: str
    nout: int
    torch_fn: Callable


_REGISTRY: dict[str, ExternDef] = {}


def register_extern(name: str, nout: int, torch_fn: Callable) -> None:
    _REGISTRY[name] = ExternDef(name, nout, torch_fn)


def get_extern(name: str) -> ExternDef:
    if name not in _REGISTRY:
        from .ops import externs as _  # noqa: F401  (registers built-ins)
    if name not in _REGISTRY:
        raise ModelRuntimeError(
            f"extern op {name!r} has no torch implementation; call "
            "exprgrad_torch.registry.register_extern first"
        )
    return _REGISTRY[name]
