"""Model runtime of the port: the JAX package's ``Model`` on torch tensors.

``exprgrad_torch.Model`` subclasses ``exprgrad_tpu.model.Model`` and keeps
its runtime (targets, ``call``/``apply``/``fit``, batch buckets, stats);
what changes is underneath: parameters and caches are torch tensors on an
explicit ``device``, and each target runs through
:class:`~exprgrad_torch.backend.executor.TorchExecutor`.

``device`` is never guessed: ``"cuda"`` is the default, and without a GPU
it raises instead of carrying on on the CPU.  ``device="cpu"`` runs the
same lowering with the kernels' plain versions.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

from exprgrad_tpu import ir
from exprgrad_tpu.fun import Fun, to_program
from exprgrad_tpu.model import Model as _ReferenceModel

from .backend.executor import TorchExecutor, torch_dtype


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


@contextlib.contextmanager
def matmul_precision(precision: str):
    """TF32 off for ``"highest"`` (the default, full float32 products), on
    for ``"high"``/``"default"``; restored afterwards."""
    allow = precision != "highest"
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Model(_ReferenceModel):
    """A compiled model whose state lives in torch tensors on ``device``."""

    def __init__(
        self,
        source: ir.Program,
        seed: Optional[int] = None,
        precision: str = "highest",
        schedule_mode: str = "auto",
        init_params: bool = True,
        device="cuda",
    ) -> None:
        if precision not in ("highest", "high", "default"):
            raise ValueError(f"unknown precision {precision!r}")
        self.device = resolve_device(device)
        super().__init__(source, backend="torch", seed=seed,
                         precision=precision, schedule_mode=schedule_mode,
                         init_params=init_params)
        # the reference runtime draws the initial values with numpy (the
        # same stream as the JAX package for the same seed); move them
        self.params = {t: self._to_device(v) for t, v in self.params.items()}
        self.caches = {t: self._to_device(v) for t, v in self.caches.items()}

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.program)

    def _to_device(self, value) -> torch.Tensor:
        if isinstance(value, torch.Tensor):
            return value.to(device=self.device, dtype=self.dtype)
        array = np.asarray(value, dtype=self.program.scalar_type.value)
        return torch.tensor(array, device=self.device)

    # --- execution ----------------------------------------------------
    def _executor(self, target: str, shapes: dict[int, list[int]]):
        key = (target, tuple(sorted((t, tuple(s)) for t, s in shapes.items())))
        if key not in self._executors:
            self._executors[key] = TorchExecutor(
                self.program, target, shapes, self.device,
                schedule_mode=self.schedule_mode,
            )
        return self._executors[key]

    def _run(self, target_name: str, args: dict, shapes) -> Optional[np.ndarray]:
        target = self.program.targets[target_name]
        tensors = {
            self.program.inputs[name]: self._to_device(value)
            for name, value in args.items()
        }
        tensors.update(self.params)
        tensors.update(self.caches)

        self._call_count += 1
        seed = int(self._rng.integers(0, 2**31 - 1))
        executor = self._executor(target_name, shapes)
        with matmul_precision(self.precision):
            result = executor.run(tensors, shapes, self.epoch, seed)

        for tid in self.params:
            if tid in result:
                self.params[tid] = result[tid]
        for tid in self.caches:
            if tid in result:
                self.caches[tid] = result[tid]
        if target.output is not None:
            return result[target.output].cpu().numpy()
        return None

    def executable(self, target_name: str, input_shapes: dict):
        """Callable bound to fixed input shapes, as in the JAX package;
        inputs are copied to ``device`` and the output stays there."""
        fn = super().executable(target_name, input_shapes)

        def run(args: dict):
            with matmul_precision(self.precision):
                return fn({n: self._to_device(v) for n, v in args.items()})

        return run

    def ema_params(self) -> dict[int, torch.Tensor]:
        """Debiased EMA shadow parameters (train with
        ``layers.with_ema(opt, decay)``), keyed by parameter tensor id, as
        tensors on ``device``: serve them with
        ``model.params.update(model.ema_params())``.

        The reference method reads the caches as numpy arrays; it runs
        here on host copies of them."""
        caches = self.caches
        self.caches = {t: v.cpu().numpy() for t, v in caches.items()}
        try:
            host = super().ema_params()
        finally:
            self.caches = caches
        return {t: self._to_device(v) for t, v in host.items()}

    def astype(self, dtype: str) -> "Model":
        """A new model with the same program, state and epoch cast to
        ``dtype`` ("float32" or "float64"), on the same device."""
        nd = np.dtype(dtype)
        src = self.source.copy()
        src.scalar_type = ir.ScalarType(nd.name)
        out = Model(src, precision=self.precision,
                    schedule_mode=self.schedule_mode, init_params=False,
                    device=self.device)
        out.params = {t: out._to_device(v) for t, v in self.params.items()}
        out.caches = {t: out._to_device(v) for t, v in self.caches.items()}
        out.epoch = self.epoch
        out._rng.bit_generator.state = self._rng.bit_generator.state
        return out

    # --- JAX-only features, not ported yet -----------------------------
    def _not_ported(self, what: str):
        raise NotImplementedError(
            f"{what} is not ported to exprgrad_torch yet (ROADMAP.md, "
            "queue A)"
        )

    def export_compiled(self, *args, **kwargs):
        self._not_ported("export_compiled")

    def save_hlo(self, *args, **kwargs):
        self._not_ported("save_hlo")

    def profile(self, *args, **kwargs):
        self._not_ported("profile")

    def quantize_weights(self, *args, **kwargs):
        self._not_ported("quantize_weights")

    def autotune(self, *args, **kwargs):
        self._not_ported("autotune")


def compile(  # noqa: A001
    graphs: Sequence[Fun] | Fun,
    dtype: str = "float32",
    seed: Optional[int] = None,
    precision: str = "highest",
    schedule_mode: str = "auto",
    device="cuda",
) -> Model:
    """Compile computation graphs into a port model on ``device``.

    Same front end and arguments as ``exprgrad_tpu.compile`` (without
    ``backend``): the same ``seed`` draws the same initial parameters.
    Scoped schedules resolve under scope "cpu", as the JAX package does
    off the TPU."""
    source = to_program(graphs, schedule_scope="cpu")
    source.scalar_type = ir.ScalarType(np.dtype(dtype).name)
    return Model(source, seed=seed, precision=precision,
                 schedule_mode=schedule_mode, device=device)


def from_reference(model: _ReferenceModel, device="cuda") -> Model:
    """The port model of a JAX-package ``Model``: same program, the same
    parameter and cache values, epoch and random stream, on ``device``."""
    out = Model(model.source, precision=model.precision,
                schedule_mode=model.schedule_mode, init_params=False,
                device=device)
    out.params = {t: out._to_device(np.asarray(v))
                  for t, v in model.params.items()}
    out.caches = {t: out._to_device(np.asarray(v))
                  for t, v in model.caches.items()}
    out.epoch = model.epoch
    out._rng.bit_generator.state = model._rng.bit_generator.state
    return out
