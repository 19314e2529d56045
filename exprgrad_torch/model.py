"""Model runtime of the port: compile graphs, run named targets, train in
batches, with state in torch tensors on an explicit ``device``.

Counterpart of ``exprgrad_tpu/model.py``: the same runtime (targets,
``call``/``apply``/``fit``, batch buckets, lowering stats, the numpy seed
stream that draws the initial parameters), over the port's own front end.
Each target runs through
:class:`~exprgrad_torch.backend.executor.TorchExecutor`.

``device`` is never guessed: ``"cuda"`` is the default, and without a GPU
it raises instead of carrying on on the CPU.  ``device="cpu"`` runs the
same lowering with the kernels' plain versions.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from . import ir, tracing
from .backend.executor import TorchExecutor, torch_dtype
from .backend.policy import SchedulePolicy
from .errors import ModelRuntimeError
from .fun import Fun, to_program
from .irprint import fmt_program
from .passes import compile_program, infer_shapes
from .utils.buckets import bucket_for, normalize_buckets
from .utils.native import shuffle_indices


_ARTIFACT_META = "exprgrad_torch.json"  # export_compiled's own record


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


class Model:
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
        SchedulePolicy(schedule_mode)  # raises on an unknown mode
        self.device = resolve_device(device)
        self.source = source
        self.precision = precision
        self.schedule_mode = schedule_mode
        self.program = source.copy()
        compile_program(self.program)
        self.epoch = 0
        self._rng = np.random.default_rng(seed)
        self._executors: dict = {}
        self._call_count = 0
        self.batch_buckets = None  # see set_batch_buckets
        self._bucket_track_memo: dict = {}
        self._mutates_memo: dict = {}
        self._quantized_tids: set = set()  # see quantize_weights
        self.params: dict[int, torch.Tensor] = {}
        self.caches: dict[int, torch.Tensor] = {}
        if not init_params:
            return
        # The JAX package's draw, value for value: large float32 tensors
        # draw natively in float32, small ones (and float64 models) keep
        # the float64 stream, so the same seed gives the same parameters.
        dtype = np.dtype(self.program.scalar_type.value)
        fast_floor = 1 << 16
        for tid in self.program.params:
            tdef = self.program.tensors[tid]
            lo, hi = tdef.init_range
            n = int(np.prod(tdef.shape, dtype=np.int64))
            if dtype != np.float64 and n >= fast_floor:
                r = self._rng.random(size=tdef.shape, dtype=np.float32)
                r *= np.float32(hi - lo)
                r += np.float32(lo)
                value = r
            else:
                value = self._rng.uniform(lo, hi, size=tdef.shape)
            self.params[tid] = self._to_device(value)
        for tid in self.program.caches:
            self.caches[tid] = torch.zeros(
                tuple(self.program.tensors[tid].shape), dtype=self.dtype,
                device=self.device)

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.program)

    def _to_device(self, value) -> torch.Tensor:
        if isinstance(value, torch.Tensor):
            return value.to(device=self.device, dtype=self.dtype)
        array = np.asarray(value, dtype=self.program.scalar_type.value)
        return torch.tensor(array, device=self.device)

    # --- introspection ------------------------------------------------
    def emit_ir(self, target: Optional[str] = None) -> str:
        """IR dump for inspection; ``target`` restricts to one target and
        the tensors it references."""
        if target is not None and target not in self.program.targets:
            raise ModelRuntimeError(f"unknown target {target!r}")
        return fmt_program(self.program, target)

    def lowering_stats(self, target_name: str) -> dict[str, int]:
        """How each kernel of already-compiled executors was lowered
        (einsum / matmul / matmul-fused / general / extern ...)."""
        out: dict[str, int] = {}
        for (name, _), executor in self._executors.items():
            if name == target_name:
                for key, count in executor.stats.items():
                    out[key] = out.get(key, 0) + count
        return out

    def executable(self, target_name: str,
                   input_shapes: dict[str, Sequence[int]]):
        """Callable bound to fixed input shapes: ``fn(args) -> tensor``;
        inputs are copied to ``device`` and the output stays there.
        Parameters are read from the model at call time."""
        pairs = [
            (self.program.inputs[name], list(shape))
            for name, shape in input_shapes.items()
        ]
        shapes = infer_shapes(self.program, target_name, pairs)
        executor = self._executor(target_name, shapes)
        output = self.program.targets[target_name].output

        def fn(args: dict):
            tensors = {
                self.program.inputs[name]: self._to_device(value)
                for name, value in args.items()
            }
            tensors.update(self._state(self.params))
            tensors.update(self._state(self.caches))
            seed = int(self._rng.integers(0, 2**31 - 1))
            with matmul_precision(self.precision):
                result = executor.run(tensors, shapes, self.epoch, seed)
            return result[output] if output is not None else None

        return fn

    def summary(self) -> str:
        """Human-readable parameter/cache table with totals, plus the
        per-target kernel counts: the quick sanity view of a compiled
        model, in the JAX package's text.  Reads only shapes, so nothing
        is copied from the device."""
        from .quant import QuantW

        def table(items):
            lines, total = [], 0
            for tid, value in items.items():
                if isinstance(value, QuantW):  # quantize_weights codes
                    value = value.codes
                shape = tuple(value.shape)
                n = int(np.prod(shape))
                total += n
                lines.append(
                    f"  t{tid:<4} "
                    f"{self.program.tensors[tid].name or '<unnamed>':<18} "
                    f"{str(list(shape)):<18} {n:>10,}"
                )
            return lines, total

        lines, total = table(self.params)
        cache_lines, cache_total = table(self.caches)
        out = [f"Model: {len(self.params)} parameters "
               f"({total:,} elements), {len(self.caches)} caches "
               f"({cache_total:,} elements), epoch {self.epoch}"]
        out.append("parameters:")
        out.extend(lines)
        if cache_lines:
            out.append("caches:")
            out.extend(cache_lines)
        out.append("targets:")
        for name, target in self.program.targets.items():
            out.append(f"  {name:<12} {len(target.kernels)} kernels")
        return "\n".join(out)

    def ema_params(self) -> dict[int, torch.Tensor]:
        """Debiased EMA shadow parameters (train with
        ``layers.with_ema(opt, decay)``), keyed by parameter tensor id, as
        tensors on ``device``: serve them with
        ``model.params.update(model.ema_params())``.

        The ``"ema.w"`` companion cache tracks the exact bias weight
        (``1 - decay^steps``), so the values are ``ema / ema.w``."""
        shadows: dict[int, int] = {}
        weights: dict[int, int] = {}
        for tid, tdef in enumerate(self.program.tensors):
            if (
                tdef.kind != ir.TensorKind.CACHE
                or tdef.cache_of is None
                or tid not in self.caches
            ):
                continue
            table = {"ema": shadows, "ema.w": weights}.get(tdef.name)
            if table is None:
                continue
            if tdef.cache_of in table:
                raise ModelRuntimeError(
                    f"parameter t{tdef.cache_of} has multiple "
                    f"{tdef.name!r} shadows (with_ema applied in more "
                    "than one target?); ema_params would be ambiguous"
                )
            table[tdef.cache_of] = tid
        if not shadows:
            raise ModelRuntimeError(
                "model has no EMA shadows; train with "
                "layers.with_ema(opt, decay)"
            )
        out: dict[int, torch.Tensor] = {}
        for pid, tid in shadows.items():
            w = self.caches[weights[pid]]
            if float(w.max()) == 0.0:
                raise ModelRuntimeError(
                    "EMA shadow has seen no training steps yet"
                )
            out[pid] = self.caches[tid] / w
        return out

    def astype(self, dtype: str) -> "Model":
        """A new model with the same program, state and epoch cast to
        ``dtype`` ("float32" or "float64"), on the same device.  A
        weight-quantized model refuses: cast first, then quantize."""
        if self._quantized_tids:
            raise ModelRuntimeError(
                "cannot astype a weight-quantized model; cast first, "
                "then quantize_weights()"
            )
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

    # --- execution ----------------------------------------------------
    def _state(self, table: dict) -> dict:
        """``table`` with the DTensors a mesh-sharded executor left in it
        read whole onto ``device`` (a collective: every rank of the mesh
        runs the call, as it runs the sharded step)."""
        if not any(hasattr(v, "device_mesh") for v in table.values()):
            return table
        from .parallel.mesh import global_value

        return {tid: self._to_device(global_value(v))
                for tid, v in table.items()}

    def _executor(self, target: str, shapes: dict[int, list[int]]):
        key = (target, tuple(sorted((t, tuple(s)) for t, s in shapes.items())))
        if key not in self._executors:
            self._executors[key] = TorchExecutor(
                self.program, target, shapes, self.device,
                schedule_mode=self.schedule_mode,
            )
        return self._executors[key]

    def _input_shapes(self, args: dict) -> list[tuple[int, list[int]]]:
        out = []
        for name, value in args.items():
            if name not in self.program.inputs:
                raise ModelRuntimeError(
                    f"{name!r} is not an input to the model")
            out.append((self.program.inputs[name], list(np.shape(value))))
        return out

    def _check_quantized(self, target_name: str, executor) -> None:
        """Refuse to run a target that would update weight-quantized
        parameters (quantize_weights is inference-only); shared by every
        execution path (call/apply, fit's batch loop, the scan epoch)."""
        if not self._quantized_tids:
            return
        hit = self._quantized_tids.intersection(executor.donated_tids)
        if hit:
            hit_names = sorted(self.program.tensors[t].name for t in hit)
            raise ModelRuntimeError(
                f"target {target_name!r} updates quantized "
                f"parameter(s) {hit_names}; weight quantization is "
                "inference-only — reload the full-precision "
                "checkpoint to train"
            )

    def _run(self, target_name: str, args: dict, shapes) -> Optional[np.ndarray]:
        target = self.program.targets[target_name]
        tensors = {
            self.program.inputs[name]: self._to_device(value)
            for name, value in args.items()
        }
        tensors.update(self._state(self.params))
        tensors.update(self._state(self.caches))

        self._call_count += 1
        seed = int(self._rng.integers(0, 2**31 - 1))
        executor = self._executor(target_name, shapes)
        self._check_quantized(target_name, executor)
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

    def set_batch_buckets(self, buckets) -> None:
        """Pad the leading (batch) dim of :meth:`call`'s inputs up to the
        next bucket (a sorted list of sizes, or ``"pow2"``) and slice the
        output back, so batch sizes within a bucket share one executor.

        As in the JAX package, only per-row inference targets are padded:
        a target that writes a parameter or cache, whose output does not
        track the batch, or that reduces over a batch-sized leading dim
        runs at its exact shape."""
        self.batch_buckets = normalize_buckets(buckets, "batch bucket")

    def _target_mutates(self, target_name: str) -> bool:
        """Does the target write any parameter or cache tensor?"""
        cached = self._mutates_memo.get(target_name)
        if cached is not None:
            return cached
        mutating = (ir.TensorKind.PARAM, ir.TensorKind.CACHE)
        result = any(
            kern.write is not None
            and self.program.tensors[kern.write.tensor].kind in mutating
            for kern in self.program.targets[target_name].kernels
        )
        self._mutates_memo[target_name] = result
        return result

    @staticmethod
    def _index_regs(index) -> set:
        regs = set(index.factors.keys())
        for instr in index.setup:
            regs.update(instr.args)
        return regs

    def _bucket_pad_safe(self, target_name: str, shapes0: dict,
                         b: int) -> bool:
        """Is edge-padding every batch-sized leading dim sound for this
        target?  Unsafe: a kernel reads a tensor whose leading dim equals
        the batch through registers absent from its write's dims (it
        reduces over that dim, so padded rows would reach real rows)."""
        for kern in self.program.targets[target_name].kernels:
            write = kern.write
            if write is None or kern.extern is not None:
                continue  # extern ops are batch-row-independent
            wregs = set()
            for d in write.dims:
                wregs |= self._index_regs(d)
            for read in kern.reads:
                shape = shapes0.get(read.tensor)
                if not shape or shape[0] != b or not read.dims:
                    continue
                if read.is_raw:
                    if not (write.is_raw and self._index_regs(
                            read.dims[0]) <= wregs):
                        return False
                    continue
                if not self._index_regs(read.dims[0]) <= wregs:
                    return False
        return True

    def _bucketed(self, target_name: str, args: dict):
        """``(args padded to the batch bucket, true batch)``, or
        ``(args, None)`` when the call runs at its exact shape."""
        if (self.batch_buckets is None or not args
                or self._target_mutates(target_name)):
            return args, None
        b = int(next(
            (np.shape(v)[0] for v in args.values() if np.shape(v)), 0))
        padded = bucket_for(self.batch_buckets, b) if b else None
        if padded is None or padded <= b:
            return args, None
        memo_key = (target_name, b, tuple(sorted(
            (n, np.shape(v)) for n, v in args.items())))
        track = self._bucket_track_memo.get(memo_key)
        if track is None:
            out_tid = self.program.targets[target_name].output
            track = False
            if out_tid is not None:
                shapes0 = infer_shapes(self.program, target_name,
                                       self._input_shapes(args))
                out0 = shapes0.get(out_tid)
                track = (bool(out0) and out0[0] == b
                         and self._bucket_pad_safe(target_name, shapes0, b))
            self._bucket_track_memo[memo_key] = track
        if not track:
            return args, None
        return {
            name: (np.pad(np.asarray(v),
                          [(0, padded - b)] + [(0, 0)] * (np.ndim(v) - 1),
                          mode="edge")
                   if np.shape(v) and np.shape(v)[0] == b else v)
            for name, v in args.items()
        }, b

    def call(self, target_name: str,
             args: Optional[dict] = None) -> np.ndarray:
        """Compute the value of a target for the given inputs; the result
        comes back as a numpy array, as in the JAX package."""
        args = args or {}
        if target_name not in self.program.targets:
            raise ModelRuntimeError(
                f"{target_name!r} is not a target of the model"
            )
        args, b = self._bucketed(target_name, args)
        # the shape signature that picks the executor, inferred per call
        with tracing.span("egt.executor.shapes", target=target_name):
            shapes = infer_shapes(self.program, target_name,
                                  self._input_shapes(args))
        out = self._run(target_name, args, shapes)
        if b is not None and out is not None and np.ndim(out) >= 1:
            out = out[:b]
        return out

    def apply(self, target_name: str, args: Optional[dict] = None) -> None:
        """Compute a target for its side effects, discarding the value."""
        self.call(target_name, args)

    def fit(
        self,
        target_name: str,
        args: dict,
        batch_size: int = 32,
        log_status: bool = True,
        shuffle: bool = False,
        scan_batches: bool = False,
        monitor: Optional[str] = None,
        accum_target: Optional[str] = None,
        accum_steps: int = 1,
    ) -> Optional[float]:
        """Run a target over all batches of the inputs; increments epoch.

        Samples beyond the last full batch are dropped.  ``shuffle=True``
        visits samples in a fresh random order each epoch.
        ``scan_batches=True`` copies the epoch's batches to the device
        once and runs them back to back (the JAX package's ``lax.scan``
        epoch).  ``monitor`` names a scalar target evaluated on the first
        batch after the epoch; its value is returned.  Gradient
        accumulation: ``accum_target`` runs on ``accum_steps - 1`` batches
        of every group, ``target_name`` on the last."""
        if not args:
            raise ModelRuntimeError(
                "Model.fit requires at least one input tensor; "
                "use Model.apply for targets without inputs"
            )
        if target_name not in self.program.targets:
            raise ModelRuntimeError(
                f"{target_name!r} is not a target of the model"
            )
        if accum_steps < 1:
            raise ModelRuntimeError("accum_steps must be >= 1")
        if accum_target is not None:
            if accum_target not in self.program.targets:
                raise ModelRuntimeError(
                    f"accum target {accum_target!r} is not a target of "
                    "the model"
                )
            if scan_batches:
                raise ModelRuntimeError(
                    "gradient accumulation is not supported with "
                    "scan_batches (the scan carries only parameters)"
                )
        elif accum_steps != 1:
            raise ModelRuntimeError(
                "accum_steps > 1 requires accum_target (see "
                "Fun.optimize_accum)"
            )
        first = next(iter(args.values()))
        batch_count = first.shape[0] // batch_size
        input_shapes = []
        for name, value in args.items():
            if name not in self.program.inputs:
                raise ModelRuntimeError(
                    f"{name!r} is not an input to the model")
            input_shapes.append(
                (self.program.inputs[name],
                 [batch_size] + list(value.shape[1:])))
        shapes = infer_shapes(self.program, target_name, input_shapes)
        accum_shapes = None
        if accum_target is not None:
            accum_shapes = infer_shapes(self.program, accum_target,
                                        input_shapes)
        order = None
        if shuffle:
            order = shuffle_indices(
                first.shape[0], int(self._rng.integers(0, 2**31 - 1)))
        if monitor is not None and monitor not in self.program.targets:
            raise ModelRuntimeError(
                f"monitor target {monitor!r} is not a target of the model"
            )

        self.epoch += 1
        if scan_batches:
            self._fit_scan(target_name, args, shapes, batch_size,
                           batch_count, order)
            return self._monitor(monitor, args, batch_size, log_status)
        for batch in range(batch_count):
            if log_status:
                print(f"\r{batch}/{batch_count}", end="", flush=True)
            offset = batch * batch_size
            if order is None:
                batch_args = {name: value[offset:offset + batch_size]
                              for name, value in args.items()}
            else:
                idx = order[offset:offset + batch_size]
                batch_args = {name: np.asarray(value)[idx]
                              for name, value in args.items()}
            if (accum_target is not None
                    and batch % accum_steps != accum_steps - 1):
                self._run(accum_target, batch_args, accum_shapes)
            else:
                self._run(target_name, batch_args, shapes)
        if log_status:
            print(f"\r{batch_count}/{batch_count}")
        return self._monitor(monitor, args, batch_size, log_status)

    def _monitor(self, monitor: Optional[str], args, batch_size: int,
                 log_status: bool) -> Optional[float]:
        """Evaluate the monitor target on the first batch; scalar value."""
        if monitor is None:
            return None
        first = {name: value[:batch_size] for name, value in args.items()}
        value = float(np.asarray(self.call(monitor, first)).reshape(-1)[0])
        if log_status:
            print(f"epoch {self.epoch}: {monitor} {value:.6f}")
        return value

    def _fit_scan(self, target_name, args, shapes, batch_size, batch_count,
                  order) -> None:
        dtype = np.dtype(self.program.scalar_type.value)
        executor = self._executor(target_name, shapes)
        self._check_quantized(target_name, executor)
        batches: dict[int, np.ndarray] = {}
        usable = batch_count * batch_size
        for name, value in args.items():
            value = np.ascontiguousarray(value, dtype=dtype)
            if order is not None:
                value = value[order]
            batches[self.program.inputs[name]] = value[:usable].reshape(
                (batch_count, batch_size) + value.shape[1:])
        tensors = dict(self._state(self.params))
        tensors.update(self._state(self.caches))
        seeds = np.asarray(
            self._rng.integers(0, 2**31 - 1, size=batch_count), np.int64)
        with matmul_precision(self.precision):
            result = executor.run_epoch(tensors, batches, self.epoch, seeds)
        for tid in self.params:
            if tid in result:
                self.params[tid] = result[tid]
        for tid in self.caches:
            if tid in result:
                self.caches[tid] = result[tid]

    def quantize_weights(
        self,
        target_name: str = "predict",
        dtype="int8",
        names: Optional[set] = None,
        min_size: int = 256,
    ) -> dict[str, tuple]:
        """Weight-only int8 quantization (W8A16) for inference serving.

        Each eligible parameter is replaced in place by int8 codes and
        per-output-channel float32 scales (:class:`~exprgrad_torch.quant.
        QuantW`, on the model's device); the executor dequantizes them at
        the entry of every run, so the codes are what the model keeps (a
        quarter of the float32 bytes).  Which axes get scales is inferred
        from the kernel IR of ``target_name``
        (:func:`~exprgrad_torch.quant.infer_quant_axes`).  Parameters read
        raw, through computed indices (embeddings), by externs or only
        elementwise (biases, norm gammas) stay at full precision, as does
        anything smaller than ``min_size`` elements or not in ``names``
        (when given).

        Inference only: a target that updates a quantized parameter
        ("train") raises, and so does :meth:`astype`.  Checkpoint before
        quantizing.  Returns ``{param_name: contraction_axes}`` of what
        was quantized."""
        from .quant import (QuantW, check_weight_dtype, infer_quant_axes,
                            quantize_weight)

        check_weight_dtype(dtype)
        if target_name not in self.program.targets:
            raise ModelRuntimeError(
                f"no target {target_name!r} to infer quantization axes "
                f"from (targets: {sorted(self.program.targets)})"
            )
        done: dict[str, tuple] = {}
        for tid in self.program.params:
            tdef = self.program.tensors[tid]
            if names is not None and tdef.name not in names:
                continue
            value = self.params[tid]
            if isinstance(value, QuantW):
                continue
            if value.numel() < min_size:
                continue
            axes = infer_quant_axes(self.program, tid, target_name)
            if axes is None:
                continue
            self.params[tid] = quantize_weight(value, axes)
            self._quantized_tids.add(tid)
            done[tdef.name] = axes
        return done

    # --- serving artifacts and profiles -------------------------------
    def _exported(self, target_name: str,
                  input_shapes: dict[str, Sequence[int]], seed: int):
        """``torch.export`` of the target's executor run at
        ``input_shapes``, the parameters and caches (and the RANDOM
        tensors drawn with ``seed``) held by the program as buffers.

        A fresh executor is traced, so the model's own executors never
        see the trace's tensors.  Kernels B1, B2, B5 and B6 stay in the
        graph as their ``torch.library`` ops.  Refused: a target with no
        output."""
        if target_name not in self.program.targets:
            raise ModelRuntimeError(
                f"{target_name!r} is not a target of the model")
        output = self.program.targets[target_name].output
        if output is None:
            raise ModelRuntimeError(
                f"target {target_name!r} has no output to export"
            )
        names = sorted(input_shapes)
        pairs = [(self.program.inputs[n], list(input_shapes[n]))
                 for n in names]
        shapes = infer_shapes(self.program, target_name, pairs)
        executor = TorchExecutor(self.program, target_name, shapes,
                                 self.device,
                                 schedule_mode=self.schedule_mode)
        state = {**self.params, **self.caches,
                 **executor.random_tensors(seed)}
        tids = [self.program.inputs[n] for n in names]
        epoch = self.epoch

        class Served(torch.nn.Module):
            def __init__(self):
                super().__init__()
                for tid, value in state.items():
                    self.register_buffer(f"t{tid}", value)

            def forward(self, args: dict):
                tensors = {tid: args[n] for tid, n in zip(tids, names)}
                tensors.update({tid: getattr(self, f"t{tid}")
                                for tid in state})
                return executor.run(tensors, shapes, epoch, seed)[output]

        example = {n: torch.zeros(tuple(input_shapes[n]), dtype=self.dtype,
                                  device=self.device) for n in names}
        with matmul_precision(self.precision):
            return torch.export.export(Served(), (example,), strict=False)

    def export_compiled(
        self,
        target_name: str,
        input_shapes: dict[str, Sequence[int]],
        path: Optional[str] = None,
        seed: int = 0,
    ) -> bytes:
        """Serialize a serving artifact of one target at fixed input
        shapes: ``torch.export`` of the executor run, with the current
        parameters and caches embedded as constants and ``rand()``
        tensors fixed to ``seed``, saved by ``torch.export.save``.  It
        loads with :func:`exprgrad_torch.load_compiled`, with no graph,
        compiler or parameter files, and runs on the device it was
        exported on.  Kernels B1 and B2 stay in the artifact as the ops
        ``exprgrad_torch::matmul`` and ``exprgrad_torch::flash_fwd``, the
        generated kernels B5 and B6 as ``exprgrad_torch::mapreduce`` and
        ``exprgrad_torch::rowchain``, each holding its whole kernel
        (Triton source, launch plan and IR) as a string argument.
        Returns the bytes, also written to ``path`` when given.

        A weight-quantized model is refused (export first, then
        ``quantize_weights``)."""
        if self._quantized_tids:
            raise ModelRuntimeError(
                "cannot export_compiled a weight-quantized model (the "
                "artifact embeds plain tensors); export first, then "
                "quantize_weights()"
            )
        program = self._exported(target_name, input_shapes, seed)
        meta = {"device": str(self.device), "dtype": str(self.dtype),
                "inputs": sorted(input_shapes)}
        buf = io.BytesIO()
        torch.export.save(program, buf,
                          extra_files={_ARTIFACT_META: json.dumps(meta)})
        data = buf.getvalue()
        if path is not None:
            with open(path, "wb") as f:
                f.write(data)
        return data

    def save_hlo(
        self,
        path: str,
        target_name: str,
        input_shapes: dict[str, Sequence[int]],
        optimized: bool = True,
    ) -> None:
        """Write the text of the target's exported program (the port's
        counterpart of the JAX package's HLO dump, itself the analog of
        the reference's LLVM bitcode dump): the ``torch.export`` graph of
        the executor run at ``input_shapes``, after
        ``run_decompositions()`` (to core ATen operators) when
        ``optimized``.  Kernels B1, B2, B5 and B6 appear as the ops
        ``exprgrad_torch::matmul``, ``exprgrad_torch::flash_fwd``,
        ``exprgrad_torch::mapreduce`` and ``exprgrad_torch::rowchain``."""
        program = self._exported(target_name, input_shapes, 0)
        if optimized:
            program = program.run_decompositions()
        with open(path, "w") as f:
            f.write(str(program))

    def profile(self, target_name: str, args: dict, logdir: str) -> None:
        """Run one :meth:`call` under ``torch.profiler`` (CPU activity,
        and CUDA activity on the card) and write the trace into
        ``logdir`` as ``<target>.pt.trace.json``: a Chrome trace, which
        chrome://tracing or Perfetto opens (TensorBoard's PyTorch
        profiler plugin reads the same file)."""
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with torch_profile(activities=activities) as prof:
            self.call(target_name, args)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(logdir, f"{target_name}.pt.trace.json"))

    def autotune(self, target_name: str, args: Optional[dict] = None, **kw):
        """Search tile sizes for this target's scheduled kernels by
        MEASURING candidates end-to-end on the model's device, install
        the fastest, and return the :class:`~exprgrad_torch.autotune.
        TuneReport` (str() it for the table).

        The schedule-stripped plain lowering is always a candidate, so the
        result can only match or beat both the hand schedule and the plain
        lowering on this device.  Pins ``schedule_mode="force"`` so later
        calls honor the tuned schedule (a kernel whose winner was the
        plain lowering simply has no schedule left to force)."""
        from .autotune import tune

        report = tune(self, target_name, args, **kw)
        self.schedule_mode = "force"
        self._executors.clear()
        return report


def _source(graphs, dtype: str) -> ir.Program:
    """The source program of ``graphs`` at ``dtype``.  Scoped schedules
    resolve under scope "cpu", as the JAX package does off the TPU."""
    source = to_program(graphs, schedule_scope="cpu")
    source.scalar_type = ir.ScalarType(np.dtype(dtype).name)
    return source


def compile(  # noqa: A001
    graphs: Sequence[Fun] | Fun,
    dtype: str = "float32",
    seed: Optional[int] = None,
    precision: str = "highest",
    schedule_mode: str = "auto",
    device="cuda",
) -> Model:
    """Compile computation graphs into a port model on ``device``.

    The arguments of ``exprgrad_tpu.compile`` without ``backend``: the
    same graphs and ``seed`` draw the same initial parameters.
    ``schedule_mode`` routes ``Fun.schedule`` hints
    (:mod:`exprgrad_torch.backend.policy`)."""
    return Model(_source(graphs, dtype), seed=seed, precision=precision,
                 schedule_mode=schedule_mode, device=device)


def from_state(
    graphs: Sequence[Fun] | Fun | ir.Program,
    params: dict,
    caches: dict,
    epoch: int = 0,
    rng_state: Optional[dict] = None,
    dtype: str = "float32",
    precision: str = "highest",
    schedule_mode: str = "auto",
    device="cuda",
) -> Model:
    """A port model built from ``graphs`` (or a source program) carrying
    given state: ``params`` and ``caches`` are numpy arrays by tensor id,
    ``rng_state`` a numpy ``bit_generator.state``.

    This carries a JAX-package model over (``ref.params``, ``ref.caches``,
    ``ref.epoch``, ``ref._rng.bit_generator.state``): a program built with
    the port's builders has the same tensor ids as the one built with the
    JAX package's.  Ids and shapes are checked."""
    source = (graphs if isinstance(graphs, ir.Program)
              else _source(graphs, dtype))
    out = Model(source, precision=precision, schedule_mode=schedule_mode,
                init_params=False, device=device)
    for table, want, what in ((params, out.program.params, "params"),
                              (caches, out.program.caches, "caches")):
        if set(table) != set(want):
            raise ModelRuntimeError(
                f"{what} tensor ids {sorted(table)} do not match the "
                f"program's {sorted(want)}"
            )
        for tid, value in table.items():
            shape = tuple(out.program.tensors[tid].shape)
            if tuple(np.shape(value)) != shape:
                raise ModelRuntimeError(
                    f"{what} t{tid} has shape {tuple(np.shape(value))}, "
                    f"the program {shape}"
                )
    out.params = {t: out._to_device(np.asarray(v)) for t, v in params.items()}
    out.caches = {t: out._to_device(np.asarray(v)) for t, v in caches.items()}
    out.epoch = int(epoch)
    if rng_state is not None:
        out._rng.bit_generator.state = rng_state
    return out


def load_compiled(data):
    """Load a serving artifact written by :meth:`Model.export_compiled`.

    ``data`` is the serialized bytes or a file path; returns
    ``fn(args: dict[str, array]) -> tensor``.  The artifact holds the
    program and the parameters: nothing else is needed.  Inputs are
    copied to the device the artifact was exported on, in its dtype, and
    the output stays there."""
    if isinstance(data, str):
        with open(data, "rb") as f:
            data = f.read()
    # the generated kernels' ops must be registered before the load
    from .ops import mapreduce, rowchain  # noqa: F401

    extra = {_ARTIFACT_META: ""}
    program = torch.export.load(io.BytesIO(data), extra_files=extra)
    meta = json.loads(extra[_ARTIFACT_META])
    device = resolve_device(meta["device"])
    if device.type == "cuda":  # the generated kernels' CUDA implementations
        from .utils import launcher

        launcher.load()
    dtype = getattr(torch, meta["dtype"].split(".")[-1])
    module = program.module()

    def fn(args: dict):
        tensors = {name: torch.as_tensor(args[name], dtype=dtype,
                                         device=device)
                   for name in meta["inputs"]}
        with torch.no_grad():
            return module(tensors)

    return fn
