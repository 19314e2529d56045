"""Target executor: runs one target at one shape signature on a device.

Counterpart of ``exprgrad_tpu/backend/executor.py``.  The JAX executor
traces the whole target into one ``jax.jit`` program; PyTorch runs
eagerly, so this executor lowers and runs the target's kernels one after
another on every call.  State is functional as in the JAX package: the
executor returns the updated parameter/cache tensors and the model
runtime swaps them in.

``run_epoch`` (``fit(scan_batches=True)``) takes the place of the JAX
package's ``lax.scan`` over stacked batches: the batches are copied to
the device once, then a loop on the host runs the target on each,
carrying the updated parameters and caches from batch to batch.

Scheduled matmuls fold their elementwise consumers into kernel B1's
epilogue by the plan of :func:`~exprgrad_torch.backend.scheduled.
plan_epilogue_fusions`, as in the JAX executor: the folded kernels are
skipped, the intermediates they dropped are never allocated, and the
chain's value lands in its final tensor.  After it, the row-chain plan of
:func:`~exprgrad_torch.backend.rowchain.plan_rowchain_fusions` fuses runs
of scheduled map/reduce kernels (softmax, layer_norm, rms_norm) into one
kernel B6 each: the chain's head runs it, which yields the final tensor
and every escaping intermediate, and its other intermediates are never
allocated.

The executor keeps one :class:`KernelLowering` per kernel across its
runs, so a scheduled kernel is classified, planned and its Triton source
generated once per executor, not once per call.

While ``torch.profiler`` records, a run leaves spans (``tracing``;
``Model.call``'s shape inference before it is ``egt.executor.shapes``):
``egt.executor.run`` around it, ``egt.executor.alloc`` around its
results' fills and RANDOM tensors, and ``egt.executor.kernel`` around
each kernel it runs, with the kernel's ``index``, its lowering ``path``
(``lowering_stats``'s vocabulary) and its ``phase``: ``optimizer`` for a
kernel that writes a parameter or cache, ``backward`` for one the
autodiff pass derived, else ``forward``.  On a CUDA device one event at
each kernel boundary gives every kernel its device seconds.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import ir, tracing
from ..interp import accumulation_identity, extreme_accumulated_results
from ..ir import Program
from ..quant import QuantW, dequantize

from .policy import SchedulePolicy
from .rowchain import plan_rowchain_fusions
from .scheduled import plan_epilogue_fusions
from .torcheval import KernelLowering


def torch_dtype(program: Program) -> torch.dtype:
    return getattr(torch, program.scalar_type.value)


def kernel_phase(program: Program, kernel: ir.Kernel) -> str:
    """The phase of a train step a kernel belongs to: ``optimizer`` if
    it writes a parameter or cache, ``backward`` if the autodiff pass
    derived it, else ``forward``."""
    if kernel.write is not None and program.tensors[
            kernel.write.tensor].kind in (ir.TensorKind.PARAM,
                                          ir.TensorKind.CACHE):
        return "optimizer"
    return "backward" if kernel.derived else "forward"


def random_seed(seed: int, tid: int) -> int:
    """The generator seed of RANDOM tensor ``tid`` in a run seeded with
    ``seed``: a hash of the pair, the counterpart of the JAX package's
    ``fold_in(PRNGKey(seed), tid)``."""
    state = np.random.SeedSequence(
        [int(seed) % 2**64, int(tid)]).generate_state(1)
    return int(state[0])


class TorchExecutor:
    def __init__(
        self,
        program: Program,
        target_name: str,
        shapes: dict[int, list[int]],
        device: torch.device,
        schedule_mode: str = "auto",
    ) -> None:
        self.program = program
        self.target = program.targets[target_name]
        self.shapes = shapes
        self.device = device
        self.dtype = torch_dtype(program)
        self.policy = SchedulePolicy(schedule_mode)
        self._consts: dict = {}  # literal -> 0-d device tensor
        self._lowerings: dict[int, KernelLowering] = {}
        self._writers: dict[int, int] = {}  # tensor id -> writing kernels
        for kernel in self.target.kernels:
            if kernel.write is not None:
                tid = kernel.write.tensor
                self._writers[tid] = self._writers.get(tid, 0) + 1
        self._plan_fusions()

        self.input_tids = sorted(
            tid
            for tid in self.target.tensors
            if program.tensors[tid].kind
            in (ir.TensorKind.INPUT, ir.TensorKind.PARAM, ir.TensorKind.CACHE)
        )
        written = {
            k.write.tensor for k in self.target.kernels if k.write is not None
        }
        state_written = {
            tid
            for tid in written
            if program.tensors[tid].kind
            in (ir.TensorKind.PARAM, ir.TensorKind.CACHE)
        }
        # outputs: the state the runtime reads back and the target's result
        self.output_tids = sorted(
            (state_written
             | ({self.target.output} if self.target.output is not None
                else set()))
            - self._fused_away
        )
        self.random_tids = sorted(
            tid
            for tid in self.target.tensors
            if program.tensors[tid].kind == ir.TensorKind.RANDOM
        )
        # parameters/caches the target updates (the JAX executor donates
        # their buffers; here they are simply replaced)
        self.donated_tids = sorted(
            tid for tid in self.input_tids if tid in state_written
        )
        donated = set(self.donated_tids)
        self.kept_tids = [t for t in self.input_tids if t not in donated]
        self._extreme = extreme_accumulated_results(self.target)
        self.phases = [kernel_phase(program, k) for k in self.target.kernels]
        self.stats: dict[str, int] = {}  # lowering paths, from the 1st run
        self._ran = False

    def _plan_fusions(self, lowering=None, may_join=None) -> None:
        """The fusion plans: first the matmul+epilogue plan (scheduled
        matmuls whose elementwise consumer chain folds into the kernel's
        epilogue), then the row-chain plan (runs of scheduled map/reduce
        kernels fused into one kernel B6 each; matmul chains take
        precedence).  ``lowering`` and ``may_join`` as the planners take
        them."""
        (self.fused, self._skip_kernels, self._fused_away,
         self.epilogue_declines) = plan_epilogue_fusions(
            self.program, self.target, self.shapes, self.dtype, self.device,
            self.policy, lowering=lowering, may_join=may_join)
        (self.row_fused, row_skip, row_away,
         self.rowchain_declines) = plan_rowchain_fusions(
            self.program, self.target, self._lowering, self.policy,
            consumed=self._skip_kernels | set(self.fused),
            may_join=may_join)
        self._skip_kernels = self._skip_kernels | row_skip
        self._fused_away = self._fused_away | row_away

    def _fresh_output(self, kernel: ir.Kernel) -> bool:
        """A RESULT tensor with one writer holds its accumulation identity
        when that kernel runs: the generated kernels store their value
        without reading it."""
        tid = kernel.write.tensor if kernel.write is not None else None
        return (tid is not None
                and self.program.tensors[tid].kind == ir.TensorKind.RESULT
                and self._writers.get(tid) == 1)

    def _lowering(self, i: int) -> KernelLowering:
        """Kernel ``i``'s lowering, made on first use and kept."""
        low = self._lowerings.get(i)
        if low is None:
            kernel = self.target.kernels[i]
            low = KernelLowering(
                self.program, kernel, self.shapes, self.dtype, self.device,
                self.policy, None, self._consts)
            low.fresh_output = self._fresh_output(kernel)
            self._lowerings[i] = low
        return low

    def random_tensors(self, seed: int) -> dict[int, torch.Tensor]:
        """The target's RANDOM tensors in a run seeded with ``seed``: one
        stream per (seed, tid), as the JAX package folds tid into its
        key, so a tensor's values do not depend on the target's other
        RANDOM tensors (the streams are not jax.random's)."""
        out = {}
        for tid in self.random_tids:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(random_seed(seed, tid))
            lo, hi = self.program.tensors[tid].random_range
            out[tid] = torch.rand(
                tuple(self.shapes[tid]), generator=gen, dtype=self.dtype,
                device=self.device,
            ) * (hi - lo) + lo
        return out

    def generated_kernels(self) -> list[str]:
        """The generated kernels a run launches, as ``"B5 <kernel>"`` and
        ``"B6 <chain head>"`` descriptions (empty when there are none):
        the scheduled map/reduce kernels and row chains this executor's
        plan routes to Triton."""
        found = [f"B6 {self.row_fused[i].members[0].low._kernel_desc()}"
                 for i in sorted(self.row_fused)]
        for i, kernel in enumerate(self.target.kernels):
            if (i in self._skip_kernels or i in self.fused
                    or i in self.row_fused or kernel.extern is not None):
                continue
            low = self._lowering(i)
            if low._bounds_ok and low.scheduled_route() == "mapreduce":
                found.append(f"B5 {low._kernel_desc()}")
        return found

    def run(
        self,
        tensors: dict[int, torch.Tensor],
        shapes: dict[int, list[int]],
        epoch: int,
        seed: int,
    ) -> dict[int, torch.Tensor]:
        """Run the target on device tensors; returns {tid: tensor} for the
        output and every updated parameter/cache.  RANDOM tensors already
        in ``tensors`` are used as given (an exported program carries
        them as constants)."""
        cuda = self.device.type == "cuda"
        with tracing.span("egt.executor.run", target=self.target.name,
                          device=cuda):
            # weight-quantized parameters (Model.quantize_weights) enter as
            # QuantW codes and scales and are dequantized here, into this
            # run only: the model keeps the codes
            tensors = {
                tid: dequantize(v, self.dtype) if isinstance(v, QuantW)
                else v for tid, v in tensors.items()
            }
            with tracing.span("egt.executor.alloc", device=cuda) as sp:
                self._alloc(tensors, seed)
            traced = sp is not None
            mark = sp.end_event if traced else None
            stats = None if self._ran else self.stats
            extern_memo: dict = {}  # one logical extern call per run
            for i in range(len(self.target.kernels)):
                if i in self._skip_kernels:
                    continue  # folded into an earlier matmul or row chain
                if not traced:
                    self._run_kernel(i, tensors, epoch, stats, extern_memo)
                    continue
                with tracing.span("egt.executor.kernel", index=i,
                                  phase=self.phases[i], device=mark) as sp:
                    path = self._run_kernel(i, tensors, epoch, stats,
                                            extern_memo)
                if sp is not None:
                    sp.attrs["path"] = path
                    mark = sp.end_event
            extern_memo.clear()  # the kept lowerings must not hold outputs
        self._ran = True
        return {tid: tensors[tid] for tid in self.output_tids}

    def _alloc(self, tensors: dict, seed: int) -> None:
        """Every RESULT tensor of the run at its accumulation identity, and
        the RANDOM tensors not given, into ``tensors``."""
        for tid in sorted(self.target.tensors):
            if (self.program.tensors[tid].kind != ir.TensorKind.RESULT
                    or tid in self._fused_away):
                continue
            shape = tuple(self.shapes[tid])
            if tid in self._extreme:
                # max/min-only results start at -inf/+inf, so the first
                # accumulation wins (softmax's row max needs this)
                fill = accumulation_identity(self._extreme[tid])
                tensors[tid] = torch.full(shape, fill, dtype=self.dtype,
                                          device=self.device)
            else:
                tensors[tid] = torch.zeros(shape, dtype=self.dtype,
                                           device=self.device)
        for tid, value in self.random_tensors(seed).items():
            tensors.setdefault(tid, value)

    def _run_kernel(self, i: int, tensors: dict, epoch: int, stats,
                    extern_memo: dict):
        """Run kernel ``i`` (a fused matmul's or row chain's head runs the
        whole chain) into ``tensors``; returns its lowering path."""
        if i in self.fused:
            sm, chain = self.fused[i]
            value = sm.lower_fused(tensors, chain)
            t2 = chain.final_tensor
            tensors[t2] = tensors[t2] + value.reshape(
                tuple(self.shapes[t2]))
            path = "matmul-fused"
        elif i in self.row_fused:
            chain = self.row_fused[i]
            for member in chain.members:
                member.low.epoch = epoch
            # the final tensor and every escaping intermediate come out
            # of one launch
            tensors.update(chain.lower(tensors))
            path = "rowchain"
        else:
            low = self._lowering(i)
            low.extern_memo = extern_memo
            path = low.run(tensors, epoch, stats)
        if stats is not None and path is not None:
            stats[path] = stats.get(path, 0) + 1
        return path

    def run_epoch(
        self,
        tensors: dict[int, torch.Tensor],
        batches: dict[int, np.ndarray],
        epoch: int,
        seeds,
    ) -> dict[int, torch.Tensor]:
        """Run one full epoch; ``batches`` maps input tid -> stacked array
        of shape [n_batches, batch, ...].  Returns updated state tensors."""
        state = {tid: tensors[tid] for tid in self.donated_tids}
        const_inputs = {
            tid: tensors[tid]
            for tid in self.kept_tids
            if tid not in batches
        }
        stacked = {
            tid: torch.from_numpy(np.ascontiguousarray(value)).to(
                device=self.device, dtype=self.dtype)
            for tid, value in batches.items()
        }
        for i, seed in enumerate(seeds):
            batch = {tid: value[i] for tid, value in stacked.items()}
            result = self.run({**const_inputs, **state, **batch},
                              self.shapes, epoch, int(seed))
            state = {tid: result[tid] for tid in state}
        return state
