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
"""

from __future__ import annotations

import numpy as np
import torch

from .. import ir
from ..interp import accumulation_identity, extreme_accumulated_results
from ..ir import Program

from .policy import SchedulePolicy
from .rowchain import plan_rowchain_fusions
from .scheduled import plan_epilogue_fusions
from .torcheval import KernelLowering


def torch_dtype(program: Program) -> torch.dtype:
    return getattr(torch, program.scalar_type.value)


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
        # matmul+epilogue fusion plan: scheduled matmuls whose elementwise
        # consumer chain folds into the kernel's epilogue
        (self.fused, self._skip_kernels, self._fused_away,
         self.epilogue_declines) = plan_epilogue_fusions(
            program, self.target, shapes, self.dtype, device, self.policy)
        self._consts: dict = {}  # literal -> 0-d device tensor
        self._lowerings: dict[int, KernelLowering] = {}
        self._writers: dict[int, int] = {}  # tensor id -> writing kernels
        for kernel in self.target.kernels:
            if kernel.write is not None:
                tid = kernel.write.tensor
                self._writers[tid] = self._writers.get(tid, 0) + 1
        # row-chain plan: runs of scheduled map/reduce kernels fused into
        # one kernel B6 each (matmul chains take precedence)
        (self.row_fused, row_skip, row_away,
         self.rowchain_declines) = plan_rowchain_fusions(
            program, self.target, self._lowering, self.policy,
            consumed=self._skip_kernels | set(self.fused))
        self._skip_kernels = self._skip_kernels | row_skip
        self._fused_away = self._fused_away | row_away

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
        self.stats: dict[str, int] = {}  # lowering paths, from the 1st run
        self._ran = False

    def _lowering(self, i: int) -> KernelLowering:
        """Kernel ``i``'s lowering, made on first use and kept."""
        low = self._lowerings.get(i)
        if low is None:
            kernel = self.target.kernels[i]
            low = KernelLowering(
                self.program, kernel, self.shapes, self.dtype, self.device,
                self.policy, None, self._consts)
            # a RESULT tensor with one writer holds its accumulation
            # identity when that kernel runs: the generated kernels store
            # their value without reading it
            tid = kernel.write.tensor if kernel.write is not None else None
            low.fresh_output = (
                tid is not None
                and self.program.tensors[tid].kind == ir.TensorKind.RESULT
                and self._writers.get(tid) == 1)
            self._lowerings[i] = low
        return low

    def run(
        self,
        tensors: dict[int, torch.Tensor],
        shapes: dict[int, list[int]],
        epoch: int,
        seed: int,
    ) -> dict[int, torch.Tensor]:
        """Run the target on device tensors; returns {tid: tensor} for the
        output and every updated parameter/cache."""
        program = self.program
        tensors = dict(tensors)
        for tid in sorted(self.target.tensors):
            if (program.tensors[tid].kind != ir.TensorKind.RESULT
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
        if self.random_tids:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
            for tid in self.random_tids:
                lo, hi = program.tensors[tid].random_range
                tensors[tid] = torch.rand(
                    tuple(self.shapes[tid]), generator=gen, dtype=self.dtype,
                    device=self.device,
                ) * (hi - lo) + lo
        stats = None if self._ran else self.stats
        extern_memo: dict = {}  # one logical extern call per run
        for i, kernel in enumerate(self.target.kernels):
            if i in self._skip_kernels:
                continue  # folded into an earlier matmul or row chain
            if i in self.fused:
                sm, chain = self.fused[i]
                value = sm.lower_fused(tensors, chain)
                t2 = chain.final_tensor
                tensors[t2] = tensors[t2] + value.reshape(
                    tuple(self.shapes[t2]))
                if stats is not None:
                    stats["matmul-fused"] = stats.get("matmul-fused", 0) + 1
                continue
            if i in self.row_fused:
                chain = self.row_fused[i]
                for member in chain.members:
                    member.low.epoch = epoch
                # the final tensor and every escaping intermediate come
                # out of one launch
                tensors.update(chain.lower(tensors))
                if stats is not None:
                    stats["rowchain"] = stats.get("rowchain", 0) + 1
                continue
            low = self._lowering(i)
            low.extern_memo = extern_memo
            low.run(tensors, epoch, stats)
        extern_memo.clear()  # the kept lowerings must not hold its outputs
        self._ran = True
        return {tid: tensors[tid] for tid in self.output_tids}

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
