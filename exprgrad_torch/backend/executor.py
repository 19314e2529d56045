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

Not ported: the matmul-epilogue and row-chain fusion plans, which belong
to the scheduled-kernel emitters (``backend/pallasgen.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from exprgrad_tpu import ir
from exprgrad_tpu.interp import accumulation_identity, extreme_accumulated_results
from exprgrad_tpu.ir import Program

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
        self.schedule_mode = schedule_mode

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
            state_written
            | ({self.target.output} if self.target.output is not None
               else set())
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
        self._consts: dict = {}  # literal -> 0-d device tensor
        self.stats: dict[str, int] = {}  # lowering paths, from the 1st run
        self._ran = False

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
            if program.tensors[tid].kind != ir.TensorKind.RESULT:
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
        for kernel in self.target.kernels:
            KernelLowering(
                program, kernel, self.shapes, self.dtype, self.device,
                self.schedule_mode, extern_memo, self._consts,
            ).run(tensors, epoch, stats)
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
