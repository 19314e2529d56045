"""Measured schedule autotuning.

Counterpart of ``exprgrad_tpu/autotune.py``.  ``Model.autotune(target,
args)`` times candidate tile assignments for every scheduled kernel end
to end through a fresh :class:`~exprgrad_torch.backend.executor.
TorchExecutor` — the path user calls take, so epilogue fusion and
cross-kernel effects are captured — and installs the fastest.  The
schedule-stripped candidate (the port's plain lowering of the kernel) is
always among them, so autotuning can only match or beat both the hand
schedule and the plain lowering on the device it ran on.

Search: greedy coordinate descent per kernel (kernels tuned in order;
each tiled loop's ``tile_size`` swept over :data:`DEFAULT_TILE_SIZES`
while the others are held fixed), as in the JAX package.  A tile reaches
kernel B1 as its block (``backend/scheduled.py::block_for``); on kernel
B5 a tile only permits blocking an axis (``backend/mapreduce.py``), so
B5's tile candidates run one plan.

Timing: ``chain`` runs issued back to back on tensors already on the
model's device, then one fence (``torch.cuda.synchronize`` on the card,
nothing more on the CPU, whose runs are synchronous), the minimum over
``reps``.

Persistence (:func:`export_tuning`, :func:`apply_tuning`) uses the JAX
package's format, so a tuning exported by either package applies to the
other's model of the same source.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .errors import ModelRuntimeError
from .passes import infer_shapes

__all__ = [
    "tune", "TuneReport", "KernelTuneEntry",
    "export_tuning", "apply_tuning",
]

# The sizes of kernel B1's block lattice on m and n
# (exprgrad_torch/ops/matmul.py BLOCKS); k's 32 and 64 are reached from
# any tile under 64 and from any tile of 64 or more.
DEFAULT_TILE_SIZES = (64, 128, 256)

STRIP_LABEL = "plain (no schedule)"


@dataclass
class KernelTuneEntry:
    kernel_index: int
    writes: str
    candidates: list[dict] = field(default_factory=list)
    chosen: Optional[dict] = None


@dataclass
class TuneReport:
    target: str
    baseline_s: float
    tuned_s: float
    entries: list[KernelTuneEntry] = field(default_factory=list)

    @property
    def speedup(self) -> float:
        return self.baseline_s / self.tuned_s if self.tuned_s else 1.0

    def __str__(self) -> str:
        lines = [
            f"autotune {self.target!r}: {self.baseline_s * 1e3:.3f} ms -> "
            f"{self.tuned_s * 1e3:.3f} ms ({self.speedup:.2f}x)"
        ]
        for e in self.entries:
            lines.append(f"  kernel {e.kernel_index} -> {e.writes}:")
            for c in e.candidates:
                mark = " *" if c is e.chosen else ""
                lines.append(
                    f"    {c['label']:<24} {c['seconds'] * 1e3:9.3f} ms{mark}"
                )
        return "\n".join(lines)


def _loop_label(kernel, loop) -> str:
    name = ""
    if 0 <= loop.iter_reg < len(kernel.regs):
        name = kernel.regs[loop.iter_reg].name
    return name or f"r{loop.iter_reg}"


def _saved_schedules(kernel):
    return [
        (
            loop.schedule.tile,
            loop.schedule.parallel,
            loop.schedule.tile_size,
            loop.schedule.share_cache,
        )
        for loop in kernel.loops
    ]


def _restore_schedules(kernel, saved) -> None:
    for loop, (tile, parallel, tile_size, share_cache) in zip(
        kernel.loops, saved
    ):
        loop.schedule.tile = tile
        loop.schedule.parallel = parallel
        loop.schedule.tile_size = tile_size
        loop.schedule.share_cache = share_cache


def _target(model, target_name: str):
    if target_name not in model.program.targets:
        raise ModelRuntimeError(
            f"{target_name!r} is not a target of the model"
        )
    return model.program.targets[target_name]


def tune(
    model,
    target_name: str,
    args: Optional[dict] = None,
    *,
    tile_sizes=DEFAULT_TILE_SIZES,
    reps: int = 3,
    chain: int = 4,
    verbose: bool = False,
) -> TuneReport:
    """Tune ``target_name``'s kernel schedules in place; returns a report.

    Prefer calling :meth:`Model.autotune`, which also pins
    ``schedule_mode="force"`` and clears the executor cache so later
    calls run the tuned schedule.
    """
    from .backend.executor import TorchExecutor
    from .model import matmul_precision

    target = _target(model, target_name)
    args = args or {}
    program = model.program
    shapes = infer_shapes(program, target_name, model._input_shapes(args))
    device = model.device
    tensors: dict[int, torch.Tensor] = {
        program.inputs[name]: model._to_device(value)
        for name, value in args.items()
    }
    tensors.update(model._state(model.params))
    tensors.update(model._state(model.caches))

    def fence():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def measure():
        """Plan the CURRENT schedule state in a fresh executor and time it.

        The executor returns new tensors and the model's state is never
        assigned, so repeated measurement of mutating targets like
        "train" is side-effect free."""
        ex = TorchExecutor(program, target_name, shapes, device,
                           schedule_mode="force")
        with matmul_precision(model.precision):
            out = ex.run(tensors, shapes, model.epoch, 0)  # plan + warm
            fence()
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                for _ in range(chain):
                    out = ex.run(tensors, shapes, model.epoch, 0)
                fence()
                best = min(best, (time.perf_counter() - t0) / chain)
        return best, out

    scheduled = [
        (i, k)
        for i, k in enumerate(target.kernels)
        if any(l.schedule.tile or l.schedule.parallel for l in k.loops)
    ]
    baseline_s, baseline_out = measure()
    report = TuneReport(
        target=target_name, baseline_s=baseline_s, tuned_s=baseline_s
    )
    if verbose:
        print(f"autotune: baseline {baseline_s * 1e3:.3f} ms, "
              f"{len(scheduled)} scheduled kernel(s)", flush=True)

    current_s = baseline_s
    for ki, kernel in scheduled:
        writes = "?"
        if kernel.write is not None:
            tdef = program.tensors[kernel.write.tensor]
            writes = tdef.name or f"t{kernel.write.tensor}"
        entry = KernelTuneEntry(kernel_index=ki, writes=writes)
        original = _saved_schedules(kernel)
        start = {
            "label": "original schedule",
            "seconds": current_s,
            "schedule": original,
        }
        entry.candidates.append(start)
        best = start

        # candidate: strip this kernel's schedule -> the plain lowering
        for loop in kernel.loops:
            loop.schedule.tile = False
            loop.schedule.parallel = False
            loop.schedule.share_cache = False
        t_plain, _ = measure()
        plain_cand = {
            "label": STRIP_LABEL,
            "seconds": t_plain,
            "schedule": _saved_schedules(kernel),
        }
        entry.candidates.append(plain_cand)
        if t_plain < best["seconds"]:
            best = plain_cand
        _restore_schedules(kernel, original)

        # greedy coordinate descent over tiled loops' tile sizes
        for loop in kernel.loops:
            if not loop.schedule.tile:
                continue
            label = _loop_label(kernel, loop)
            for size in tile_sizes:
                if size == loop.schedule.tile_size:
                    continue
                saved_size = loop.schedule.tile_size
                loop.schedule.tile_size = size
                t, _ = measure()
                cand = {
                    "label": f"tile {label}={size}",
                    "seconds": t,
                    "schedule": _saved_schedules(kernel),
                }
                entry.candidates.append(cand)
                if verbose:
                    print(f"autotune: kernel {ki} {cand['label']}: "
                          f"{t * 1e3:.3f} ms", flush=True)
                if t < best["seconds"]:
                    best = cand  # keep the new size (descent step)
                else:
                    loop.schedule.tile_size = saved_size
        # land on the per-kernel winner (the strip wins only if it beat
        # every tiled variant)
        _restore_schedules(kernel, best["schedule"])
        entry.chosen = best
        current_s = best["seconds"]
        report.entries.append(entry)
        if verbose:
            print(f"autotune: kernel {ki} -> {best['label']} "
                  f"({best['seconds'] * 1e3:.3f} ms)", flush=True)

    tuned_s, tuned_out = measure()
    report.tuned_s = tuned_s

    # numeric guard: the tuned program must agree with the baseline
    # (same seed, same inputs) — a mis-planned candidate that survived
    # to installation would be caught here, not in user training
    key = target.output if target.output in baseline_out else None
    if key is not None:
        a = baseline_out[key].double().cpu().numpy()
        b = tuned_out[key].double().cpu().numpy()
        scale = float(np.max(np.abs(a))) or 1.0
        if not np.allclose(a, b, rtol=1e-4, atol=1e-4 * scale):
            _restore_all(target, report)
            raise ModelRuntimeError(
                "autotune: tuned schedule changed the target's output; "
                "schedules restored — please report this"
            )
    return report


def _restore_all(target, report: TuneReport) -> None:
    for entry in report.entries:
        kernel = target.kernels[entry.kernel_index]
        _restore_schedules(kernel, entry.candidates[0]["schedule"])


# --- tuning persistence ---------------------------------------------------
#
# Checkpoints serialize the SOURCE program (io/serialize.py), but tuned
# schedules live on the compiled program's kernels, so save_model alone
# loses them.  export_tuning captures every kernel's schedule state as a
# JSON-serializable dict keyed by (kernel index, loop index) — stable
# across recompiles because the pass pipeline is deterministic for a
# given source, and the same in both packages, whose pipelines are one —
# and apply_tuning re-installs it on a freshly loaded or recompiled model
# of the SAME source.

TUNING_FORMAT = 1


def export_tuning(model, target_name: str) -> dict:
    """Capture ``target_name``'s current kernel schedules (e.g. right
    after :meth:`Model.autotune`) as a JSON-serializable dict."""
    target = _target(model, target_name)
    kernels = []
    for ki, kernel in enumerate(target.kernels):
        loops = [
            {
                "tile": loop.schedule.tile,
                "parallel": loop.schedule.parallel,
                "tile_size": loop.schedule.tile_size,
                "share_cache": loop.schedule.share_cache,
            }
            for loop in kernel.loops
        ]
        # record EVERY kernel: "tuned to no schedule at all" (the strip
        # won) is as much a tuning decision as a tile size
        kernels.append({"kernel": ki, "loops": loops})
    return {
        "format": TUNING_FORMAT,
        "target": target_name,
        "n_kernels": len(target.kernels),
        "kernels": kernels,
    }


def apply_tuning(model, data: dict) -> None:
    """Re-install an :func:`export_tuning` capture on a model compiled
    from the same source; pins ``schedule_mode='force'`` and clears the
    executor cache so the next call honors it."""
    if data.get("format") != TUNING_FORMAT:
        raise ModelRuntimeError(
            f"unsupported tuning format {data.get('format')!r}"
        )
    target_name = data["target"]
    target = _target(model, target_name)
    if len(target.kernels) != data["n_kernels"]:
        raise ModelRuntimeError(
            f"tuning was captured for {data['n_kernels']} kernels but "
            f"target {target_name!r} compiled to {len(target.kernels)} "
            "— the model source changed since export_tuning"
        )
    for item in data["kernels"]:
        ki = item["kernel"]
        if not 0 <= ki < len(target.kernels):
            raise ModelRuntimeError(f"tuning kernel index {ki} out of range")
        kernel = target.kernels[ki]
        if len(kernel.loops) != len(item["loops"]):
            raise ModelRuntimeError(
                f"tuning loop count mismatch on kernel {ki} — the model "
                "source changed since export_tuning"
            )
        for loop, sched in zip(kernel.loops, item["loops"]):
            loop.schedule.tile = bool(sched["tile"])
            loop.schedule.parallel = bool(sched["parallel"])
            loop.schedule.tile_size = int(sched["tile_size"])
            loop.schedule.share_cache = bool(sched["share_cache"])
    model.schedule_mode = "force"
    model._executors.clear()
