"""Profile the PyTorch/CUDA port's continuous batcher on one GPU.

    python3 scripts/profile_torch_batcher.py [--out FILE]

Serves chip_smoke.py's path (e): the serving model
flash_transformer(vocab=2048, dim=512, heads=4, hidden=2048, blocks=2,
max_seq=256) with random weights from seed 0, behind
ContinuousBatcher(slots=8, capacity=256, paged=True, page_size=32,
pool_pages=32), bfloat16 cache, under bench.py's staggered mix of 12
requests (half submitted up front, one more before each step()).  For
attention="flash" (the paged-attention kernel, B7) and "gather" (a dense
view, then decode attention) it reports:

- after a warm drive of each, six drives on the host clock in turns
  (flash, gather, gather, flash, flash, gather), each ended by
  torch.cuda.synchronize(): seconds, generated tokens/s, the host time
  per step() and per decode dispatch, and the drive's host time split
  into admissions (prefills and page bookkeeping), the decode call
  (enqueueing one decode step) and the rest of step() (mostly waiting
  for the picked tokens to reach the host);
- one warm drive under torch.profiler: wall ms, device ms (the kernels'
  and copies' own time), the device's busy share of the wall time, B7's
  device time, launches and share of the device time, and the operators
  that take the most device time;
- cProfile of one warm drive: the host functions by their own time.

Each summary line names the card and its power limit.  The full tables
go to ``--out`` (default ``build/profile_torch_batcher.txt`` under the
working directory).  Needs a CUDA device; imports no jax.
"""

import argparse
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from profile_torch_serving import device_ms, gpu_line
from profile_torch_scheduled import host_profile

from chip_smoke import SERVING, drive_mix, staggered_mix

B7_KERNEL = "paged_decode_kernel"
TURNS = ("flash", "gather", "gather", "flash", "flash", "gather")


class PhaseClock:
    """Host seconds spent in the batcher's admission and decode methods
    while installed (``with PhaseClock() as clock:``)."""

    PHASES = {"admit": "_progress_admission", "decode": "_decode_paged"}

    def __enter__(self):
        from exprgrad_torch.models.batcher import ContinuousBatcher

        self.cls, self.saved = ContinuousBatcher, {}
        self.seconds = dict.fromkeys(self.PHASES, 0.0)
        for phase, name in self.PHASES.items():
            fn = self.saved[name] = getattr(self.cls, name)
            setattr(self.cls, name, self._timed(phase, fn))
        return self

    def _timed(self, phase, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[phase] += time.perf_counter() - t0
        return timed

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.cls, name, fn)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/profile_torch_batcher.txt")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_batcher: needs a CUDA device", file=sys.stderr)
        return 2
    import exprgrad_torch as egt
    from exprgrad_torch.models import FlashLMServer, flash_transformer

    gpu = gpu_line()
    print(f"gpu: {gpu}; torch {torch.__version__}, cuda {torch.version.cuda}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    model = egt.compile(flash_transformer(**SERVING), seed=0, device="cuda")
    server = FlashLMServer(model)
    prompts, budgets = staggered_mix(SERVING["vocab"])
    tokens = sum(budgets)

    with open(args.out, "w") as out:
        out.write(f"{gpu}\n")
        for kind in ("flash", "gather"):
            drive_mix(server, kind, prompts, budgets)  # warm
        for kind in TURNS:
            with PhaseClock() as clock:
                _, b, secs, steps = drive_mix(server, kind, prompts, budgets)
            admit, decode = clock.seconds["admit"], clock.seconds["decode"]
            print(f"path (e) {kind}: {secs:.4f} s, "
                  f"{tokens / secs:.1f} tokens/s, "
                  f"{secs / steps * 1e3:.3f} ms per step() ({steps} calls), "
                  f"{secs / b.stats['dispatches'] * 1e3:.3f} ms per decode "
                  f"dispatch ({b.stats['dispatches']}); host s: admissions "
                  f"{admit:.4f}, decode calls {decode:.4f}, the rest "
                  f"{secs - admit - decode:.4f}; "
                  f"{b.stats['preemptions']} preemptions on {gpu}")
        for kind in ("flash", "gather"):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                drive_mix(server, kind, prompts, budgets)
                wall = (time.perf_counter() - t0) * 1e3
            dev = device_ms(prof)
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA]
            b7 = [e for e in events if B7_KERNEL in e.key]
            b7_ms = sum(e.self_device_time_total for e in b7) / 1e3
            b7_n = sum(e.count for e in b7)
            print(f"path (e) {kind} (profiler on): wall {wall:.3f} ms, "
                  f"device {dev:.3f} ms, busy share {dev / wall:.4f}; B7 "
                  f"{b7_ms:.3f} ms in {b7_n} launches, "
                  f"{b7_ms / dev if dev else 0.0:.4f} of the device time "
                  f"on {gpu}")
            for e in sorted(events, key=lambda e: -e.self_device_time_total
                            )[:10]:
                print(f"  {e.self_device_time_total / 1e3:9.3f} ms  "
                      f"{e.count:6d} x  {e.key[:70]}")
            table = prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=30,
                max_name_column_width=60)
            out.write(f"== path (e) {kind}: wall {wall:.3f} ms, device "
                      f"{dev:.3f} ms\n{table}\n")
            host_profile(f"path (e) {kind} drive",
                         lambda: drive_mix(server, kind, prompts, budgets),
                         out, rows=12)
    print(f"full tables: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
