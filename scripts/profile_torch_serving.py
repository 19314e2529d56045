"""Profile the PyTorch/CUDA port's serving path on one GPU.

    python3 scripts/profile_torch_serving.py [--out FILE]

Builds the serving model that chip_smoke.py drives,
flash_transformer(vocab=2048, dim=512, heads=4, hidden=2048, blocks=2,
max_seq=256) with random weights from seed 0, on the card, and reports:

- ten warm "predict" calls on [8, 256] tokens, host clock, ms each;
- one warm predict under torch.profiler: wall ms, device ms (the sum of
  the kernels' and copies' own time, as the profiler's "Self CUDA time
  total" counts it), the device's busy share of the wall time, and the
  operators that take the most device time;
- one warm greedy FlashLMServer.generate of 8 requests, 128-token
  prompts, 128 new tokens (bfloat16 cache), timed on the host clock
  without the profiler and then under it, with the same figures;
- cProfile of one warm predict: the host functions by their own time.

Each summary line names the card and its power limit.  The full
profiler tables go to ``--out`` (default
``build/profile_torch_serving.txt`` under the working directory).
Needs a CUDA device; imports no jax.
"""

import argparse
import cProfile
import io
import os
import pstats
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

SERVING = dict(vocab=2048, dim=512, heads=4, hidden=2048, blocks=2,
               max_seq=256)
BATCH, SEQ, PROMPT, NEW = 8, 256, 128, 128


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def device_ms(prof) -> float:
    """Summed own time of the device events, in ms."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e3


def profiled(name, fn, out, gpu):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = device_ms(prof)
    print(f"{name} (profiler on): wall {wall:.3f} ms, device {dev:.3f} ms, "
          f"busy share {dev / wall:.4f} on {gpu}")
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=25, max_name_column_width=60)
    out.write(f"== {name}: wall {wall:.3f} ms, device {dev:.3f} ms\n{table}\n")
    top = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  "
              f"{e.count:5d} x  {e.key[:70]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/profile_torch_serving.txt")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serving: needs a CUDA device", file=sys.stderr)
        return 2
    import exprgrad_torch as egt
    from exprgrad_torch.models import FlashLMServer, flash_transformer

    gpu = gpu_line()
    print(f"gpu: {gpu}; torch {torch.__version__}, cuda {torch.version.cuda}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    model = egt.compile(flash_transformer(**SERVING), seed=0, device="cuda")
    server = FlashLMServer(model)
    tokens = np.random.default_rng(0).integers(
        0, SERVING["vocab"], (BATCH, SEQ)).astype(np.float32)
    prompts = tokens[:, :PROMPT]

    def predict():
        return model.call("predict", {"tokens": tokens})

    def generate():
        return server.generate(prompts, n_new=NEW)

    predict()
    generate()  # warm: kernel build, allocator, cuBLAS handles
    runs = []
    for _ in range(10):
        t0 = time.perf_counter()
        predict()
        runs.append(round((time.perf_counter() - t0) * 1e3, 3))
    print(f"predict [{BATCH},{SEQ}] warm ms, 10 calls: {runs} on {gpu}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate()
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    print(f"generate {BATCH}x{PROMPT}->{NEW} greedy (profiler off): "
          f"{gen_s * 1e3:.3f} ms, {BATCH * NEW / gen_s:.1f} tokens/s "
          f"on {gpu}")

    with open(args.out, "w") as out:
        out.write(f"{gpu}\n")
        profiled(f"predict [{BATCH},{SEQ}]", predict, out, gpu)
        profiled(f"generate {BATCH}x{PROMPT}->{NEW} greedy", generate, out,
                 gpu)
        prof = cProfile.Profile()
        prof.enable()
        predict()
        prof.disable()
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(12)
        out.write(f"== cProfile, one warm predict\n{text.getvalue()}\n")
    rows = [ln for ln in text.getvalue().splitlines()
            if ln.strip()[:1].isdigit()][:8]
    print("cProfile, one warm predict, by own time:")
    print("\n".join(rows))
    print(f"full tables: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
