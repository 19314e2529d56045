"""Profile the PyTorch/CUDA port's train step on one GPU.

    python3 scripts/profile_torch_training.py [--out FILE]

Builds the model that chip_smoke.py trains,
flash_transformer(vocab=2048, dim=512, heads=4, hidden=2048, blocks=2,
max_seq=256) with random weights from seed 0 and its default optimizer
(adam, eta 0.005), on the card, and reports for apply("train") on one
batch of [8, 256] tokens with one-hot labels:

- ten warm steps, host clock ending in torch.cuda.synchronize(), ms each;
- one warm step under torch.profiler: wall ms, device ms, the device's
  busy share of the wall time, and the operators that take the most
  device time (the flash kernels among them);
- cProfile of one warm step: the host functions by their own time.

Each summary line names the card and its power limit.  The full tables
go to ``--out`` (default ``build/profile_torch_training.txt`` under the
working directory).  Needs a CUDA device; imports no jax.
"""

import argparse
import cProfile
import io
import os
import pstats
import sys
import time

import numpy as np
import torch

from profile_torch_serving import SERVING, gpu_line, profiled

BATCH, SEQ = 8, 256


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/profile_torch_training.txt")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_training: needs a CUDA device", file=sys.stderr)
        return 2
    import exprgrad_torch as egt
    from exprgrad_torch.models import flash_transformer

    gpu = gpu_line()
    print(f"gpu: {gpu}; torch {torch.__version__}, cuda {torch.version.cuda}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    model = egt.compile(flash_transformer(**SERVING), seed=0, device="cuda")
    rng = np.random.default_rng(0)
    phase = rng.integers(0, SERVING["vocab"], BATCH)
    toks = (phase[:, None] + np.arange(SEQ)[None, :]) % SERVING["vocab"]
    batch = {"tokens": toks.astype(np.float32),
             "labels": np.eye(SERVING["vocab"], dtype=np.float32)[
                 (toks + 1) % SERVING["vocab"]]}

    def step():
        model.epoch += 1
        model.apply("train", batch)
        torch.cuda.synchronize()

    step()
    step()  # warm: kernel build, executor, allocator, cuBLAS handles
    runs = []
    for _ in range(10):
        t0 = time.perf_counter()
        step()
        runs.append(round((time.perf_counter() - t0) * 1e3, 3))
    mean = sum(runs) / len(runs)
    print(f"train step [{BATCH},{SEQ}] warm ms, 10 steps: {runs}; mean "
          f"{mean:.3f} ms, {BATCH * SEQ / mean * 1e3:.1f} training tokens/s "
          f"on {gpu}")

    with open(args.out, "w") as out:
        out.write(f"{gpu}\n")
        profiled(f"train step [{BATCH},{SEQ}]", step, out, gpu)
        prof = cProfile.Profile()
        prof.enable()
        step()
        prof.disable()
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(15)
        out.write(f"== cProfile, one warm train step\n{text.getvalue()}\n")
    rows = [ln for ln in text.getvalue().splitlines()
            if ln.strip()[:1].isdigit()][:10]
    print("cProfile, one warm train step, by own time:")
    print("\n".join(rows))
    print(f"full tables: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
