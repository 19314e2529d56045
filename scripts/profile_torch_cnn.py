"""Time and profile the PyTorch/CUDA port's fashion-MNIST epoch on one GPU.

    python3 scripts/profile_torch_cnn.py [--epochs N] [--out FILE]
                                        [--root DIR]

bench.py's epoch (bench.py:1227-1245): fashion_mnist_cnn with random
weights from seed 0 and its default optimizer (adam, eta 0.01), 8192
samples of N(0, 1) from seed 0 with random one-hot labels, batch 256,
``fit(scan_batches=True)``, precision "highest" (TF32 off), on the card.
Reports:

- the lowering stats of the "fit" target (``conv`` counts the kernels
  that ran as cuDNN convolutions);
- one cold epoch, then ``--epochs`` warm epochs, host clock ending in
  torch.cuda.synchronize(): seconds and samples/s each;
- one warm epoch under torch.profiler: wall ms, device ms, the device's
  busy share of the wall time, and the operators that take the most
  device time;
- the example's epoch (examples/fashion_mnist.py:41-53: 4096 synthetic
  samples, batch 32) through ``io.fit_epochs``, without a prefetcher and
  with ``prefetch=2`` in turns (0, 2, 2, 0, 0, 2), each after a warm
  epoch of its own: seconds each.

Each summary line names the card and its power limit.  The profiler's
table goes to ``--out`` (default ``build/profile_torch_cnn.txt`` under the
working directory).  ``--root`` imports ``exprgrad_torch`` from another
checkout (a copy with a change to compare, run in its own process).
Needs a CUDA device; imports no jax.
"""

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from profile_torch_serving import gpu_line, profiled  # noqa: E402

# the package of the checkout ``--root`` names (after the import above,
# which puts this checkout's root first)
if "--root" in sys.argv:
    sys.path.insert(0, str(Path(sys.argv[sys.argv.index("--root") + 1])
                           .resolve()))

N_SAMPLES, BATCH = 8192, 256
EXAMPLE_SAMPLES, EXAMPLE_BATCH = 4096, 32


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--out", default="build/profile_torch_cnn.txt")
    ap.add_argument("--root", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_cnn: needs a CUDA device", file=sys.stderr)
        return 2
    import exprgrad_torch as egt
    from exprgrad_torch.models import fashion_mnist_cnn

    gpu = gpu_line()
    where = Path(egt.__file__).resolve().parents[1]
    print(f"gpu: {gpu}; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}; exprgrad_torch from {where}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    rng = np.random.default_rng(0)
    data = {"x": rng.normal(size=(N_SAMPLES, 28, 28)).astype(np.float32),
            "y": egt.one_hot(rng.integers(0, 10, N_SAMPLES), 10)}
    model = egt.compile(fashion_mnist_cnn(), seed=0, device="cuda")

    def epoch():
        model.fit("fit", data, batch_size=BATCH, scan_batches=True,
                  log_status=False)
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    epoch()
    cold = time.perf_counter() - t0
    print(f"lowering of fit: {model.lowering_stats('fit')}")
    runs = []
    for _ in range(args.epochs):
        t0 = time.perf_counter()
        epoch()
        runs.append(time.perf_counter() - t0)
    print(f"bench.py epoch ({N_SAMPLES} samples, batch {BATCH}, "
          f"scan_batches, precision highest): cold {cold:.4f} s; warm "
          f"{[round(r, 4) for r in runs]} s, "
          f"{[round(N_SAMPLES / r, 1) for r in runs]} samples/s on {gpu}")
    with open(args.out, "a") as out:
        out.write(f"{gpu}; exprgrad_torch from {where}\n")
        profiled(f"bench.py epoch [{N_SAMPLES // BATCH} x {BATCH}]", epoch,
                 out, gpu)

    from exprgrad_torch.io import Batches, fit_epochs

    rng = np.random.default_rng(0)
    labels = rng.integers(0, 10, EXAMPLE_SAMPLES)
    x = rng.normal(0, 0.1, (EXAMPLE_SAMPLES, 28, 28)).astype(np.float32)
    for i, label in enumerate(labels):
        x[i, label:label + 10, label:label + 10] += 1.0
    example = {"x": x, "y": egt.one_hot(labels, 10)}
    models = {depth: egt.compile(fashion_mnist_cnn(eta=0.01), seed=0,
                                 device="cuda") for depth in (0, 2)}
    runs = {0: [], 2: []}
    for depth in (0, 2, 2, 0, 0, 2):
        model = models[depth]
        if not runs[depth] and model.epoch == 0:  # a warm epoch first
            fit_epochs(model, "fit", Batches(example, EXAMPLE_BATCH),
                       prefetch=depth)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit_epochs(model, "fit", Batches(example, EXAMPLE_BATCH),
                   prefetch=depth)
        torch.cuda.synchronize()
        runs[depth].append(round(time.perf_counter() - t0, 4))
    print(f"the example's epoch ({EXAMPLE_SAMPLES} samples, batch "
          f"{EXAMPLE_BATCH}, fit_epochs) s, in turns: prefetch 0 {runs[0]}, "
          f"prefetch 2 {runs[2]} on {gpu}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
