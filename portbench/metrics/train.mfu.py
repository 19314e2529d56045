"""Model FLOPs of the window's train steps (6 x matmul parameters x
tokens, plus the causal attention forward three times;
``flops.train_flops``) over the window's seconds, as a share of 165
TFLOP/s (split TF32, the fastest float32-exact rate)."""

from portbench import flops


def read(run):
    window = run.counters.get("window_s", 0)
    if window <= 0:
        return None
    return 100.0 * run.counters["model_flops"] / window \
        / flops.MFU_PEAK_FLOPS
