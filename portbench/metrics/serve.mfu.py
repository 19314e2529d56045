"""Model FLOPs of the prefill and decode work the traced slice's steps
did (``flops.prefill_flops`` of each first token's prompt, and
``flops.decode_flops`` of each later token at its context) over the
summed wall time of those ``step()`` calls, as a share of 165 TFLOP/s
(split TF32, the fastest float32-exact rate)."""

from portbench import flops


def read(run):
    step_s = sum(run.counters.get("slice_step_s", []))
    work = run.counters.get("slice_flops", 0)
    if step_s <= 0 or not work:
        return None
    return 100.0 * work / step_s / flops.MFU_PEAK_FLOPS
