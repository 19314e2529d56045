"""The Mamba kernels' share of their roofline over the traced slice: the
least time the rows the slice's tokens ran through them need (each row's
inputs read once, its outputs written once, a live row's conv and scan
state read and written once, and each launch's weights once; over 3.35
TB/s, or the operations over 67 TFLOP/s; ``flops_hybrid``), over the
device time of ``mamba_conv_kernel`` and ``mamba_scan_kernel`` in the
slice."""

from portbench import flops_hybrid


def read(run):
    launch = run.counters.get("scan_launch_bytes")
    if run.trace is None or not launch:
        return None
    seconds, nbytes = 0.0, run.counters.get("scan_bytes", 0)
    for name, per_launch in launch.items():
        s, launches = run.trace.time_of(name)
        seconds += s
        nbytes += per_launch * launches
    ops = run.counters.get("scan_ops", 0)
    if seconds <= 0 or not ops:
        return None
    return 100.0 * flops_hybrid.bound_s(ops, nbytes) / seconds
