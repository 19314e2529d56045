"""B2, B3 and B4's share of their roofline over the traced steps: each
launch's least time at the cell's shape (operations over split TF32's
165 TFLOP/s, or bytes over 3.35 TB/s; ``flops.flash_bound_s``), summed
over the launches the trace shows, over their device time."""

from portbench import flops

KERNELS = (("fwd", "flash_fwd_kernel"), ("dq", "flash_bwd_dq_kernel"),
           ("dkv", "flash_bwd_dkv_kernel"))


def read(run):
    if run.trace is None:
        return None
    b, seq = run.counters["batch"], run.counters["seq"]
    bound = took = 0.0
    for kind, name in KERNELS:
        seconds, launches = run.trace.time_of(name)
        bound += launches * flops.flash_bound_s(run.sizes, b, seq, kind)
        took += seconds
    return 100.0 * bound / took if took > 0 else None
