"""B7's share of its roofline over the traced slice: the least time the
decode rows the slice's steps served need (their live K/V in bfloat16,
query and output in float32, over 3.35 TB/s, or their operations over
67 TFLOP/s; ``flops.b7_bound_s``) over the device time of B7's split and
merge kernels in the slice."""

from portbench import flops


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.time_of("paged_split_kernel",
                                          "paged_merge_kernel")
    contexts = run.counters.get("b7_contexts", [])
    if not launches or not contexts or seconds <= 0:
        return None
    return 100.0 * flops.b7_bound_s(run.sizes, contexts) / seconds
