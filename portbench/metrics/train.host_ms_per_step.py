"""Mean host milliseconds of a window's ``apply("train")`` call on the
benchmark's clock, with no synchronize: the executor's and the
lowering's enqueue time, and whatever the host waits for inside."""


def read(run):
    return run.counters.get("host_ms_per_step")
