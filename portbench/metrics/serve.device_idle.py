"""Share of the traced slice's wall time in which no operation ran on the
device (1 - the union of device intervals over the slice)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
