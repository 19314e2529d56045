"""95th percentile of submit time minus due time (the benchmark's clock)
over the window's requests due before the traced slice, which slows the
loop: how long the single-threaded loop sat in ``step()`` while a
request was due."""

import numpy as np


def read(run):
    lag = np.asarray(run.counters.get("submit_lag_ms", []), float)
    lag = lag[np.isfinite(lag)]
    return float(np.percentile(lag, 95)) if lag.size else None
