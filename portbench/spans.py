"""The program's own spans in a traced run's slice, for the readers of
the metrics built on them: ``exprgrad_torch.tracing`` keeps the spans
recorded while a profiler ran, and in a run that profiler is the slice's
alone."""


def of(run):
    """The slice's spans (``exprgrad_torch.tracing.spans()``), or None
    where the run traced no device work or the program keeps no spans
    (an older program without ``exprgrad_torch.tracing``)."""
    if run.trace is None or not run.trace.kernels:
        return None
    try:
        from exprgrad_torch import tracing
    except ImportError:
        return None
    return tracing.spans()


def wall_s(span) -> float:
    return (span["end_ns"] - span["start_ns"]) * 1e-9


def enclosing(span, by_id: dict, name: str):
    """The nearest span named ``name`` that encloses ``span`` (by its
    parents), or None."""
    up = by_id.get(span["parent"])
    while up is not None and up["name"] != name:
        up = by_id.get(up["parent"])
    return up


def device_share(run, keep) -> float | None:
    """The device seconds of the executor's kernel spans that ``keep``
    (a test of a span's attributes) takes, as a share of the device
    seconds of its target runs, in %; None without both."""
    found = of(run)
    if not found:
        return None
    runs = [s["device_s"] for s in found if s["name"] == "egt.executor.run"]
    kernels = [s for s in found if s["name"] == "egt.executor.kernel"]
    if not runs or None in runs or not kernels \
            or any(s["device_s"] is None for s in kernels):
        return None
    whole = sum(runs)
    if whole <= 0:
        return None
    return 100.0 * sum(s["device_s"] for s in kernels
                       if keep(s["attrs"])) / whole
