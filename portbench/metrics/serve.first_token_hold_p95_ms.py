"""95th percentile, over the traced slice's prefill units that picked a
request's first token (``egt.batcher.prefill`` with ``first``), of the
end of the ``egt.batcher.step`` around the unit minus the unit's end:
how long the first token waits on the host for the step's decode
dispatch and read back before ``step()`` hands it over."""

from portbench import spans
from portbench.harness import percentile


def read(run):
    found = spans.of(run)
    if found is None:
        return None
    by_id = {s["id"]: s for s in found}
    holds = []
    for s in found:
        if s["name"] != "egt.batcher.prefill" or not s["attrs"].get("first"):
            continue
        step = spans.enclosing(s, by_id, "egt.batcher.step")
        if step is not None:
            holds.append((step["end_ns"] - s["end_ns"]) * 1e-6)
    return percentile(holds, 95) if holds else None
