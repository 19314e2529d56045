"""95th percentile of the program's ``egt.batcher.queued`` spans, a
request's ``submit()`` to the start of its first prefill unit (the wait
for a slot and behind the step's earlier admissions), over the requests
whose first prefill unit began in the traced slice."""

from portbench import spans
from portbench.harness import percentile


def read(run):
    found = spans.of(run)
    if found is None:
        return None
    waits = [1e3 * spans.wall_s(s) for s in found
             if s["name"] == "egt.batcher.queued"]
    return percentile(waits, 95) if waits else None
