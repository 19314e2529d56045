"""The wall seconds of the traced slice's admission prefill units
(``egt.batcher.prefill``, each ended by its read back) over the wall
seconds of its ``step()`` calls (``egt.batcher.step``), in %: the share
of a step the decoding rows wait behind prefills."""

from portbench import spans


def read(run):
    found = spans.of(run)
    if found is None:
        return None
    step = sum(spans.wall_s(s) for s in found
               if s["name"] == "egt.batcher.step")
    if step <= 0:
        return None
    return 100.0 * sum(spans.wall_s(s) for s in found
                       if s["name"] == "egt.batcher.prefill") / step
