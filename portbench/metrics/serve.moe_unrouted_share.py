"""The share of the expert rows the window computed that no router chose:
``100 * (moe_computed_rows - moe_routed_rows) / moe_computed_rows`` of
the batcher's counters over the window.  Prefill computes only routed
rows; a decode step inside the chunk graph computes every expert on
every slot and masks, so this is the decode's dense-masked waste."""


def read(run):
    computed = run.counters.get("moe_computed_rows", 0)
    routed = run.counters.get("moe_routed_rows", 0)
    if not computed:
        return None
    return 100.0 * (computed - routed) / computed
