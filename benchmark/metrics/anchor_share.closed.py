"""Share of the window's lane-ticks that ran an anchor (a full-window encode
and prefill) rather than the inc path, from the dispatch's lanes per mode
(``TICK_PHASE_STATS``)."""

ANCHOR = ("anchor", "anchor_xkv")
TICK = ("anchor", "anchor_xkv", "inc", "inc_xkv", "legacy")


def read(ctx):
    ph = ctx.window.phases
    total = sum(ph[k][2] for k in TICK if k in ph)
    if not total:
        return None
    return 100.0 * sum(ph[k][2] for k in ANCHOR if k in ph) / total
