"""Useful decode rows over rows computed in the window: the lanes still
active at each decode-loop iteration's start (``core.live``) over the
padded batch times the iterations run (``core.rows``), summed over every
tick program's decode loop (the program's tracer, ``stats()["trace"]``,
always on, zeroed at the window's start). Nothing from a program without
the counters."""


def read(ctx):
    counters = (ctx.window.stats.get("trace") or {}).get("counters", {})
    rows = counters.get("core.rows", 0)
    return 100.0 * counters.get("core.live", 0) / rows if rows else None
