"""Mean milliseconds of a greedy decode step of the causal path in the
window (the ``causal.decode_step`` span: the read of the lanes still
active, which waits for the previous forward, and the enqueue of the
next). From the program's tracer (``stats()["trace"]``); nothing from a
program without the span."""


def read(ctx):
    n, seconds, _ = (ctx.window.stats.get("trace") or {}).get("spans", {}).get("causal.decode_step", (0, 0.0, 0))
    return 1e3 * seconds / n if n else None
