"""Mean milliseconds of a group tick's ``sched.finish`` span in the window:
the loop thread's ``finish_tick`` over the group's lanes after the tick's
outputs came back (the program's tracer, ``stats()["trace"]``, always on,
zeroed by ``reset_stats()`` at the window's start). Nothing from a program
without the tracer."""


def read(ctx):
    spans = (ctx.window.stats.get("trace") or {}).get("spans", {})
    n, total, _ = spans.get("sched.finish", (0, 0.0, 0))
    return 1e3 * total / n if n else None
