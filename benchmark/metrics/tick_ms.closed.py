"""Mean milliseconds of a scheduler tick's call in the window: the
dispatch's total over every phase (pool update, each mode's programs and
the read of their outputs) over the scheduler's ticks."""


def read(ctx):
    n = ctx.window.stats.get("n_ticks")
    if not n:
        return None
    return 1e3 * sum(v[1] for v in ctx.window.phases.values()) / n
