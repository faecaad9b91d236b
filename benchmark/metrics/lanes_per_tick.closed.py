"""Lanes a scheduler tick carried in the window (``BatchScheduler.stats()``
after ``reset_stats()`` at the window's start)."""


def read(ctx):
    st = ctx.window.stats
    if not st.get("n_ticks"):
        return None
    return st["n_lanes_served"] / st["n_ticks"]
