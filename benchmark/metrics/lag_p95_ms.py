"""95th percentile of the lag that ``lag_p50_ms`` defines, over every tick
completed in the window."""

from lib.context import percentile


def read(ctx):
    lags = [(r.t_done - r.due) * 1e3 for r in ctx.done_in_window() if r.due is not None]
    return percentile(lags, 95)
