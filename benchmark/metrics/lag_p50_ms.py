"""Median over every tick completed in the window of: the time its result
reached the session, less the time the last sample it consumed was due on
the feed's schedule."""

from lib.context import percentile


def read(ctx):
    lags = [(r.t_done - r.due) * 1e3 for r in ctx.done_in_window() if r.due is not None]
    return percentile(lags, 50)
