"""Median wait of a tick between its submission and the start of the
scheduler tick that took it (``BatchScheduler.stats()``, whose reservoir
holds the window's last 512 waits)."""


def read(ctx):
    return ctx.window.stats.get("queue_wait_p50_ms")
