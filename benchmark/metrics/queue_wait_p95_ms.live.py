"""95th percentile of every lane's wait in the window, from its submission
to the start of the group tick that took it: the scheduler's
``sched.queue_wait`` histogram (1 ms bins, every lane since
``reset_stats()`` at the window's start; nearest rank, the bin's lower
edge), where ``queue_wait_p50_ms.live`` reads a reservoir of the window's
last 512 waits. Nothing from a program without the histogram."""


def read(ctx):
    hists = (ctx.window.stats.get("trace") or {}).get("hists", {})
    return hists.get("sched.queue_wait", {}).get("p95_ms")
