"""Share of the traced span in which no kernel, copy or set ran on the card
(``torch.profiler``, CUDA activity)."""


def read(ctx):
    if not ctx.trace or not ctx.trace.get("window_s") or not ctx.trace.get("busy_s"):
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
