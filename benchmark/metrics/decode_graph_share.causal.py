"""The share of the window's greedy decode steps of the causal path that
replayed a captured CUDA graph of the step (``causal.graph_replays`` over
``causal.decode_steps``, in %): how often the pooled decode's step graph
engages. From the program's tracer (``stats()["trace"]``); nothing from a
program without the graph counters, or from a window without decode
steps."""


def read(ctx):
    counters = (ctx.window.stats.get("trace") or {}).get("counters", {})
    steps = counters.get("causal.decode_steps", 0)
    if not steps or not ({"causal.graph_replays", "causal.graph_captures"} & counters.keys()):
        return None
    return 100.0 * counters.get("causal.graph_replays", 0) / steps
