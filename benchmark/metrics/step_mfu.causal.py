"""The model FLOPs of the window's causal ops over the window's seconds and
the card's bf16 peak (989 TFLOP/s): the tower frames, prefill and decode
rows, the shared experts for every row, the routed experts for each pair
the router chose and the head for every logits row, from the published
shapes and the program's counters (``lib/moe_flops.py``; the tracer,
``stats()["trace"]``, zeroed at the window's start). Nothing from a
program without the counters."""

from lib import moe_flops
from lib.flops import PEAK_BF16_FLOPS


def read(ctx):
    counters = (ctx.window.stats.get("trace") or {}).get("counters", {})
    total = moe_flops.window_flops(ctx.cfg, counters)
    return 100.0 * total / ctx.window_s / PEAK_BF16_FLOPS if total else None
