"""The expert weight bytes the window's expert-layer calls had to read,
over the window's seconds times the card's 3.35 TB/s: one routed expert's
three matrices for each routed expert that took at least one row in a call
(``moe.hit``), and the shared experts' for every call (``moe.calls``), in
the serving dtype (``lib/moe_flops.py``). A call reads each such weight at
least once, so the share cannot pass 100 %. From the program's tracer
(``stats()["trace"]``); nothing from a program without the counters."""

import torch

from lib import moe_flops
from lib.flops import PEAK_HBM_BYTES


def read(ctx):
    counters = (ctx.window.stats.get("trace") or {}).get("counters", {})
    calls = counters.get("moe.calls", 0)
    if not calls:
        return None
    itemsize = getattr(torch, ctx.cfg["serving"]["dtype"]).itemsize
    routed, shared = moe_flops.expert_bytes(ctx.cfg, itemsize)
    nbytes = counters.get("moe.hit", 0) * routed + calls * shared
    return 100.0 * nbytes / ctx.window_s / PEAK_HBM_BYTES
