"""The model FLOPs the window's ticks needed, over the window's seconds and
the card's bf16 peak (989 TFLOP/s): counted from the published shapes and
from what each lane's tick did (anchor or inc, the tail, the decoder rows
before the loop, the loop decodes its packed output shows), never from
which kernels ran (``lib/flops.py``)."""

from lib import flops


def read(ctx):
    done = ctx.done_in_window()
    if not done:
        return None
    total = sum(
        flops.lane_tick_flops(ctx.cfg, r.mode, ctx.tail_frames, r.dec_rows,
                              r.loop_decodes(ctx.max_steps, ctx.eot), len(r.prefix))
        for r in done
    )
    return 100.0 * total / ctx.window_s / flops.PEAK_BF16_FLOPS
