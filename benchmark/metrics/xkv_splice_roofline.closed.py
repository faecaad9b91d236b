"""Kernel K2 (``xkv_splice``: the inc tick's cross-KV splice) in the traced
span: its least time (each active lane's K and V tails read and written
once, over 3.35 TB/s) over the device time of the kernels below."""

KERNELS = ("xkv_splice_kernel",)


def read(ctx):
    t = ctx.kernel_seconds(KERNELS)
    if not t or not ctx.trace.get("k2_calls"):
        return None
    return 100.0 * ctx.trace["k2_least_s"] / t
