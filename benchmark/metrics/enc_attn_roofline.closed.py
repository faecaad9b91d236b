"""Kernel K1 (``flash_encoder_attn``: the encoder's attention and the
decoder's block cross-attention) in the traced span: its least time
(operations 4*B*H*S*T*Dh over 989 TFLOP/s, or bytes over 3.35 TB/s if
larger, for each call) over the device time of the kernels below."""

KERNELS = ("flash_wgmma_kernel", "flash_combine_kernel", "flash_encoder_kernel")


def read(ctx):
    t = ctx.kernel_seconds(KERNELS)
    if not t or not ctx.trace.get("k1_calls"):
        return None
    return 100.0 * ctx.trace["k1_least_s"] / t
