"""Operations and bytes: the chip's peaks, the two kernels' least times and
the model FLOPs a tick needs.

Peaks are NVIDIA's published figures for one H100 SXM at its 700 W limit,
dense: 989 TFLOP/s in bf16, 3.35 TB/s of HBM bandwidth. A kernel's least
time is the larger of its operations over the peak rate and its bytes
(each input read once, each output written once) over the bandwidth.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
W_SPLICE = 256  # cross-KV pool columns an inc tick re-projects and splices


def k1_least_s(B: int, H: int, S: int, T: int, Dh: int, itemsize: int = 2) -> float:
    """Encoder-style attention (kernel K1, ``flash_encoder_attn``): QK^T and
    PV over T valid keys, 4*B*H*S*T*Dh operations; q, k, v read and the
    output written once."""
    ops = 4.0 * B * H * S * T * Dh
    nbytes = (2 * B * H * S * Dh + 2 * B * H * T * Dh) * itemsize
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def k2_least_s(lanes: int, L: int, H: int, Dh: int, tail_itemsize: int = 2, pool_itemsize: int = 2) -> float:
    """Cross-KV splice (kernel K2, ``xkv_splice``): for each active lane, K
    and V tails of [L, H, Dh, 256] read once and written once into the
    pool. A copy: bound by bytes."""
    nbytes = lanes * 2 * L * H * Dh * W_SPLICE * (tail_itemsize + pool_itemsize)
    return nbytes / PEAK_HBM_BYTES


# ---------------------------------------------------------------------------
# Model FLOPs a tick needs, from the published shapes and what the tick did
# ---------------------------------------------------------------------------


def encoder_flops(cfg: dict, frames: int) -> float:
    """Both convolutions and every block over ``frames`` encoder frames,
    attention among the frames themselves."""
    d, m, f = cfg["d_model"], cfg["num_mel_bins"], cfg["encoder_ffn_dim"]
    conv = 2.0 * m * d * 3 * (2 * frames) + 2.0 * d * d * 3 * frames
    block = 2.0 * frames * (4 * d * d + 2 * d * f) + 4.0 * frames * frames * d
    return conv + cfg["encoder_layers"] * block


def cross_kv_flops(cfg: dict, columns: int) -> float:
    d = cfg["d_model"]
    return cfg["decoder_layers"] * 2 * 2.0 * columns * d * d


def decoder_row_flops(cfg: dict, visible: int, logits: bool) -> float:
    """One decoder row at a position that sees ``visible`` self-attention
    rows and the whole 1500-frame window; the unembedding where its logits
    are read."""
    d, f = cfg["d_model"], cfg["decoder_ffn_dim"]
    per_layer = 2.0 * (6 * d * d + 2 * d * f) + 4.0 * d * visible + 4.0 * d * cfg["max_source_positions"]
    out = cfg["decoder_layers"] * per_layer
    if logits:
        out += 2.0 * d * cfg["vocab_size"]
    return out


def lane_tick_flops(cfg: dict, mode: str, tail_frames: int, rows: list, steps: int, plen: int) -> float:
    """A lane's tick: an anchor encodes the whole window and projects all of
    it; an inc tick encodes its tail and re-projects the splice window.
    ``rows`` are the decoder rows the tick decoded before its loop (the
    prefix on an anchor, the refresh rows on an inc tick), given by
    position; two of them are read out (the start-of-transcript row and the
    last). ``steps`` loop decodes follow, each read out."""
    if mode == "anchor":
        enc = encoder_flops(cfg, cfg["max_source_positions"]) + cross_kv_flops(cfg, cfg["max_source_positions"])
    else:
        enc = encoder_flops(cfg, tail_frames) + cross_kv_flops(cfg, W_SPLICE)
    dec = sum(decoder_row_flops(cfg, p + 1, False) for p in rows)
    dec += 2 * 2.0 * cfg["d_model"] * cfg["vocab_size"]
    dec += sum(decoder_row_flops(cfg, plen + k + 1, True) for k in range(steps))
    return enc + dec
