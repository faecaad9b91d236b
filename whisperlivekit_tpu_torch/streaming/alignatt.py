"""AlignAtt / SimulStreaming tick programs in PyTorch (port of
whisperlivekit_tpu/streaming/alignatt.py, base form).

One *tick* decodes B lanes at once: mel -> encoder -> cross-KV -> prefill
(prefix) -> up to ``max_steps`` of (filter -> DRY -> argmax -> attention
gate / rewind / EOT decisions). The JAX module runs the step loop as a
``lax.while_loop`` inside one jitted program; here it is a Python loop that
reads one flag per step from the device (whether any lane is still active)
and skips the decoder pass whose outputs nobody reads (the loop's last).
Only one packed int32 array [B, 2*max_steps+5] leaves the device per tick,
laid out exactly as the JAX one.

The base form (models below d=1280) runs ``alignatt_tick_anchor`` (full
window, refreshes the lane's cached encoder rows) and ``alignatt_tick_inc``
(re-encodes only the window tail over the cached rows). The large form's
pooled programs (cross-KV and self-KV group pools, ``xkv_splice``) are not
ported yet: ``AlignAttEngine`` refuses configurations that need them.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from whisperlivekit_tpu.models.whisper.dims import ModelDimensions, default_alignment_heads
from whisperlivekit_tpu.models.whisper.tokenizer import Tokenizer

from ..audio.mel import log_mel_spectrogram, pad_or_trim
from ..models.whisper import model as wm
from ..ops.median import median_filter

logger = logging.getLogger(__name__)

DEC_PAD = 50257  # tokens >= this are special (reference align_att_base.py:10)

# stop reasons
RUNNING, STOP_EOT, STOP_GATE, STOP_REWIND, STOP_NOSPEECH, STOP_CAP, STOP_CTX = range(7)

# Encoder-row refresh width: inc ticks rewrite the cached encoder rows over
# at least the last XKV_WRITE_BLOCK columns of each lane's window.
XKV_WRITE_BLOCK = 128

#: rows per self-KV refresh decode of the large form's pooled tick; the host
#: session plan reads it (the pooled tick itself is not ported yet)
SKV_REFRESH_ROWS = 8


@dataclass
class AlignAttConfig:
    """Policy knobs (reference simul_whisper/config.py:5-23): the JAX
    package's AlignAttConfig fields and defaults, without the large form's
    pool settings."""

    segment_length: float = 0.5
    frame_threshold: int = 25
    rewind_threshold: int = 200
    audio_max_len: float = 30.0
    audio_min_len: float = 0.0
    nonspeech_prob: float = 0.5
    language: str = "auto"
    task: str = "transcribe"
    decoder_type: str = "greedy"
    beam_size: int = 1
    init_prompt: Optional[str] = None
    static_init_prompt: Optional[str] = None
    max_context_tokens: Optional[int] = None
    never_fire: bool = False
    cif_ckpt_path: Optional[str] = None
    max_steps: int = 8            # per-tick decode budget (step-loop bound)
    enc_tail_frames: int = 0      # inc-tick tail (enc frames); 0 = auto by model class
    enc_rewrite_margin: int = 32  # trailing frames re-encoded every tick
    evict_block_s: float = 0.0    # 0 = audio_max_len/2 when enc caching is on
    xkv_f8: bool = False          # f8 cross-KV storage: not ported yet
    xkv_transposed: bool = True   # [B,H,Dh,T] cross-KV layout
    mel_pallas: bool = False      # fused log-mel kernel (K3): not ported yet
    xkv_cache: object = "auto"    # large-form group cross-KV cache: "auto" = d>=1280


# ---------------------------------------------------------------------------
# DRY repetition penalty
# ---------------------------------------------------------------------------


def dry_penalty(logits: torch.Tensor, tokens: torch.Tensor, cur_len: torch.Tensor, eot: int):
    """Vectorized DRY v0 (reference align_att_base.py:492-537).

    logits [B,V], tokens [B,L], cur_len [B]. Penalizes tokens that would
    extend a verbatim repetition of the current suffix.
    """
    B, L = tokens.shape
    V = logits.shape[-1]
    tokens = tokens.long()
    end = cur_len.long()[:, None] - 1                     # [B,1] suffix end
    idx = torch.arange(L, device=tokens.device)[None, :]  # [1,L]
    last = tokens.gather(1, end)                          # [B,1]

    # candidate positions i: tokens[i] == last, i < cur_len-1, next is text
    next_tok = torch.roll(tokens, -1, dims=1)
    cand = (tokens == last) & (idx < end) & (next_tok < eot)

    # match length: consecutive equality of the suffixes ending at i and at
    # cur_len-1, over up to 49 steps back
    length = torch.ones((B, L), dtype=torch.long, device=tokens.device)
    alive = cand
    for l in range(1, 50):
        j = idx - l        # position behind the candidate
        k = end - l        # position behind the suffix end
        ok = (j >= 0) & (k > idx)
        tj = tokens.gather(1, j.clamp(min=0).expand(B, L))
        tk = tokens.gather(1, k.clamp(min=0))
        alive = alive & ok & (tj == tk) & (tj < eot)
        length = length + alive.long()

    pen_len = torch.where(cand, length, 0)
    # scatter-max per next-token id
    pen_per_tok = torch.zeros((B, V), dtype=torch.long, device=tokens.device).scatter_reduce_(
        1, torch.where(cand, next_tok, 0), pen_len, "amax", include_self=True
    )
    penalty = torch.where(
        pen_per_tok >= 2, torch.pow(2.0, pen_per_tok.float() - 2.0), 0.0
    )
    apply = (end + 1 >= 5) & (last < eot)  # [B,1]
    return logits - torch.where(apply, penalty, 0.0)


# ---------------------------------------------------------------------------
# The tick programs
# ---------------------------------------------------------------------------


def _tick_front(model, audio: torch.Tensor, dims: ModelDimensions, mel_pallas: bool = False):
    """Full-window front-end: int16/f32 audio [B, N_SAMPLES] -> enc [B, T, D].
    int16 PCM converts to float on the device."""
    if mel_pallas:
        raise NotImplementedError("log_mel_pallas (ops/mel_pallas.py) is not ported yet")
    if audio.dtype == torch.int16:
        audio = audio.float() / 32768.0
    mel = log_mel_spectrogram(audio, n_mels=dims.n_mels)
    mel = pad_or_trim(mel, 2 * dims.n_audio_ctx)
    return wm.encode(model, mel, dims)


def _tick_core(
    model,
    enc: torch.Tensor,            # [B, T, D] encoder features
    prefix: torch.Tensor,         # [B, p_max] right-padded with eot
    prefix_len: torch.Tensor,     # [B]
    sot_index: torch.Tensor,      # [B]
    content_frames: torch.Tensor, # [B] encoder frames of real audio
    last_attend: torch.Tensor,    # [B] carry-in attention watermark
    is_last: torch.Tensor,        # [B] bool
    max_new: torch.Tensor,        # [B] loop-detection cap
    suppress_mask: torch.Tensor,  # [V] additive
    align_layers: torch.Tensor,   # [K]
    align_heads: torch.Tensor,    # [K]
    frame_threshold,              # scalar
    rewind_threshold,             # scalar
    nonspeech_prob,               # scalar
    active_in: torch.Tensor,      # [B] bool — lanes with work this tick
    cif_w: torch.Tensor,          # [D] CIF linear weight (zeros when unused)
    cif_b,                        # scalar CIF bias
    dims: ModelDimensions,
    p_max: int,
    max_steps: int,
    eot: int,
    ts_begin: int,
    no_speech_tok: int,
    space_tok: int,
    use_cif: bool = False,
    xkv_f8: bool = False,
    xkv_transposed: bool = True,
):
    """The decode phase of one streaming tick (everything after encoding).
    Returns the packed int32 outputs [B, 2*max_steps + 5]: tokens | frames |
    n_keep | reason | last_attend | fire | no_speech_p (f32 bits)."""
    B = enc.shape[0]
    dev = prefix.device
    align = wm.AlignSpec(layers=align_layers.long(), heads=align_heads.long())
    T = dims.n_audio_ctx
    bidx = torch.arange(B, device=dev)
    frame_idx = torch.arange(T, device=dev)[None, :]
    prefix_len = prefix_len.long()
    content_frames = content_frames.long()
    last_attend = last_attend.to(torch.int32)
    max_new = max_new.long()

    # CIF end-of-word fire detection (reference eow_detection.py:28-77):
    # integrate sigmoid alphas over the content frames; fire when the first
    # un-consumed boundary lies within 2 frames of the chunk end.
    if use_cif:
        content_mask = frame_idx < content_frames[:, None]
        inner = content_mask & (frame_idx < content_frames[:, None] - 1)
        alphas = torch.sigmoid(torch.einsum("btd,d->bt", enc.float(), cif_w.float()) + cif_b)
        alphas = torch.where(inner, alphas, 0.0)
        total = alphas.sum(dim=-1)
        target = torch.round(total)
        alphas = alphas * torch.where(total > 0, target / total.clamp(min=1e-6), 0.0)[:, None]
        integrate = torch.cumsum(alphas, dim=-1)
        exceed = torch.floor(integrate[:, -1:] / 0.999)
        valid = inner & (integrate - exceed >= 0)
        first_pos = torch.argmax(valid.int(), dim=-1)
        fire = valid.any(dim=-1) & (first_pos >= content_frames - 2)
    else:
        fire = torch.ones((B,), dtype=torch.bool, device=dev)

    if xkv_f8:
        raise NotImplementedError("xkv_f8 (f8 cross-KV storage) is not ported yet")
    xkv = wm.cross_kv(model, enc, dims, transposed=xkv_transposed)
    cache = wm.init_cache(dims, B, dtype=model.dtype, width=p_max + max_steps + 1, device=dev)
    # prefill with in-loop alignment reductions: running stats over the real
    # prefix rows + the last row's attention, all [B,K,T]
    rows = torch.arange(p_max, device=dev)[None, :]
    row_mask = (rows < prefix_len[:, None]).float()
    last_onehot = (rows == (prefix_len - 1)[:, None]).float()
    prefill_logits, (asum, asq, last_row), cache = wm.decode(
        model, prefix, torch.zeros((B,), dtype=torch.long, device=dev), xkv, cache, dims,
        align=align, align_reduce=(row_mask, last_onehot),
        xkv_transposed=xkv_transposed,
    )
    acount = prefix_len.float()
    no_speech_p = torch.softmax(prefill_logits[bidx, sot_index.long()], dim=-1)[:, no_speech_tok]
    logits = prefill_logits[bidx, prefix_len - 1]

    tokens = torch.full((B, dims.n_text_ctx), eot, dtype=torch.long, device=dev)
    tokens[:, :p_max] = prefix.long()

    active = active_in.clone()
    n_keep = torch.zeros((B,), dtype=torch.int32, device=dev)
    reason = torch.where(active_in, RUNNING, STOP_CAP).to(torch.int32)
    new_tokens = torch.full((B, max_steps), eot, dtype=torch.int32, device=dev)
    frames = torch.zeros((B, max_steps), dtype=torch.int32, device=dev)
    vocab_idx = torch.arange(logits.shape[-1], device=dev)[None, :]
    blank = (vocab_idx == space_tok) | (vocab_idx == eot)
    thr = torch.where(is_last, 4, int(frame_threshold))
    K = align.count

    running = bool(active_in.any())  # one host read per step (the loop bound)
    k = 0
    while running and k < max_steps:
        cur_len = prefix_len + k  # [B]

        # ---- logit filters ----
        lg = logits + suppress_mask[None, :]
        if k == 0:
            lg = lg.masked_fill(blank, float("-inf"))
        lg = dry_penalty(lg, tokens, cur_len, eot)
        tok = torch.argmax(lg, dim=-1)
        completed = tok == eot

        # ---- attention of the last fed token (gate input) ----
        denom = acount.clamp(min=1.0)[:, None, None]
        mean = asum / denom
        var = asq / denom - mean * mean
        std = torch.sqrt(var.clamp(min=0.0))
        z = (last_row - mean) / (std + 1e-8)
        gatt = median_filter(z, 7).mean(dim=1)  # [B,T]
        gatt = torch.where(frame_idx < content_frames[:, None], gatt, float("-inf"))
        frame = torch.argmax(gatt, dim=-1)      # [B]
        frames[:, k] = torch.where(active, frame, 0).to(torch.int32)

        # ---- stop decisions ----
        nospeech_stop = (no_speech_p > nonspeech_prob) if k == 0 else torch.zeros_like(active)
        prev_tok = tokens.gather(1, (cur_len - 1)[:, None])[:, 0]
        special_exempt = prev_tok >= DEC_PAD
        rewind_cond = (~is_last) & (last_attend.long() - frame > rewind_threshold)
        do_rewind = rewind_cond & ~special_exempt
        new_last_attend = torch.where(
            rewind_cond & special_exempt,
            frame,
            torch.where(do_rewind, -int(rewind_threshold), frame),
        )
        gate = (content_frames - frame) <= thr
        ctx_full = cur_len + 1 >= dims.n_text_ctx
        cap = (k + 1) > max_new

        stop_keep_k = completed | gate        # drop the new token, keep others
        stop_keep_0 = do_rewind | nospeech_stop | cap
        stop_keep_k1 = ctx_full & ~stop_keep_k & ~stop_keep_0
        stopped_now = (stop_keep_k | stop_keep_0 | stop_keep_k1) & active

        reason = torch.where(stopped_now & completed, STOP_EOT, reason)
        reason = torch.where(stopped_now & gate & ~completed, STOP_GATE, reason)
        reason = torch.where(stopped_now & do_rewind, STOP_REWIND, reason)
        reason = torch.where(stopped_now & nospeech_stop, STOP_NOSPEECH, reason)
        reason = torch.where(stopped_now & cap, STOP_CAP, reason)
        reason = torch.where(stopped_now & stop_keep_k1, STOP_CTX, reason)

        n_keep = torch.where(
            active,
            torch.where(stop_keep_0, 0, torch.where(stop_keep_k, k, k + 1)),
            n_keep,
        ).to(torch.int32)

        pos_w = cur_len.clamp(max=dims.n_text_ctx - 1)
        tokens[bidx, pos_w] = torch.where(active, tok, tokens[bidx, pos_w])
        new_tokens[:, k] = torch.where(active, tok, eot).to(torch.int32)

        last_attend = torch.where(active, new_last_attend, last_attend.long()).to(torch.int32)
        active = active & ~stopped_now

        # ---- decode the sampled token (attention row + next logits) ----
        # the loop ends when every lane stopped or k+1 == max_steps; that
        # step's decoder pass would produce outputs no one reads — skip it
        running = k + 1 < max_steps and bool(active.any())
        if running:
            new_logits, step_aprobs, cache = wm.decode(
                model, tok[:, None], pos_w, xkv, cache, dims, align=align,
                xkv_transposed=xkv_transposed,
            )
            step_row = step_aprobs.transpose(0, 1)[:, :, 0, :]  # [B,K,T]
            logits = new_logits[:, 0]
        else:
            step_row = torch.zeros((B, K, last_row.shape[-1]), device=dev)
        upd = active.float()[:, None, None]
        asum = asum + step_row * upd
        asq = asq + step_row * step_row * upd
        acount = acount + active.float()
        last_row = torch.where(active[:, None, None], step_row, last_row)
        k += 1

    # lanes still active at loop exhaustion keep everything they decoded
    reason = torch.where(active, STOP_CAP, reason).to(torch.int32)
    n_keep = torch.where(active, max_steps, n_keep).to(torch.int32)
    return torch.cat(
        [
            new_tokens,
            frames,
            n_keep[:, None],
            reason[:, None],
            last_attend[:, None],
            fire.to(torch.int32)[:, None],
            no_speech_p.float().contiguous().view(torch.int32)[:, None],
        ],
        dim=1,
    )


def alignatt_tick(
    model, audio,
    prefix, prefix_len, sot_index, content_frames, last_attend, is_last,
    max_new, suppress_mask, align_layers, align_heads, frame_threshold,
    rewind_threshold, nonspeech_prob, active_in, cif_w, cif_b,
    dims, p_max, max_steps, eot, ts_begin, no_speech_tok, space_tok,
    use_cif=False, xkv_f8=False, xkv_transposed=True, mel_pallas=False,
):
    """One streaming tick for B lanes from raw audio [B, N_SAMPLES]; returns
    the packed outputs."""
    enc = _tick_front(model, audio, dims, mel_pallas)
    return _tick_core(
        model, enc, prefix, prefix_len, sot_index, content_frames,
        last_attend, is_last, max_new, suppress_mask, align_layers,
        align_heads, frame_threshold, rewind_threshold, nonspeech_prob,
        active_in, cif_w, cif_b, dims, p_max, max_steps, eot, ts_begin,
        no_speech_tok, space_tok, use_cif, xkv_f8, xkv_transposed,
    )


def alignatt_tick_anchor(
    model, audio, enc_pool, enc_lanes,
    prefix, prefix_len, sot_index, content_frames, last_attend, is_last,
    max_new, suppress_mask, align_layers, align_heads, frame_threshold,
    rewind_threshold, nonspeech_prob, active_in, cif_w, cif_b,
    dims, p_max, max_steps, eot, ts_begin, no_speech_tok, space_tok,
    use_cif=False, xkv_f8=False, xkv_transposed=True, mel_pallas=False,
):
    """Full-window tick that also re-anchors the per-lane encoder cache: the
    fresh enc rows are written IN PLACE into ``enc_pool`` at ``enc_lanes``.

    Returns (packed outputs, enc_pool)."""
    enc = _tick_front(model, audio, dims, mel_pallas)
    enc_pool[enc_lanes.long()] = enc.to(enc_pool.dtype)
    outs = _tick_core(
        model, enc, prefix, prefix_len, sot_index, content_frames,
        last_attend, is_last, max_new, suppress_mask, align_layers,
        align_heads, frame_threshold, rewind_threshold, nonspeech_prob,
        active_in, cif_w, cif_b, dims, p_max, max_steps, eot, ts_begin,
        no_speech_tok, space_tok, use_cif, xkv_f8, xkv_transposed,
    )
    return (outs, enc_pool)


def _slice_audio_tails(rows: torch.Tensor, tail_start: torch.Tensor, tail_frames: int):
    """Per-lane audio tail slice as a 128-sample ROW gather.

    rows: [B, N] int16 (N % 128 == 0); tail_start [B] must be EVEN (then the
    sample offset tail_start*320 lies on a 128-sample boundary). Returns
    [B, (tail_frames+1)*320] float32 in [-1, 1)."""
    B, N = rows.shape
    S_tail = (tail_frames + 1) * 320
    n_rows = -(-S_tail // 128)
    r3 = rows.reshape(B, N // 128, 128)
    start = tail_start.long()
    r0 = (start * 320) // 128
    idx = r0[:, None] + torch.arange(n_rows, device=rows.device)[None, :]
    take = r3.gather(1, idx.clamp(max=N // 128 - 1)[:, :, None].expand(B, n_rows, 128))
    flat = take.reshape(B, n_rows * 128)[:, :S_tail]
    samp_idx = start[:, None] * 320 + torch.arange(S_tail, device=rows.device)[None, :]
    flat = torch.where(samp_idx < N, flat, 0)
    return flat.float() / 32768.0


def alignatt_tick_inc(
    model,
    audio_pool,            # [W, N_SAMPLES] int16 device-resident windows
    enc_pool,              # [W_enc, T, D] cached encoder frames (updated in place)
    audio_lanes,           # [B] rows in audio_pool
    enc_lanes,             # [B] rows in enc_pool
    tail_start,            # [B] first encoder frame of the re-encoded tail
    win_frames,            # [B] current window length in encoder frames
    write_start,           # [B] first frame (re)written into the cache
    prefix, prefix_len, sot_index, content_frames, last_attend, is_last,
    max_new, suppress_mask, align_layers, align_heads, frame_threshold,
    rewind_threshold, nonspeech_prob, active_in, cif_w, cif_b,
    dims, p_max, max_steps, eot, ts_begin, no_speech_tok, space_tok,
    use_cif=False,
    xkv_f8=False,
    xkv_transposed=True,
    mel_pallas=False,  # accepted for signature symmetry; tails use the plain mel
    tail_frames: int = 384,
):
    """Incremental tick: re-encode only the window tail and extend the cache.

    The audio tail is sliced on the device from the audio pool, encoded
    with absolute positional offsets, and frames [write_start, win_frames)
    (widened to the last XKV_WRITE_BLOCK frames) replace the cached rows,
    written back into ``enc_pool`` in place; the decode then runs over the
    full cached window.

    Returns (packed outputs, enc_pool)."""
    B = audio_lanes.shape[0]
    T = dims.n_audio_ctx
    D = dims.n_audio_state
    audio_lanes = audio_lanes.long()
    enc_lanes = enc_lanes.long()
    win_frames = win_frames.long()
    write_start = write_start.long()

    # round tail_start UP to even so the slice is an aligned row gather; the
    # session plan reserves the 1-frame slack (win - write_start <= tail - 2)
    tail_start = tail_start.long()
    tail_start = tail_start + (tail_start & 1)
    rows = audio_pool[audio_lanes]  # [B, N_SAMPLES] int16
    tail = _slice_audio_tails(rows, tail_start, tail_frames)

    mel = log_mel_spectrogram(tail, n_mels=dims.n_mels)
    mel = pad_or_trim(mel, 2 * tail_frames)
    enc_tail = wm.encode(model, mel, dims, pos_start=tail_start)  # [B, F_tail, D]

    # merge into cached rows: t in [ws_eff, win) <- tail[t - tail_start]
    Wb = XKV_WRITE_BLOCK
    ws_eff = torch.where(
        win_frames >= Wb, torch.minimum(write_start, win_frames - Wb), write_start
    )
    ws_eff = torch.maximum(ws_eff, tail_start)  # tail coverage bound
    cached = enc_pool[enc_lanes]  # [B, T, D]
    t_idx = torch.arange(T, device=cached.device)[None, :]
    src = (t_idx - tail_start[:, None]).clamp(0, tail_frames - 1)
    fresh = enc_tail.to(enc_pool.dtype).gather(1, src[:, :, None].expand(B, T, D))
    in_write = (t_idx >= ws_eff[:, None]) & (t_idx < win_frames[:, None])
    enc_rows = torch.where(in_write[:, :, None], fresh, cached)
    enc_pool[enc_lanes] = enc_rows

    outs = _tick_core(
        model, enc_rows.to(enc_tail.dtype), prefix, prefix_len, sot_index,
        content_frames, last_attend, is_last, max_new, suppress_mask,
        align_layers, align_heads, frame_threshold, rewind_threshold,
        nonspeech_prob, active_in, cif_w, cif_b, dims, p_max, max_steps, eot,
        ts_begin, no_speech_tok, space_tok, use_cif, xkv_f8, xkv_transposed,
    )
    return (outs, enc_pool)


# time, by encode-mode partition (exported via BatchScheduler.stats)
TICK_PHASE_STATS: dict = {}

# why lanes fell off the cheap "inc" path (exported next to TICK_PHASE_STATS)
ANCHOR_REASONS: dict = {}


def _count_anchor(reason: str) -> None:
    ANCHOR_REASONS[reason] = ANCHOR_REASONS.get(reason, 0) + 1


# ---------------------------------------------------------------------------
# Shared engine (host)
# ---------------------------------------------------------------------------


class AlignAttEngine:
    """Shared engine: the model, its device and the static policy config;
    sessions share it. Configurations that need a module not yet ported
    raise NotImplementedError here, naming it."""

    PREFIX_BUCKETS = (32, 64, 96, 128, 256, 384)

    def __init__(
        self,
        model: wm.Whisper,
        dims: ModelDimensions,
        tokenizer: Tokenizer,
        cfg: AlignAttConfig,
        model_name: Optional[str] = None,
        align_pairs=None,
    ):
        if cfg.language == "auto":
            raise NotImplementedError(
                "language auto-detect needs decoding/task.py, not ported yet; pass a language"
            )
        if cfg.mel_pallas:
            raise NotImplementedError("mel_pallas needs ops/mel_pallas.py (K3), not ported yet")
        if cfg.xkv_f8:
            raise NotImplementedError("xkv_f8 (f8 cross-KV storage) is not ported yet")
        if cfg.decoder_type == "beam" and cfg.beam_size > 1:
            raise NotImplementedError("beam decoding needs streaming/alignatt_beam.py, not ported yet")
        if cfg.xkv_cache == "auto":
            cfg.xkv_cache = bool(dims.n_audio_state >= 1280)
        if cfg.xkv_cache:
            raise NotImplementedError(
                "the large form (XKVGroupPool, ops/xkv_merge.py xkv_splice) is not "
                "ported yet; set xkv_cache off"
            )
        self.model = model
        self.device = model.device
        self.dims = dims
        self.tokenizer = tokenizer
        self.cfg = cfg
        pairs = align_pairs or default_alignment_heads(dims, model_name)
        arr = np.asarray(pairs, np.int64).reshape(-1, 2)
        self.align_layers = torch.as_tensor(arr[:, 0], device=self.device)
        self.align_heads = torch.as_tensor(arr[:, 1], device=self.device)
        self.suppress_mask = torch.as_tensor(
            self._build_suppress_mask(tokenizer, dims), device=self.device
        )
        self.use_cif, self.cif_w, self.cif_b = self._load_cif(cfg, dims, self.device)
        if not cfg.enc_tail_frames:
            if dims.n_audio_state >= 1280 and dims.n_text_layer >= 16:
                cfg.enc_tail_frames = 160   # large-v3 class
            elif dims.n_audio_state >= 1280:
                cfg.enc_tail_frames = 256   # turbo class
            else:
                cfg.enc_tail_frames = 384
        top = 256 if (dims.n_audio_state >= 1280 and dims.n_text_layer >= 16) else dims.n_text_ctx
        self.prefix_buckets = tuple(
            b for b in self.PREFIX_BUCKETS if b < min(dims.n_text_ctx, top + 1)
        ) or (dims.n_text_ctx // 2,)
        # the serving prefix cap and commit budget bound the large form's
        # self-KV pool; the session plan reads them, and they stay off here
        self.serving_prefix_cap = 0
        self.serving_commit_budget = 0

    @staticmethod
    def _load_cif(cfg: AlignAttConfig, dims: ModelDimensions, device):
        """CIF end-of-word linear head (reference eow_detection.py:10-34):
        without a checkpoint, always fire."""
        if not cfg.cif_ckpt_path:
            return False, torch.zeros((dims.n_audio_state,), device=device), 0.0
        ckpt = torch.load(cfg.cif_ckpt_path, map_location="cpu")
        w = ckpt["weight"].float().reshape(-1).to(device)
        b = float(ckpt["bias"].float().reshape(())) if "bias" in ckpt else 0.0
        return True, w, b

    @staticmethod
    def _build_suppress_mask(tokenizer: Tokenizer, dims: ModelDimensions) -> np.ndarray:
        """Streaming suppression set (reference simul_whisper.py:161-172):
        task/sot/lang/no_speech/no_timestamps tokens + all timestamps."""
        mask = np.zeros(dims.n_vocab, np.float32)
        ids = [
            tokenizer.transcribe,
            tokenizer.translate,
            tokenizer.sot,
            tokenizer.sot_prev,
            tokenizer.sot_lm,
            tokenizer.no_timestamps,
        ]
        ids += list(tokenizer.all_language_tokens)
        if tokenizer.no_speech is not None:
            ids.append(tokenizer.no_speech)
        mask[sorted(set(i for i in ids if i < dims.n_vocab))] = -np.inf
        mask[tokenizer.timestamp_begin :] = -np.inf
        return mask

    def bucket_for(self, n: int) -> int:
        for b in self.prefix_buckets:
            if n <= b:
                return b
        return self.prefix_buckets[-1]


# ---------------------------------------------------------------------------
# Facade re-exports: the pool containers, the host session planner and the
# dispatch layer live in sibling modules; this module stays the import
# surface. session_plan and dispatch import THIS module at load time, so
# they are served lazily (PEP 562) to avoid an import cycle.
# ---------------------------------------------------------------------------

from .pools import AudioPool, EncPool, _pool_gather, _pool_update  # noqa: E402,F401

_LAZY_EXPORTS = {
    "TokenBufferCtx": "session_plan",
    "TickInputs": "session_plan",
    "TickOutputs": "session_plan",
    "AlignAttSession": "session_plan",
    "_collect_lane_arrays": "dispatch",
    "_core_device_args": "dispatch",
    "_gather_full_audio": "dispatch",
    "_scatter_outputs": "dispatch",
    "run_tick_batch": "dispatch",
    "dispatch_tick_batch": "dispatch",
    "finalize_tick_batch": "dispatch",
    "_dispatch_group_legacy": "dispatch",
    "_dispatch_group_anchor": "dispatch",
    "_dispatch_group_inc": "dispatch",
}


def __getattr__(name: str):
    mod = _LAZY_EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __package__), name)
