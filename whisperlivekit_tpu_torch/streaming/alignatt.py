"""AlignAtt / SimulStreaming tick programs in PyTorch (port of
whisperlivekit_tpu/streaming/alignatt.py).

One *tick* decodes B lanes at once: mel -> encoder -> cross-KV -> prefill
(prefix) -> up to ``max_steps`` of (filter -> DRY (``ops/dry.py``, kernel
K4) -> argmax -> attention gate / rewind / EOT decisions). The JAX module
runs the step loop as a ``lax.while_loop`` inside one jitted program; here
it is a Python loop that reads one number per step from the device (how
many lanes are still active, which the tracer's ``core.*`` counters add up)
and skips the decoder pass whose outputs nobody reads (the loop's last).
Only one packed int32 array [B, 2*max_steps+5] leaves the device per tick,
laid out exactly as the JAX one.

The base form (models below d=1280) runs ``alignatt_tick_anchor`` (full
window, refreshes the lane's cached encoder rows) and ``alignatt_tick_inc``
(re-encodes only the window tail over the cached rows). The large form
keeps cross-KV and self-KV pools resident per lane group (XKVGroupPool):
``alignatt_tick_anchor_group`` / ``alignatt_tick_anchor_pooled`` (re)seed
them, and the steady ``alignatt_tick_inc_skv`` splices the re-projected
tail into the cross-KV pool (``ops/xkv_merge.xkv_splice``, kernel K2) and
replaces the prefill by a few refresh rows against the self-KV pool. Where
the JAX programs donate the pools and return new ones, these update the
group's tensors IN PLACE and return them.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..models.whisper.dims import ModelDimensions, default_alignment_heads
from ..models.whisper.tokenizer import Tokenizer
from ..audio.mel import log_mel_spectrogram, pad_or_trim
from ..models.whisper import model as wm
from ..ops.dry import dry_penalty
from ..ops.f8 import F8, write_cast
from ..ops.median import median_filter
from ..ops.mel_pallas import log_mel_pallas
from ..engine.trace import ANCHOR_REASONS, TICK_PHASE_STATS, TRACER  # noqa: F401 (facade)

logger = logging.getLogger(__name__)

DEC_PAD = 50257  # tokens >= this are special (reference align_att_base.py:10)

# stop reasons
RUNNING, STOP_EOT, STOP_GATE, STOP_REWIND, STOP_NOSPEECH, STOP_CAP, STOP_CTX = range(7)

# Encoder-row refresh width: inc ticks rewrite the cached encoder rows over
# at least the last XKV_WRITE_BLOCK columns of each lane's window.
XKV_WRITE_BLOCK = 128

#: rows per self-KV refresh decode (alignatt_tick_inc_skv): slot 0 re-decodes
#: the sot row (fresh no_speech_p), slot R-1 the last prefix row (fresh
#: first-token logits + gate attention); the middle slots absorb this tick's
#: prefix delta. A multiple of 8, so the refresh decode takes the flash
#: prefill path; longer deltas take the full-width refresh plan or an anchor.
SKV_REFRESH_ROWS = 8


@dataclass
class AlignAttConfig:
    """Policy knobs (reference simul_whisper/config.py:5-23): the JAX
    package's AlignAttConfig fields and defaults."""

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
    xkv_f8: bool = False          # legacy tick: store the dense cross-KV in f8_e4m3
    xkv_transposed: bool = True   # [B,H,Dh,T] cross-KV layout
    mel_pallas: bool = False      # fused log-mel kernel (K3) on full-window ticks
    xkv_cache: object = "auto"    # large-form group cross-KV cache: "auto" = d>=1280
    xkv_cache_dtype: str = "bf16"  # group pools: "bf16" = the params dtype; "f8" = f8_e4m3
    xkv_budget_bytes: int = 9 << 30  # device-memory cap for all groups' pools
    anchor_cohorts: int = 1       # stagger group re-anchors over this many sub-epochs
    serving_prefix_cap: int = 0   # pooled-serving decode-prefix cap; 0 = auto (96 with xkv)
    serving_commit_budget: int = 16  # self-KV pool rows past the cap for mid-epoch commits


# ---------------------------------------------------------------------------
# The tick programs
# ---------------------------------------------------------------------------


def _tick_front(model, audio: torch.Tensor, dims: ModelDimensions, mel_pallas: bool = False):
    """Full-window front-end: int16/f32 audio [B, N_SAMPLES] -> enc [B, T, D].
    int16 PCM converts to float on the device. ``mel_pallas`` takes the fused
    log-mel (kernel K3) instead of the plain mel."""
    if audio.dtype == torch.int16:
        audio = audio.float() / 32768.0
    if mel_pallas:
        mel = log_mel_pallas(audio, n_mels=dims.n_mels)
    else:
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
    xkv_pre: Optional[wm.CrossKV] = None,
    xkv_t_valid: Optional[int] = None,
    skv: Optional[dict] = None,
    cache_width: Optional[int] = None,
    return_state: bool = False,
):
    """The decode phase of one streaming tick (everything after encoding).
    Returns the packed int32 outputs [B, 2*max_steps + 5]: tokens | frames |
    n_keep | reason | last_attend | fire | no_speech_p (f32 bits).

    ``xkv_pre`` supplies precomputed cross-attention K/V (a group pool, or a
    dense projection); the full-window projection is then skipped and
    ``enc`` may be None (CIF excepted). ``xkv_t_valid`` masks the pool's
    padding columns.

    ``skv`` supplies the group's persistent decoder state: ``cache``
    (KVCache [L,G,Wc,H,Dh], written in place), ``asum``/``asq``/``alast``
    ([G,K,T] f32), ``acount`` ([G] f32), ``tok`` ([G,n_text_ctx] int32),
    ``refresh_tokens``/``refresh_pos`` ([G,R]). The full-prefix prefill is
    then replaced by an R-row refresh decode: slot 0 (the sot row) gives
    no_speech_p, slot R-1 (the last prefix row) the first logits and the
    gate input; older rows ride on the cached K/V. Lanes that are not
    active park their loop writes on the scratch row Wc-1.

    ``return_state=True`` also returns (cache, (asum, asq, acount, alast),
    tokens [B,n_text_ctx] int32), so the pooled programs can (re)seed the
    pools."""
    B = enc.shape[0] if enc is not None else xkv_pre.k.shape[1]
    dev = prefix_len.device
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

    # xkv_f8 stores the projection in f8_e4m3 (rounded from f32, as JAX
    # does); the decode widens it per layer
    if xkv_pre is not None:
        xkv = xkv_pre
    else:
        xkv = wm.cross_kv(
            model, enc, dims, out_dtype=F8 if xkv_f8 else None, transposed=xkv_transposed,
        )
    zeros_b = torch.zeros((B,), dtype=torch.long, device=dev)
    if skv is not None:
        # ---- self-KV pool: R-row refresh instead of prefill ----
        cache = skv["cache"]
        r_tok, r_pos = skv["refresh_tokens"].long(), skv["refresh_pos"].long()
        R = r_tok.shape[1]
        w_zero = torch.zeros((B, R), device=dev)
        w_last = (torch.arange(R, device=dev)[None, :] == R - 1).float() * active_in.float()[:, None]
        refresh_logits, (_, _, fresh_last), cache = wm.decode(
            model, r_tok, zeros_b, xkv, cache, dims,
            align=align, align_reduce=(w_zero, w_last),
            xkv_transposed=xkv_transposed, t_valid=xkv_t_valid,
            positions_override=r_pos,
        )
        asum, asq, acount = skv["asum"], skv["asq"], skv["acount"]
        last_row = torch.where(active_in[:, None, None], fresh_last, skv["alast"])
        no_speech_p = torch.softmax(refresh_logits[:, 0], dim=-1)[:, no_speech_tok]
        logits = refresh_logits[:, R - 1]
        # heal the token mirror: scatter the refresh rows' tokens. Padding
        # rows share the scratch position and all write eot (inactive
        # lanes write back what is there), so duplicates agree.
        tokens = skv["tok"].long()
        r_idx = r_pos.clamp(max=dims.n_text_ctx - 1)
        tokens[bidx[:, None], r_idx] = torch.where(active_in[:, None], r_tok, tokens.gather(1, r_idx))
    else:
        cache = wm.init_cache(
            dims, B, dtype=model.dtype, width=cache_width or (p_max + max_steps + 1), device=dev
        )
        # prefill with in-loop alignment reductions: running stats over the
        # real prefix rows + the last row's attention, all [B,K,T]
        rows = torch.arange(p_max, device=dev)[None, :]
        row_mask = (rows < prefix_len[:, None]).float()
        last_onehot = (rows == (prefix_len - 1)[:, None]).float()
        prefill_logits, (asum, asq, last_row), cache = wm.decode(
            model, prefix, zeros_b, xkv, cache, dims,
            align=align, align_reduce=(row_mask, last_onehot),
            xkv_transposed=xkv_transposed, t_valid=xkv_t_valid,
        )
        acount = prefix_len.float()
        no_speech_p = torch.softmax(prefill_logits[bidx, sot_index.long()], dim=-1)[:, no_speech_tok]
        logits = prefill_logits[bidx, prefix_len - 1]

        tokens = torch.full((B, dims.n_text_ctx), eot, dtype=torch.long, device=dev)
        tokens[:, :p_max] = prefix.long()
    # lanes without work this tick park their loop writes on the pool's
    # scratch row instead of their pooled rows
    scratch = cache.k.shape[2] - 1 if skv is not None else None

    active = active_in.clone()
    n_keep = torch.zeros((B,), dtype=torch.int32, device=dev)
    reason = torch.where(active_in, RUNNING, STOP_CAP).to(torch.int32)
    new_tokens = torch.full((B, max_steps), eot, dtype=torch.int32, device=dev)
    frames = torch.zeros((B, max_steps), dtype=torch.int32, device=dev)
    vocab_idx = torch.arange(logits.shape[-1], device=dev)[None, :]
    blank = (vocab_idx == space_tok) | (vocab_idx == eot)
    thr = torch.where(is_last, 4, int(frame_threshold))
    K = align.count

    # one host read per step (the loop bound): the lanes still active,
    # counted (step.sync spans; core.* counters)
    t_core = time.perf_counter_ns()
    n_live = int(active_in.sum())
    t = time.perf_counter_ns()
    TRACER.record("step.sync", t_core, t)
    live = 0
    k = 0
    while n_live and k < max_steps:
        live += n_live
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
        # a lane with an empty prefix (an absent pool slot) wraps to the
        # last column, as JAX's negative indices do
        prev_tok = tokens.gather(1, ((cur_len - 1) % dims.n_text_ctx)[:, None])[:, 0]
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
        t_s = time.perf_counter_ns()
        TRACER.record("step.launch", t, t_s)
        n_live = int(active.sum()) if k + 1 < max_steps else 0
        t = time.perf_counter_ns()
        if k + 1 < max_steps:
            TRACER.record("step.sync", t_s, t)
        if n_live:
            pos_d = pos_w if scratch is None else torch.where(active_in, pos_w, scratch)
            new_logits, step_aprobs, cache = wm.decode(
                model, tok[:, None], pos_d, xkv, cache, dims, align=align,
                xkv_transposed=xkv_transposed, t_valid=xkv_t_valid,
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
        t_s = time.perf_counter_ns()
        TRACER.record("step.launch", t, t_s)
        t = t_s

    TRACER.record("core", t_core, t, lanes=B, steps=k, rows=B * k, live=live)
    TRACER.count("core.steps", k)
    TRACER.count("core.rows", B * k)
    TRACER.count("core.live", live)
    # lanes still active at loop exhaustion keep everything they decoded
    reason = torch.where(active, STOP_CAP, reason).to(torch.int32)
    n_keep = torch.where(active, max_steps, n_keep).to(torch.int32)
    packed = torch.cat(
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
    if return_state:
        return packed, (cache, (asum, asq, acount, last_row), tokens.to(torch.int32))
    return packed


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
    enc_rows, compute_dtype = _encode_tail_into_rows(
        model, audio_pool, enc_pool, audio_lanes, enc_lanes, tail_start, win_frames,
        write_start, dims, tail_frames,
    )
    outs = _tick_core(
        model, enc_rows.to(compute_dtype), prefix, prefix_len, sot_index,
        content_frames, last_attend, is_last, max_new, suppress_mask,
        align_layers, align_heads, frame_threshold, rewind_threshold,
        nonspeech_prob, active_in, cif_w, cif_b, dims, p_max, max_steps, eot,
        ts_begin, no_speech_tok, space_tok, use_cif, xkv_f8, xkv_transposed,
    )
    return (outs, enc_pool)


def _encode_tail_into_rows(
    model, audio_pool, enc_pool, audio_lanes, enc_lanes, tail_start, win_frames,
    write_start, dims, tail_frames,
):
    """The incremental ticks' encode: slice each lane's audio tail on the
    device, encode it at absolute positions, and write frames
    [write_start, win_frames) (widened to the last XKV_WRITE_BLOCK frames)
    over the lane's cached rows in ``enc_pool``, in place. Returns the
    updated rows [B, T, D] (pool dtype) and the encoder's dtype."""
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
    return enc_rows, enc_tail.dtype


def _splice_window_into_pool(model, enc_rows, xkv_k, xkv_v, win_frames, dims, compute_dtype):
    """Project the aligned splice window [dst0, dst0 + W_SPLICE) of the
    UPDATED encoder rows and splice it into the cross-KV pools in place
    (kernel K2). Columns of the window that were already synced are
    re-projections of their own cached rows, so the pool equals a full
    re-projection of the rows."""
    from ..ops.xkv_merge import W_SPLICE, splice_dst0, xkv_splice

    G, T, D = enc_rows.shape
    dst0 = splice_dst0(win_frames.long(), xkv_k.shape[-1])  # [G], 128-aligned
    w_idx = dst0[:, None] + torch.arange(W_SPLICE, device=enc_rows.device)[None, :]
    window_rows = enc_rows.gather(
        1, w_idx.clamp(max=T - 1)[:, :, None].expand(G, W_SPLICE, D)
    ).to(compute_dtype)  # [G, 256, D]
    fresh = wm.cross_kv(model, window_rows, dims, transposed=True)
    xkv_splice(xkv_k, xkv_v, fresh.k, fresh.v, win_frames)


def _pool_t_valid(dims, xkv_k) -> Optional[int]:
    return dims.n_audio_ctx if xkv_k.shape[-1] > dims.n_audio_ctx else None


def alignatt_tick_inc_pooled(
    model,
    audio_pool,            # [W, N] int16: device-resident audio windows
    xkv_k,                 # [L, G, H, Dh, Tp]: the group's cross-KV pool (in place)
    xkv_v,                 # [L, G, H, Dh, Tp]
    enc_pool,              # [cap, T, D]: cached encoder frames (in place)
    audio_lanes,           # [G] audio pool rows, slot order
    enc_lanes,             # [G] enc_pool rows, slot order
    tail_start,            # [G] first encoder frame of the re-encoded tail
    win_frames,            # [G] current window extent (0 = inactive slot)
    write_start,           # [G] first frame whose features are (re)written
    prefix, prefix_len, sot_index, content_frames, last_attend, is_last,
    max_new, suppress_mask, align_layers, align_heads, frame_threshold,
    rewind_threshold, nonspeech_prob, active_in, cif_w, cif_b,
    dims, p_max, max_steps, eot, ts_begin, no_speech_tok, space_tok,
    use_cif=False, xkv_f8=False, xkv_transposed=True, mel_pallas=False,
    tail_frames: int = 160,
):
    """Incremental tick over a group-resident cross-KV pool, with a
    full-prefix prefill: (1) re-encode the window tail into the cached
    encoder rows (as alignatt_tick_inc); (2) project the aligned 256-column
    splice window of the updated rows and splice it into the pool (K2);
    (3) decode straight off the pool, its padding columns masked. Slot order
    is batch order. ``write_start`` must lie inside the splice window (the
    session plan re-anchors on longer catch-up bursts).

    The pools are updated in place. Returns (packed outputs, xkv_k, xkv_v,
    enc_pool)."""
    if use_cif:
        raise ValueError("CIF needs full-window encoder features; use the EncPool path")
    enc_rows, compute_dtype = _encode_tail_into_rows(
        model, audio_pool, enc_pool, audio_lanes, enc_lanes, tail_start, win_frames,
        write_start, dims, tail_frames,
    )
    _splice_window_into_pool(model, enc_rows, xkv_k, xkv_v, win_frames, dims, compute_dtype)
    outs = _tick_core(
        model, None, prefix, prefix_len, sot_index, content_frames,
        last_attend, is_last, max_new, suppress_mask, align_layers,
        align_heads, frame_threshold, rewind_threshold, nonspeech_prob,
        active_in, cif_w, cif_b, dims, p_max, max_steps, eot, ts_begin,
        no_speech_tok, space_tok, use_cif, xkv_f8, xkv_transposed,
        xkv_pre=wm.CrossKV(k=xkv_k, v=xkv_v), xkv_t_valid=_pool_t_valid(dims, xkv_k),
    )
    return (outs, xkv_k, xkv_v, enc_pool)


def alignatt_tick_inc_skv(
    model,
    audio_pool,            # [W, N] int16: device-resident audio windows
    xkv_k,                 # [L, G, H, Dh, Tp]: group cross-KV pool (in place)
    xkv_v,
    enc_pool,              # [cap, T, D]: cached encoder frames (in place)
    skv_k,                 # [L, G, Wc, H, Dh]: group decoder self-KV (in place)
    skv_v,
    asum,                  # [G, K, T] f32: gate-stat running sums (in place)
    asq,
    alast,                 # [G, K, T] f32: last attended row (in place)
    acount,                # [G] f32 (in place)
    tok_pool,              # [G, n_text_ctx] int32: cache-row token mirror (in place)
    audio_lanes,           # [G] audio pool rows, slot order
    enc_lanes,             # [G]
    tail_start,            # [G] first encoder frame of the re-encoded tail
    win_frames,            # [G] current window extent (0 = inactive slot)
    write_start,           # [G] first frame whose features are (re)written
    refresh_tokens,        # [G, R]: slot 0 = sot row, slot R-1 = last prefix row
    refresh_pos,           # [G, R]: cache positions (Wc-1 = scratch padding)
    prefix_len, content_frames, last_attend, is_last,
    max_new, suppress_mask, align_layers, align_heads, frame_threshold,
    rewind_threshold, nonspeech_prob, active_in, cif_w, cif_b,
    dims, max_steps, eot, ts_begin, no_speech_tok, space_tok,
    xkv_f8=False, xkv_transposed=True,
    tail_frames: int = 160,
):
    """Steady-state tick over both persistent pools: on top of
    alignatt_tick_inc_pooled's tail re-encode and cross-KV splice (K2), the
    full-prefix prefill is replaced by an R-row refresh decode against the
    group's self-KV pool. Committed tokens' K/V rows persist across ticks;
    the refresh re-decodes the sot row (fresh no_speech_p) and the last
    prefix rows (fresh first logits and gate attention) over the updated
    audio, and every anchor rebuilds the rows exactly. One program shape per
    (G, steps, tail, R) serves every prefix length.

    Every pool is updated in place (the JAX program donates them). Returns
    (outs, xkv_k, xkv_v, enc_pool, skv_k, skv_v, asum, asq, alast, acount,
    tok_pool)."""
    enc_rows, compute_dtype = _encode_tail_into_rows(
        model, audio_pool, enc_pool, audio_lanes, enc_lanes, tail_start, win_frames,
        write_start, dims, tail_frames,
    )
    _splice_window_into_pool(model, enc_rows, xkv_k, xkv_v, win_frames, dims, compute_dtype)
    skv = dict(
        cache=wm.KVCache(k=skv_k, v=skv_v),
        asum=asum, asq=asq, acount=acount, alast=alast, tok=tok_pool,
        refresh_tokens=refresh_tokens, refresh_pos=refresh_pos,
    )
    packed, (_, (n_asum, n_asq, n_acount, n_alast), n_tok) = _tick_core(
        model, None, None, prefix_len, None, content_frames,
        last_attend, is_last, max_new, suppress_mask, align_layers,
        align_heads, frame_threshold, rewind_threshold, nonspeech_prob,
        active_in, cif_w, cif_b, dims, 0, max_steps, eot, ts_begin,
        no_speech_tok, space_tok, False, xkv_f8, xkv_transposed,
        xkv_pre=wm.CrossKV(k=xkv_k, v=xkv_v), xkv_t_valid=_pool_t_valid(dims, xkv_k),
        skv=skv, return_state=True,
    )
    # inactive lanes carry their stats through unchanged, so whole copies
    # equal the JAX program's outputs
    asum.copy_(n_asum)
    asq.copy_(n_asq)
    alast.copy_(n_alast)
    acount.copy_(n_acount)
    tok_pool.copy_(n_tok)
    return (
        packed, xkv_k, xkv_v, enc_pool, skv_k, skv_v,
        asum, asq, alast, acount, tok_pool,
    )


def alignatt_tick_anchor_pooled(
    model, audio, xkv_k, xkv_v, enc_pool,
    skv_k, skv_v, asum, asq, alast, acount, tok_pool,
    enc_lanes, slots,
    prefix, prefix_len, sot_index, content_frames, last_attend, is_last,
    max_new, suppress_mask, align_layers, align_heads, frame_threshold,
    rewind_threshold, nonspeech_prob, active_in, cif_w, cif_b,
    dims, p_max, max_steps, eot, ts_begin, no_speech_tok, space_tok,
    use_cif=False, xkv_f8=False, xkv_transposed=True, mel_pallas=False,
):
    """Full-window tick for a chunk of a group's lanes (session join,
    resets): ``slots`` maps each batch lane to its group slot (G for padded
    lanes, which write nothing). The tick decodes from the freshly computed
    dense cross-KV (compute dtype, T columns), so its outputs equal the
    legacy program's; the pools store the pool-dtype cast, zero-padded to
    Tp, and the prefill (re)seeds the lanes' self-KV, gate-stat and token
    rows.

    Every pool is updated in place. Returns (outs, pools...) in the order of
    alignatt_tick_inc_skv."""
    enc = _tick_front(model, audio, dims, mel_pallas)
    enc_pool[enc_lanes.long()] = enc.to(enc_pool.dtype)
    fresh = wm.cross_kv(model, enc, dims, transposed=True)
    packed, (cache, (n_asum, n_asq, n_acount, n_alast), n_tok) = _tick_core(
        model, enc, prefix, prefix_len, sot_index, content_frames,
        last_attend, is_last, max_new, suppress_mask, align_layers,
        align_heads, frame_threshold, rewind_threshold, nonspeech_prob,
        active_in, cif_w, cif_b, dims, p_max, max_steps, eot, ts_begin,
        no_speech_tok, space_tok, use_cif, xkv_f8, xkv_transposed,
        xkv_pre=fresh, cache_width=skv_k.shape[2], return_state=True,
    )
    # the JAX program scatters with mode="drop" (slot G is out of range);
    # torch indexing raises there, so pick the real lanes first. The pools
    # store the compute-dtype projection cast to their dtype, a layer at a
    # time (the float8 cast's transients stay one layer's)
    G = xkv_k.shape[1]
    slots = slots.long()
    real = slots < G
    with TRACER.span("anchor.sync"):  # the lane read waits for the device
        lanes, dst = real.nonzero()[:, 0], slots[real]
    T = fresh.k.shape[-1]
    for pool, src in ((xkv_k, fresh.k), (xkv_v, fresh.v)):
        for layer in range(pool.shape[0]):
            write_cast(pool, (layer, dst, ..., slice(None, T)), src[layer, lanes])
        write_cast(pool, (slice(None), dst, ..., slice(T, None)), 0)
    skv_k[:, dst] = cache.k[:, lanes].to(skv_k.dtype)
    skv_v[:, dst] = cache.v[:, lanes].to(skv_v.dtype)
    asum[dst] = n_asum[lanes]
    asq[dst] = n_asq[lanes]
    alast[dst] = n_alast[lanes]
    acount[dst] = n_acount[lanes]
    tok_pool[dst] = n_tok[lanes]
    return (
        packed, xkv_k, xkv_v, enc_pool,
        skv_k, skv_v, asum, asq, alast, acount, tok_pool,
    )


def alignatt_tick_anchor_group(
    model, audio, xkv_k, xkv_v, enc_pool,
    skv_k, skv_v, asum, asq, alast, acount, tok_pool,
    enc_lanes,
    prefix, prefix_len, sot_index, content_frames, last_attend, is_last,
    max_new, suppress_mask, align_layers, align_heads, frame_threshold,
    rewind_threshold, nonspeech_prob, active_in, cif_w, cif_b,
    dims, p_max, max_steps, eot, ts_begin, no_speech_tok, space_tok,
    use_cif=False, xkv_f8=False, xkv_transposed=True, mel_pallas=False,
):
    """Whole-group anchor (slot order is batch order): re-encode every
    active lane's full window and rebuild the group's cross-KV pool layer by
    layer (cross_kv_into_pool: one layer's K or V as transient, not a dense
    [L,G,H,Dh,T] copy). The decode reads the rebuilt pool, and the prefill
    (re)seeds the active slots' self-KV, gate-stat and token rows; inactive
    slots keep every pool bit. The scheduler aligns a group's window
    evictions to a shared epoch, so this runs once per eviction block for
    the whole group.

    Every pool is updated in place. Returns (outs, pools...) in the order of
    alignatt_tick_inc_skv."""
    enc = _tick_front(model, audio, dims, mel_pallas)
    enc_lanes = enc_lanes.long()
    keep = active_in[:, None, None]
    enc_pool[enc_lanes] = torch.where(keep, enc.to(enc_pool.dtype), enc_pool[enc_lanes])
    pooled = wm.cross_kv_into_pool(model, enc, xkv_k, xkv_v, dims, active=active_in)
    packed, (cache, (n_asum, n_asq, n_acount, n_alast), n_tok) = _tick_core(
        model, enc, prefix, prefix_len, sot_index, content_frames,
        last_attend, is_last, max_new, suppress_mask, align_layers,
        align_heads, frame_threshold, rewind_threshold, nonspeech_prob,
        active_in, cif_w, cif_b, dims, p_max, max_steps, eot, ts_begin,
        no_speech_tok, space_tok, use_cif, xkv_f8, xkv_transposed,
        xkv_pre=pooled, xkv_t_valid=_pool_t_valid(dims, xkv_k),
        cache_width=skv_k.shape[2], return_state=True,
    )
    sel5 = active_in[None, :, None, None, None]
    skv_k.copy_(torch.where(sel5, cache.k.to(skv_k.dtype), skv_k))
    skv_v.copy_(torch.where(sel5, cache.v.to(skv_v.dtype), skv_v))
    sel3 = active_in[:, None, None]
    asum.copy_(torch.where(sel3, n_asum, asum))
    asq.copy_(torch.where(sel3, n_asq, asq))
    alast.copy_(torch.where(sel3, n_alast, alast))
    acount.copy_(torch.where(active_in, n_acount, acount))
    tok_pool.copy_(torch.where(active_in[:, None], n_tok, tok_pool))
    return (
        packed, xkv_k, xkv_v, enc_pool,
        skv_k, skv_v, asum, asq, alast, acount, tok_pool,
    )


def _count_anchor(reason: str) -> None:
    """Why a lane fell off the cheap "inc" path (``ANCHOR_REASONS``)."""
    TRACER.count("anchor." + reason)


# ---------------------------------------------------------------------------
# The whole-group anchor's memory budget
#
# The whole-group anchor re-encodes a whole group and rebuilds its pools in
# one program, and its transient comes on top of every resident group's
# pools. The guard (dispatch._whole_group_anchor_fits) runs it only when
# the transient that the warm pass measured (dispatch.
# precompile_serving_programs) plus a margin fits in what the device can
# still allocate; otherwise the anchor takes the chunked program.
# ---------------------------------------------------------------------------

#: free-memory safety margin for the whole-group anchor budget check
_ANCHOR_HBM_MARGIN = 512 << 20


def _device_free_bytes(device="cuda") -> Optional[int]:
    """Bytes the caching allocator can still hand out on a CUDA device: the
    free bytes cudaMemGetInfo reports plus the cached segments that hold no
    live block (when cudaMalloc fails, the allocator releases those and
    retries). Free blocks inside segments that still hold a live block are
    left out, because a transient's large tensors may not fit them: the
    figure is a lower bound, so the guard errs toward the chunked route.
    None off CUDA, where there are no memory statistics and the guard takes
    the one-group proxy, as the JAX package does on the CPU."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    free, _ = torch.cuda.mem_get_info(device)
    s = torch.cuda.memory_stats(device)
    idle_segments = (
        s.get("reserved_bytes.all.current", 0)
        - s.get("allocated_bytes.all.current", 0)
        - s.get("inactive_split_bytes.all.current", 0)
    )
    return int(free + max(0, idle_segments))


def _anchor_temp_key(xkv, G: int, p_max: int) -> tuple:
    return (G, p_max, str(xkv.dtype), str(xkv.skv_dtype), xkv.skv_width)


def _anchor_group_temp_bytes(engine, xkv, G: int, p_max: int) -> Optional[int]:
    """The whole-group anchor's transient at this shape: the peak of device
    memory over one run above what was allocated before it, as the warm
    pass measured it on scratch pools (dispatch.
    measure_anchor_group_temp_bytes; eager PyTorch has no ahead-of-time
    memory analysis to ask, and measuring here, mid-serving, would read
    other work's allocations). A prefix bucket narrower than every measured
    one takes the nearest wider bucket's figure, an upper bound: on the
    card the transient does not grow as the bucket shrinks (the smoke's
    groups phase prints and checks every bucket's). None when it was never
    measured (off CUDA, or the warm pass turned off): the guard then takes
    the one-group proxy."""
    cache = getattr(engine, "_anchor_temp_cache", {})
    key = _anchor_temp_key(xkv, G, p_max)
    if key in cache:
        return cache[key]
    wider = [k for k in cache if k[0] == G and k[2:] == key[2:] and k[1] > p_max]
    return cache[min(wider, key=lambda k: k[1])] if wider else None


# ---------------------------------------------------------------------------
# Shared engine (host)
# ---------------------------------------------------------------------------


class AlignAttEngine:
    """Shared engine: the model, its device and the static policy config;
    sessions share it."""

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
        if cfg.xkv_cache == "auto":
            cfg.xkv_cache = bool(dims.n_audio_state >= 1280)
        self.model = model
        self.device = model.device
        # beam sessions tick one at a time (streaming/alignatt_beam.py)
        self.beam_lock = threading.Lock()
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
        # pooled-serving prefix cap (AlignAttConfig.serving_prefix_cap): it
        # sizes the self-KV pool and applies only to sessions wired to an
        # XKVAllocator; the commit budget adds pool rows past it, so
        # mid-epoch commits grow the prefix instead of shifting its head
        cap = int(cfg.serving_prefix_cap or 0)
        if cap == 0 and bool(cfg.xkv_cache):
            cap = 96
        self.serving_prefix_cap = min(cap, dims.n_text_ctx - 20) if cap else 0
        budget = max(0, int(cfg.serving_commit_budget))
        if self.serving_prefix_cap:
            budget = min(budget, dims.n_text_ctx - 20 - self.serving_prefix_cap)
        self.serving_commit_budget = budget if self.serving_prefix_cap else 0

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

from .pools import (  # noqa: E402,F401
    AudioPool,
    EncPool,
    XKVAllocator,
    XKVGroupPool,
    _dispatch_pooled_recovering,
    _pool_gather,
    _pool_update,
    _recover_group,
)

_LAZY_EXPORTS = {
    "TokenBufferCtx": "session_plan",
    "TickInputs": "session_plan",
    "TickOutputs": "session_plan",
    "AlignAttSession": "session_plan",
    "_skv_full_refresh_rows": "session_plan",
    "_collect_lane_arrays": "dispatch",
    "_core_device_args": "dispatch",
    "_gather_full_audio": "dispatch",
    "_scatter_outputs": "dispatch",
    "run_tick_batch": "dispatch",
    "_timed_pool_update": "dispatch",
    "dispatch_tick_batch": "dispatch",
    "finalize_tick_batch": "dispatch",
    "_dispatch_group_legacy": "dispatch",
    "_run_group_legacy": "dispatch",
    "_dispatch_group_anchor": "dispatch",
    "_dispatch_group_inc": "dispatch",
    "_whole_group_anchor_fits": "dispatch",
    "_dispatch_group_xkv_inc": "dispatch",
    "_dispatch_group_xkv_anchor": "dispatch",
    "measure_anchor_group_temp_bytes": "dispatch",
    "precompile_serving_programs": "dispatch",
}


def __getattr__(name: str):
    mod = _LAZY_EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __package__), name)
