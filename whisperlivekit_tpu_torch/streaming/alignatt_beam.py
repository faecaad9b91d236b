"""Beam-search variant of the AlignAtt streaming tick (port of
whisperlivekit_tpu/streaming/alignatt_beam.py).

Each lane carries ``beam`` sub-lanes (flattened batch B*beam); per step the
top-``beam`` continuations per lane are selected over [beam x vocab] scores,
the KV cache, token buffers and attention statistics are gathered along the
sub-lane axis, and EOT-finished beams freeze (they re-emit EOT at zero added
score). The emission gate, rewind and timestamps evaluate on the current
best beam, sub-lane 0, as the reference reads beam 0.

The JAX step loop is a ``lax.while_loop``; here it is a Python loop that
reads one flag per step (whether any lane is still active) and skips the
decoder pass whose outputs nobody reads (the loop's last). ``jax.lax.top_k``
returns the lower index first among equal scores, and ties happen (frozen
beams continue with EOT at zero added score; suppressed tokens all sit at
-inf); ``torch.topk`` promises no order for ties, so the selection is a
stable descending sort. Beam ticks run the plain mel and the legacy
full-window encode (no pools), one session per call, outside the
BatchScheduler, as in the JAX package, and one call at a time per engine
(``AlignAttEngine.beam_lock``).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..audio.mel import N_SAMPLES, log_mel_spectrogram, pad_or_trim
from ..models.whisper import model as wm
from ..models.whisper.dims import ModelDimensions
from ..ops.median import median_filter
from .alignatt import (
    DEC_PAD,
    RUNNING,
    STOP_CAP,
    STOP_CTX,
    STOP_EOT,
    STOP_GATE,
    STOP_NOSPEECH,
    STOP_REWIND,
    dry_penalty,
)
from .session_plan import TickInputs, TickOutputs


def _top_beam(scores: torch.Tensor, beam: int):
    """``jax.lax.top_k(scores, beam)`` over the last axis, ties to the lower
    index, as a stable descending sort."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[:, :beam], idx[:, :beam]


def alignatt_tick_beam(
    model,
    audio: torch.Tensor,          # [B, N_SAMPLES] int16/f32
    prefix: torch.Tensor,         # [B, p_max]
    prefix_len: torch.Tensor,     # [B]
    sot_index: torch.Tensor,      # [B]
    content_frames: torch.Tensor, # [B]
    last_attend: torch.Tensor,    # [B]
    is_last: torch.Tensor,        # [B] bool
    max_new: torch.Tensor,        # [B]
    suppress_mask: torch.Tensor,  # [V]
    align_layers: torch.Tensor,
    align_heads: torch.Tensor,
    frame_threshold,
    rewind_threshold,
    nonspeech_prob,
    active_in: torch.Tensor,      # [B] bool
    dims: ModelDimensions,
    p_max: int,
    max_steps: int,
    beam: int,
    eot: int,
    ts_begin: int,
    no_speech_tok: int,
    space_tok: int,
):
    """One beam tick for B lanes. Returns (new_tokens [B, max_steps], n_keep,
    frames [B, max_steps], reason, no_speech_p, last_attend, fire), the JAX
    program's outputs."""
    B = audio.shape[0]
    BM = B * beam
    dev = audio.device
    align = wm.AlignSpec(layers=align_layers.long(), heads=align_heads.long())
    T = dims.n_audio_ctx
    n_ctx = dims.n_text_ctx

    if audio.dtype == torch.int16:
        audio = audio.float() / 32768.0
    mel = pad_or_trim(log_mel_spectrogram(audio, n_mels=dims.n_mels), 2 * T)
    enc = wm.encode(model, mel, dims)
    # transposed layout ([B,H,Dh,T]), replicated over the beams
    xkv_b = wm.cross_kv(model, enc, dims, transposed=True)
    xkv = wm.CrossKV(
        k=xkv_b.k.repeat_interleave(beam, dim=1), v=xkv_b.v.repeat_interleave(beam, dim=1)
    )
    cache = wm.init_cache(dims, BM, dtype=model.dtype, width=p_max + max_steps + 1, device=dev)

    prefix_bm = prefix.long().repeat_interleave(beam, dim=0)
    plen_bm = prefix_len.long().repeat_interleave(beam, dim=0)
    bm_idx = torch.arange(BM, device=dev)

    # prefill with in-loop alignment reductions (see alignatt._tick_core)
    rows = torch.arange(p_max, device=dev)[None, :]
    row_mask = (rows < plen_bm[:, None]).float()
    last_onehot = (rows == (plen_bm - 1)[:, None]).float()
    prefill_logits, (asum, asq, last_row), cache = wm.decode(
        model, prefix_bm, torch.zeros((BM,), dtype=torch.long, device=dev), xkv, cache, dims,
        align=align, align_reduce=(row_mask, last_onehot), xkv_transposed=True,
    )
    acount = plen_bm.float()
    sot_bm = sot_index.long().repeat_interleave(beam)
    no_speech_p = torch.softmax(prefill_logits[bm_idx, sot_bm], dim=-1)[:, no_speech_tok]
    no_speech_p = no_speech_p.reshape(B, beam)[:, 0]
    logits = prefill_logits[bm_idx, plen_bm - 1]

    tokens = torch.full((BM, n_ctx), eot, dtype=torch.long, device=dev)
    tokens[:, :p_max] = prefix_bm

    V = logits.shape[-1]
    frame_idx = torch.arange(T, device=dev)[None, :]
    vocab_idx = torch.arange(V, device=dev)[None, :]
    blank = (vocab_idx == space_tok) | (vocab_idx == eot)
    cont = torch.where(vocab_idx == eot, 0.0, float("-inf"))[None]  # [1,1,V]
    lane_base = (torch.arange(B, device=dev) * beam)[:, None]       # [B,1]
    content_bm = content_frames.long().repeat_interleave(beam)
    content_frames = content_frames.long()
    last_attend = last_attend.long()
    max_new = max_new.long()
    thr = torch.where(is_last, 4, int(frame_threshold))

    cum = torch.full((B, beam), float("-inf"), device=dev)
    cum[:, 0] = 0.0
    beam_done = torch.zeros((B, beam), dtype=torch.bool, device=dev)
    active = active_in.clone()
    n_keep = torch.zeros((B,), dtype=torch.long, device=dev)
    reason = torch.where(active_in, RUNNING, STOP_CAP).long()
    frames = torch.zeros((B, max_steps), dtype=torch.long, device=dev)

    running = bool(active.any())  # one host read per step (the loop bound)
    k = 0
    while running and k < max_steps:
        cur_len = plen_bm + k  # [BM]

        # ---- filters per sub-lane ----
        lg = logits + suppress_mask[None, :]
        if k == 0:
            lg = lg.masked_fill(blank, float("-inf"))
        lg = dry_penalty(lg, tokens, cur_len, eot)
        logprobs = torch.log_softmax(lg, dim=-1).reshape(B, beam, V)
        # frozen beams: only EOT continues, at zero added score
        logprobs = torch.where(beam_done[:, :, None], cont, logprobs)

        scores = cum[:, :, None] + logprobs  # [B,beam,V]
        top_vals, top_idx = _top_beam(scores.reshape(B, beam * V), beam)
        src_beam = top_idx // V  # [B,beam]
        next_tok = top_idx % V
        src_lane = (lane_base + src_beam).reshape(-1)  # [BM]

        # ---- reorder sub-lane state ----
        tokens = tokens[src_lane]
        asum_r, asq_r, acount_r = asum[src_lane], asq[src_lane], acount[src_lane]
        last_row_r = last_row[src_lane]
        cache_r = wm.KVCache(k=cache.k[:, src_lane], v=cache.v[:, src_lane])

        tok_flat = next_tok.reshape(-1)
        completed_beam = (tok_flat == eot).reshape(B, beam) | beam_done.gather(1, src_beam)
        cum = top_vals

        # ---- attention gate on the best beam (sub-lane 0 of each lane) ----
        denom = acount_r.clamp(min=1.0)[:, None, None]
        mean = asum_r / denom
        var = asq_r / denom - mean * mean
        z = (last_row_r - mean) / (torch.sqrt(var.clamp(min=0.0)) + 1e-8)
        gatt = median_filter(z, 7).mean(dim=1)  # [BM,T]
        gatt = torch.where(frame_idx < content_bm[:, None], gatt, float("-inf"))
        frame = torch.argmax(gatt, dim=-1).reshape(B, beam)[:, 0]
        frames[:, k] = torch.where(active, frame, 0)

        nospeech_stop = (no_speech_p > nonspeech_prob) if k == 0 else torch.zeros_like(active)
        prev_tok = tokens.gather(1, (cur_len - 1)[:, None])[:, 0]
        special_exempt = prev_tok.reshape(B, beam)[:, 0] >= DEC_PAD
        rewind_cond = (~is_last) & (last_attend - frame > rewind_threshold)
        do_rewind = rewind_cond & ~special_exempt
        new_last_attend = torch.where(
            rewind_cond & special_exempt,
            frame,
            torch.where(do_rewind, -int(rewind_threshold), frame),
        )
        gate = (content_frames - frame) <= thr
        best_done = completed_beam[:, 0]
        ctx_full = (plen_bm.reshape(B, beam)[:, 0] + k + 1) >= n_ctx
        cap = (k + 1) > max_new

        stop_keep_k = best_done | gate
        stop_keep_0 = do_rewind | nospeech_stop | cap
        stop_keep_k1 = ctx_full & ~stop_keep_k & ~stop_keep_0
        stopped_now = (stop_keep_k | stop_keep_0 | stop_keep_k1) & active

        reason = torch.where(stopped_now & best_done, STOP_EOT, reason)
        reason = torch.where(stopped_now & gate & ~best_done, STOP_GATE, reason)
        reason = torch.where(stopped_now & do_rewind, STOP_REWIND, reason)
        reason = torch.where(stopped_now & nospeech_stop, STOP_NOSPEECH, reason)
        reason = torch.where(stopped_now & cap, STOP_CAP, reason)
        reason = torch.where(stopped_now & stop_keep_k1, STOP_CTX, reason)

        n_keep = torch.where(
            active, torch.where(stop_keep_0, 0, torch.where(stop_keep_k, k, k + 1)), n_keep
        )

        write_pos = cur_len.clamp(max=n_ctx - 1)
        keep = active.repeat_interleave(beam)
        tokens[bm_idx, write_pos] = torch.where(keep, tok_flat, tokens[bm_idx, write_pos])
        last_attend = torch.where(active, new_last_attend, last_attend)
        active = active & ~stopped_now
        beam_done = completed_beam

        # ---- decode the chosen tokens (attention rows + next logits) ----
        # the loop ends when every lane stopped or k+1 == max_steps; that
        # step's decoder pass would produce outputs no one reads — skip it
        running = k + 1 < max_steps and bool(active.any())
        if running:
            new_logits, step_aprobs, cache = wm.decode(
                model, tok_flat[:, None], write_pos, xkv, cache_r, dims, align=align,
                xkv_transposed=True,
            )
            step_row = step_aprobs.transpose(0, 1)[:, :, 0, :]  # [BM,K,T]
            upd = keep.float()[:, None, None]
            asum = asum_r + step_row * upd
            asq = asq_r + step_row * step_row * upd
            acount = acount_r + keep.float()
            last_row = torch.where(keep[:, None, None], step_row, last_row_r)
            logits = new_logits[:, 0]
        k += 1

    # lanes active at exhaustion keep everything decoded (see _tick_core)
    reason = torch.where(active, STOP_CAP, reason)
    n_keep = torch.where(active, max_steps, n_keep)

    # best beam per lane = sub-lane 0 (kept sorted by the selection each step);
    # its new tokens sit at positions prefix_len .. prefix_len + max_steps
    best_tokens = tokens[torch.arange(B, device=dev) * beam]  # [B, n_ctx]
    step_pos = prefix_len.long()[:, None] + torch.arange(max_steps, device=dev)[None, :]
    new_tokens = best_tokens.gather(1, step_pos.clamp(max=n_ctx - 1))
    i32 = torch.int32
    return (
        new_tokens.to(i32), n_keep.to(i32), frames.to(i32), reason.to(i32),
        no_speech_p.float(), last_attend.to(i32),
        torch.ones((B,), dtype=torch.bool, device=dev),  # fire: CIF is not wired for beam
    )


def run_tick_batch_beam(engine, ticks: List[TickInputs], tokenizer, beam: int) -> List[TickOutputs]:
    """Beam counterpart of run_tick_batch: no pools, the whole window sent
    to the device, the batch padded to a power of two."""
    n = len(ticks)
    B = 1 << (n - 1).bit_length()
    cfg = engine.cfg
    dims = engine.dims
    p_max = max(engine.bucket_for(len(t.prefix_ids)) for t in ticks)

    audio = np.zeros((B, N_SAMPLES), np.int16)
    prefix = np.full((B, p_max), tokenizer.eot, np.int32)
    prefix_len = np.ones(B, np.int32)
    sot_index = np.zeros(B, np.int32)
    content_frames = np.zeros(B, np.int32)
    last_attend = np.zeros(B, np.int32)
    is_last = np.zeros(B, bool)
    max_new = np.ones(B, np.int32)
    active = np.zeros(B, bool)
    for i, t in enumerate(ticks):
        a = t.audio
        if a.dtype != np.int16:
            a = (np.clip(a, -1.0, 1.0 - 1 / 32768) * 32768.0).astype(np.int16)
        audio[i, : len(a)] = a
        prefix[i, : len(t.prefix_ids)] = t.prefix_ids
        prefix_len[i] = len(t.prefix_ids)
        sot_index[i] = t.sot_index
        content_frames[i] = t.content_frames
        last_attend[i] = t.last_attend
        is_last[i] = t.is_last
        max_new[i] = t.max_new
        active[i] = True

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(engine.device)

    # one beam tick at a time per engine: each session's tick runs in its own
    # worker thread, and eager ticks of a few thousand small launches each,
    # issued from several threads at once, hand the interpreter lock back
    # and forth at every launch (a tick took ~40x its solo time with five
    # sessions at once on an H100)
    with engine.beam_lock:
        outs = alignatt_tick_beam(
            engine.model,
            dev(audio), dev(prefix), dev(prefix_len), dev(sot_index), dev(content_frames),
            dev(last_attend), dev(is_last), dev(max_new),
            engine.suppress_mask, engine.align_layers, engine.align_heads,
            int(cfg.frame_threshold), int(cfg.rewind_threshold), float(cfg.nonspeech_prob),
            dev(active), dims, p_max, cfg.max_steps, beam, tokenizer.eot,
            tokenizer.timestamp_begin, tokenizer.no_speech, tokenizer.encode(" ")[0],
        )
        new_tokens, n_keep, frames, reason, no_speech_p, last_attend_out, fire = [
            o.cpu().numpy() for o in outs
        ]
    return [
        TickOutputs(
            new_tokens=[int(x) for x in new_tokens[i]],
            n_keep=int(n_keep[i]),
            frames=frames[i],
            reason=int(reason[i]),
            no_speech_p=float(no_speech_p[i]),
            last_attend=int(last_attend_out[i]),
            fire=bool(fire[i]),
        )
        for i in range(n)
    ]
