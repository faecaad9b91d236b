"""Batch dispatch layer: pack N sessions' ticks into device programs (port of
whisperlivekit_tpu/streaming/dispatch.py, base form).

Routes TickInputs batches to the tick programs in streaming/alignatt.py,
partitioned by encode mode (legacy / anchor / inc), with the dispatch/fetch
split of the JAX layer: a dispatch enqueues the group's work on the device
and returns a closure that fetches the packed outputs to the host. The tick
programs are looked up through the alignatt module at call time, so tests
can patch them there. Lanes routed to the large form's group pools raise:
those programs are not ported yet.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional

import numpy as np
import torch

from . import alignatt as _A
from ..audio.mel import N_SAMPLES
from .alignatt import TICK_PHASE_STATS
from .pools import AudioPool, EncPool
from .session_plan import TickInputs, TickOutputs

logger = logging.getLogger(__name__)


def _collect_lane_arrays(engine, ticks: List[TickInputs], tokenizer, B: int, p_max: int):
    """Pad N lanes' host inputs to batch B (power of two) as numpy arrays."""
    arr = dict(
        prefix=np.full((B, p_max), tokenizer.eot, np.int32),
        prefix_len=np.ones(B, np.int32),
        sot_index=np.zeros(B, np.int32),
        content_frames=np.zeros(B, np.int32),
        last_attend=np.zeros(B, np.int32),
        is_last=np.zeros(B, bool),
        max_new=np.ones(B, np.int32),
        active=np.zeros(B, bool),
    )
    for i, t in enumerate(ticks):
        arr["prefix"][i, : len(t.prefix_ids)] = t.prefix_ids
        arr["prefix_len"][i] = len(t.prefix_ids)
        arr["sot_index"][i] = t.sot_index
        arr["content_frames"][i] = t.content_frames
        arr["last_attend"][i] = t.last_attend
        arr["is_last"][i] = t.is_last
        arr["max_new"][i] = t.max_new
        arr["active"][i] = True
    return arr


def _to_device(engine, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(engine.device)


def _core_device_args(engine, arr, tokenizer, p_max: int):
    """(positional core args, static kwargs) shared by the tick programs."""
    cfg = engine.cfg
    dev = lambda k: _to_device(engine, arr[k])  # noqa: E731
    args = (
        dev("prefix"),
        dev("prefix_len"),
        dev("sot_index"),
        dev("content_frames"),
        dev("last_attend"),
        dev("is_last"),
        dev("max_new"),
        engine.suppress_mask,
        engine.align_layers,
        engine.align_heads,
        int(cfg.frame_threshold),
        int(cfg.rewind_threshold),
        float(cfg.nonspeech_prob),
        dev("active"),
        engine.cif_w,
        engine.cif_b,
    )
    statics = dict(
        dims=engine.dims,
        p_max=p_max,
        max_steps=cfg.max_steps,
        eot=tokenizer.eot,
        ts_begin=tokenizer.timestamp_begin,
        no_speech_tok=tokenizer.no_speech,
        space_tok=tokenizer.encode(" ")[0],
        use_cif=engine.use_cif,
        xkv_f8=cfg.xkv_f8,
        xkv_transposed=getattr(cfg, "xkv_transposed", True),
        mel_pallas=getattr(cfg, "mel_pallas", False),
    )
    return args, statics


def _gather_full_audio(engine, ticks: List[TickInputs], pool: Optional[AudioPool], B: int):
    """Full 30 s windows for legacy/anchor ticks: a device gather when every
    lane is pool-backed, otherwise one direct int16 transfer."""
    if pool is not None and all(t.pool_lane is not None for t in ticks):
        lanes = [t.pool_lane for t in ticks] + [0] * (B - len(ticks))
        return pool.gather(lanes)
    audio = np.zeros((B, N_SAMPLES), np.int16)
    for i, t in enumerate(ticks):
        a = t.audio
        if a.dtype != np.int16:
            a = (np.clip(a, -1.0, 1.0 - 1 / 32768) * 32768.0).astype(np.int16)
        audio[i, : len(a)] = a
    return _to_device(engine, audio)


def _scatter_outputs(raw: torch.Tensor, n: int, max_steps: int) -> List[TickOutputs]:
    """Unpack the single packed int32 tick output (one device->host copy)."""
    packed = raw.cpu().numpy()
    S = max_steps
    new_tokens = packed[:, :S]
    frames = packed[:, S : 2 * S]
    n_keep = packed[:, 2 * S]
    reason = packed[:, 2 * S + 1]
    last_attend_out = packed[:, 2 * S + 2]
    fire = packed[:, 2 * S + 3]
    no_speech_p = packed[:, 2 * S + 4].view(np.float32)
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


def run_tick_batch(
    engine: "AlignAttEngine",
    ticks: List[TickInputs],
    tokenizer,
    pool: Optional[AudioPool] = None,
    enc_pool: Optional[EncPool] = None,
    xkv=None,
) -> List[TickOutputs]:
    """Pack N lanes into device programs and scatter the outputs.

    Lane count is padded to a power of two and the prefix width to the
    common bucket. With an AudioPool, lanes are updated with only their new
    samples, then gathered on the device. With an EncPool, "anchor" lanes
    run the full-window program (and refresh their cached rows), "inc" lanes
    the tail-encode program, plan-less lanes the legacy program. Outputs
    return in input order.
    """
    return finalize_tick_batch(
        dispatch_tick_batch(engine, ticks, tokenizer, pool, enc_pool, xkv),
        len(ticks),
    )


def _timed_pool_update(pool: AudioPool, ticks: List[TickInputs]) -> None:
    # Audio-pool rows must stay in sync with the sessions' _pool_synced
    # bookkeeping (committed in prepare_tick), so apply updates for every
    # pool-backed lane before anything gathers.
    t_p = time.perf_counter()
    pool.update(
        [
            (t.pool_lane, *t.pool_update)
            for t in ticks
            if t.pool_lane is not None and t.pool_update is not None
        ]
    )
    n_t, tot, lanes = TICK_PHASE_STATS.get("pool_update", (0, 0.0, 0))
    TICK_PHASE_STATS["pool_update"] = (
        n_t + 1, tot + (time.perf_counter() - t_p), lanes + len(ticks)
    )


def dispatch_tick_batch(engine, ticks, tokenizer, pool, enc_pool, xkv) -> list:
    """Dispatch every group's tick without fetching outputs.
    Returns [(phase_key, lane_idxs, fetch, t_dispatch_start), ...]."""
    if pool is not None:
        _timed_pool_update(pool, ticks)
    groups: dict = {}
    for i, t in enumerate(ticks):
        if t.xkv_slot is not None and xkv is not None:
            raise NotImplementedError(
                "pooled cross-KV ticks (the large form) are not ported yet"
            )
        if t.enc_lane is not None and enc_pool is not None:
            key = t.enc_mode
        else:
            key = None  # plan-less or mis-routed lane: legacy full re-encode
        groups.setdefault(key, []).append(i)
    pends = []
    for mode, idxs in groups.items():
        t_g = time.perf_counter()
        group = [ticks[i] for i in idxs]
        if mode == "inc":
            fetch = _dispatch_group_inc(engine, group, tokenizer, pool, enc_pool)
        elif mode == "anchor":
            fetch = _dispatch_group_anchor(engine, group, tokenizer, pool, enc_pool)
        else:
            fetch = _dispatch_group_legacy(engine, group, tokenizer, pool)
        pends.append((mode or "legacy", idxs, fetch, t_g))
    return pends


def finalize_tick_batch(pends: list, n: int) -> List[TickOutputs]:
    """Fetch every dispatched group's outputs (input order restored).
    Phase wall time spans dispatch start -> fetch done per group."""
    outs: List[Optional[TickOutputs]] = [None] * n
    for mk, idxs, fetch, t_g in pends:
        res = fetch()
        n_t, tot, lanes = TICK_PHASE_STATS.get(mk, (0, 0.0, 0))
        TICK_PHASE_STATS[mk] = (
            n_t + 1, tot + (time.perf_counter() - t_g), lanes + len(idxs)
        )
        for i, o in zip(idxs, res):
            outs[i] = o
    return outs  # type: ignore[return-value]


def _dispatch_group_legacy(engine, ticks, tokenizer, pool):
    n = len(ticks)
    B = 1 << (n - 1).bit_length()
    p_max = max(engine.bucket_for(len(t.prefix_ids)) for t in ticks)
    arr = _collect_lane_arrays(engine, ticks, tokenizer, B, p_max)
    audio = _gather_full_audio(engine, ticks, pool, B)
    args, statics = _core_device_args(engine, arr, tokenizer, p_max)
    raw = _A.alignatt_tick(engine.model, audio, *args, **statics)
    return lambda: _scatter_outputs(raw, n, engine.cfg.max_steps)


def _dispatch_group_anchor(engine, ticks, tokenizer, pool, enc_pool):
    n = len(ticks)
    B = 1 << (n - 1).bit_length()
    p_max = max(engine.bucket_for(len(t.prefix_ids)) for t in ticks)
    arr = _collect_lane_arrays(engine, ticks, tokenizer, B, p_max)
    audio = _gather_full_audio(engine, ticks, pool, B)
    # padded lanes write their (garbage) rows to the scratch row
    enc_lanes = np.asarray([t.enc_lane for t in ticks] + [EncPool.SCRATCH] * (B - n), np.int64)
    args, statics = _core_device_args(engine, arr, tokenizer, p_max)
    raw = _A.alignatt_tick_anchor(
        engine.model, audio, enc_pool.pool, _to_device(engine, enc_lanes), *args, **statics,
    )
    enc_pool.pool = raw[-1]
    return lambda: _scatter_outputs(raw[0], n, engine.cfg.max_steps)


def _dispatch_group_inc(engine, ticks, tokenizer, pool, enc_pool):
    n = len(ticks)
    B = 1 << (n - 1).bit_length()
    p_max = max(engine.bucket_for(len(t.prefix_ids)) for t in ticks)
    arr = _collect_lane_arrays(engine, ticks, tokenizer, B, p_max)
    audio_lanes = np.zeros(B, np.int64)
    enc_lanes = np.full(B, EncPool.SCRATCH, np.int64)
    tail_start = np.zeros(B, np.int64)
    win_frames = np.zeros(B, np.int64)   # 0 for padded lanes: nothing written
    write_start = np.zeros(B, np.int64)
    for i, t in enumerate(ticks):
        audio_lanes[i] = t.pool_lane
        enc_lanes[i] = t.enc_lane
        tail_start[i] = t.tail_start
        win_frames[i] = t.content_frames
        write_start[i] = t.write_start
    args, statics = _core_device_args(engine, arr, tokenizer, p_max)
    dev = lambda a: _to_device(engine, a)  # noqa: E731
    raw = _A.alignatt_tick_inc(
        engine.model, pool.pool, enc_pool.pool,
        dev(audio_lanes), dev(enc_lanes), dev(tail_start), dev(win_frames), dev(write_start),
        *args, **statics, tail_frames=engine.cfg.enc_tail_frames,
    )
    enc_pool.pool = raw[-1]
    return lambda: _scatter_outputs(raw[0], n, engine.cfg.max_steps)
