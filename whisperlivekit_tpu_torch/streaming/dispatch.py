"""Batch dispatch layer: pack N sessions' ticks into device programs (port of
whisperlivekit_tpu/streaming/dispatch.py).

Routes TickInputs batches to the tick programs in streaming/alignatt.py,
partitioned by encode mode (legacy / anchor / inc / pooled xkv), with the
dispatch/fetch split of the JAX layer: a dispatch enqueues the group's work
on the device and returns a closure that fetches the packed outputs to the
host, and the whole-group-anchor guard. The tick programs are looked up
through the alignatt module at call time, so tests and the smoke can wrap
them there. The JAX layer's
``precompile_serving_programs`` has no counterpart: nothing compiles ahead
in eager PyTorch.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional

import numpy as np
import torch

from . import alignatt as _A
from ..audio.mel import N_SAMPLES
from .alignatt import SKV_REFRESH_ROWS, TICK_PHASE_STATS
from .pools import AudioPool, EncPool, XKVAllocator, _dispatch_pooled_recovering
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
    the tail-encode program, plan-less lanes the legacy program; with an
    XKVAllocator, lanes holding a group slot run that group's pooled
    programs. Outputs return in input order.
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
            key = ("xkv", t.xkv_gi, t.enc_mode)
        elif t.enc_lane is not None and enc_pool is not None:
            key = t.enc_mode
        else:
            key = None  # plan-less or mis-routed lane: legacy full re-encode
        groups.setdefault(key, []).append(i)
    pends = []
    for mode, idxs in groups.items():
        t_g = time.perf_counter()
        group = [ticks[i] for i in idxs]
        if isinstance(mode, tuple):
            _, gi, enc_mode = mode
            if enc_mode == "inc":
                fetch = _dispatch_group_xkv_inc(
                    engine, group, tokenizer, pool, enc_pool, xkv, gi
                )
                xkv.note_group_tick(gi)
            else:
                fetch = _dispatch_group_xkv_anchor(
                    engine, group, tokenizer, pool, enc_pool, xkv, gi
                )
        elif mode == "inc":
            fetch = _dispatch_group_inc(engine, group, tokenizer, pool, enc_pool)
        elif mode == "anchor":
            fetch = _dispatch_group_anchor(engine, group, tokenizer, pool, enc_pool)
        else:
            fetch = _dispatch_group_legacy(engine, group, tokenizer, pool)
        mk = mode[2] + "_xkv" if isinstance(mode, tuple) else (mode or "legacy")
        pends.append((mk, idxs, fetch, t_g))
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


def _run_group_legacy(engine, ticks, tokenizer, pool) -> List[TickOutputs]:
    return _dispatch_group_legacy(engine, ticks, tokenizer, pool)()


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


def _whole_group_anchor_fits(xkv: XKVAllocator, gi: int) -> bool:
    """Guard for the whole-group anchor: only while one group is resident,
    and never again on a group where it failed. This is the JAX package's
    fallback for an unknown transient; the JAX guard's budget branch needs
    XLA's ahead-of-time memory analysis, which eager PyTorch lacks, and
    the anchor's transient has not been measured on the card yet."""
    return not xkv.groups[gi].whole_anchor_blocked and len(xkv.groups) == 1


def _to_slot_order(arr: dict, slot_of: List[int], G: int) -> dict:
    """Re-index every per-lane row of ``arr`` from input order to slot
    order; absent slots keep zero rows (inactive)."""
    out = {}
    for k, v in arr.items():
        o = np.zeros((G,) + v.shape[1:], v.dtype)
        o[slot_of] = v[: len(slot_of)]
        out[k] = o
    return out


def _dispatch_group_xkv_inc(engine, ticks, tokenizer, pool, enc_pool, xkv, gi):
    """Incremental ticks over the group-resident cross-KV and self-KV pools
    (_A.alignatt_tick_inc_skv: no per-tick prefill, no prefix upload).

    The program always runs at the group's full width in slot order (the
    decode reads the pool tensors directly). Slots without a submission
    this window ride along inactive (win_frames=0, active=False, refresh
    rows parked on the scratch row): their pool rows are untouched and
    their outputs discarded."""
    g = xkv.groups[gi]
    G = g.group_width
    Wc = g.skv_width
    # two refresh widths: the slim per-tick delta (SKV_REFRESH_ROWS) and the
    # full-prefix rebuild; a group tick runs at the widest width any lane
    # needs, and slim plans pad with scratch rows
    R = max(len(t.skv_refresh_tokens) for t in ticks)
    # the prefix itself stays on the host; prefix_len rides to the device
    # for the loop's position math
    p_host = max(8, max(len(t.prefix_ids) for t in ticks))
    slot_of = [t.xkv_slot for t in ticks]
    arr = _to_slot_order(_collect_lane_arrays(engine, ticks, tokenizer, G, p_host), slot_of, G)
    audio_lanes = np.zeros(G, np.int64)
    enc_lanes = np.full(G, EncPool.SCRATCH, np.int64)
    tail_start = np.zeros(G, np.int64)
    win_frames = np.zeros(G, np.int64)
    write_start = np.zeros(G, np.int64)
    r_tok = np.full((G, R), tokenizer.eot, np.int64)
    r_pos = np.full((G, R), Wc - 1, np.int64)  # scratch for absent slots
    for t in ticks:
        sl = t.xkv_slot
        audio_lanes[sl] = t.pool_lane
        enc_lanes[sl] = t.enc_lane
        tail_start[sl] = t.tail_start
        win_frames[sl] = t.content_frames
        write_start[sl] = t.write_start
        r = len(t.skv_refresh_tokens)
        if r == R:
            r_tok[sl] = t.skv_refresh_tokens
            r_pos[sl] = t.skv_refresh_pos
        else:
            # pad a slim plan to the full width: slot 0 (sot row) and the
            # right-aligned delta rows keep their slots; the middle fills
            # with scratch rows (the layout is positional only in slots 0
            # and R-1)
            r_tok[sl, 0] = t.skv_refresh_tokens[0]
            r_pos[sl, 0] = t.skv_refresh_pos[0]
            r_tok[sl, R - (r - 1):] = t.skv_refresh_tokens[1:]
            r_pos[sl, R - (r - 1):] = t.skv_refresh_pos[1:]
    cfg = engine.cfg
    mode_key = "inc_skv" if R == SKV_REFRESH_ROWS else "inc_skv_full"
    dev = lambda a: _to_device(engine, a)  # noqa: E731

    def call():
        raw = _A.alignatt_tick_inc_skv(
            engine.model, pool.pool, g.k, g.v, enc_pool.pool,
            g.skv_k, g.skv_v, g.asum, g.asq, g.alast, g.acount, g.tok,
            dev(audio_lanes), dev(enc_lanes), dev(tail_start), dev(win_frames),
            dev(write_start), dev(r_tok), dev(r_pos),
            dev(arr["prefix_len"]), dev(arr["content_frames"]),
            dev(arr["last_attend"]), dev(arr["is_last"]), dev(arr["max_new"]),
            engine.suppress_mask, engine.align_layers, engine.align_heads,
            int(cfg.frame_threshold), int(cfg.rewind_threshold),
            float(cfg.nonspeech_prob), dev(arr["active"]),
            engine.cif_w, engine.cif_b,
            dims=engine.dims, max_steps=cfg.max_steps, eot=tokenizer.eot,
            ts_begin=tokenizer.timestamp_begin, no_speech_tok=tokenizer.no_speech,
            space_tok=tokenizer.encode(" ")[0],
            xkv_f8=cfg.xkv_f8, xkv_transposed=getattr(cfg, "xkv_transposed", True),
            tail_frames=cfg.enc_tail_frames,
        )
        (g.k, g.v, enc_pool.pool, g.skv_k, g.skv_v,
         g.asum, g.asq, g.alast, g.acount, g.tok) = raw[1:]

        def fetch():
            slot_outs = _scatter_outputs(raw[0], G, cfg.max_steps)
            return [slot_outs[sl] for sl in slot_of]

        return fetch

    return _dispatch_pooled_recovering(
        call, engine, xkv, gi, enc_pool, ticks, tokenizer, pool, mode_key
    )


def _dispatch_group_xkv_anchor(engine, ticks, tokenizer, pool, enc_pool, xkv, gi):
    """Anchor ticks writing into a group's pool rows.

    A majority of the group anchoring together (the epoch-synchronized
    eviction case) runs the whole-group program (layer-by-layer pool
    rebuild, no dense [L,G,H,Dh,T] transient) when _whole_group_anchor_fits
    lets it; small subsets (session join, resets) run the slot-scatter program
    in chunks of at most 8 lanes, so the dense per-chunk cross-KV transient
    stays bounded. If a pooled program still fails, the pools are rebuilt
    and the lanes served by the legacy program
    (_dispatch_pooled_recovering)."""
    g = xkv.groups[gi]
    G = g.group_width
    p_group = max(engine.bucket_for(len(t.prefix_ids)) for t in ticks)
    if len(ticks) >= max(2, G // 2) and _whole_group_anchor_fits(xkv, gi):
        slot_of = [t.xkv_slot for t in ticks]
        arr = _to_slot_order(_collect_lane_arrays(engine, ticks, tokenizer, G, p_group), slot_of, G)
        lanes = [0] * G  # absent slots gather a throwaway row (inactive)
        enc_lanes = np.full(G, EncPool.SCRATCH, np.int64)
        for t in ticks:
            lanes[t.xkv_slot] = t.pool_lane
            enc_lanes[t.xkv_slot] = t.enc_lane
        audio = pool.gather(lanes)
        args, statics = _core_device_args(engine, arr, tokenizer, p_group)

        def call():
            raw = _A.alignatt_tick_anchor_group(
                engine.model, audio, g.k, g.v, enc_pool.pool,
                g.skv_k, g.skv_v, g.asum, g.asq, g.alast, g.acount, g.tok,
                _to_device(engine, enc_lanes), *args, **statics,
            )
            (g.k, g.v, enc_pool.pool, g.skv_k, g.skv_v,
             g.asum, g.asq, g.alast, g.acount, g.tok) = raw[1:]

            def fetch():
                slot_outs = _scatter_outputs(raw[0], G, engine.cfg.max_steps)
                return [slot_outs[sl] for sl in slot_of]

            return fetch

        return _dispatch_pooled_recovering(
            call, engine, xkv, gi, enc_pool, ticks, tokenizer, pool, "anchor_group",
        )

    fetches: List = []
    CHUNK = 8  # bounds the dense per-chunk cross-KV transient
    CHUNK_SMALL = 4  # a second width serves small calls at about half the encode
    for c0 in range(0, len(ticks), CHUNK):
        chunk = ticks[c0 : c0 + CHUNK]
        n = len(chunk)
        # capped engines: two chunk widths and one prefix width (the cap's
        # bucket) for every chunked anchor, as in the JAX package
        if engine.serving_prefix_cap:
            B = CHUNK_SMALL if n <= CHUNK_SMALL else CHUNK
            p_max = engine.bucket_for(engine.serving_prefix_cap)
        else:
            B = 1 << (n - 1).bit_length()
            p_max = max(engine.bucket_for(len(t.prefix_ids)) for t in chunk)
        arr = _collect_lane_arrays(engine, chunk, tokenizer, B, p_max)
        audio = _gather_full_audio(engine, chunk, pool, B)
        slots = np.full(B, G, np.int64)  # padded lanes -> slot G, written nowhere
        enc_lanes = np.full(B, EncPool.SCRATCH, np.int64)
        for i, t in enumerate(chunk):
            slots[i] = t.xkv_slot
            enc_lanes[i] = t.enc_lane
        args, statics = _core_device_args(engine, arr, tokenizer, p_max)

        def call(audio=audio, enc_lanes=enc_lanes, slots=slots, args=args,
                 statics=statics, n=n):
            raw = _A.alignatt_tick_anchor_pooled(
                engine.model, audio, g.k, g.v, enc_pool.pool,
                g.skv_k, g.skv_v, g.asum, g.asq, g.alast, g.acount, g.tok,
                _to_device(engine, enc_lanes), _to_device(engine, slots), *args, **statics,
            )
            (g.k, g.v, enc_pool.pool, g.skv_k, g.skv_v,
             g.asum, g.asq, g.alast, g.acount, g.tok) = raw[1:]
            return lambda: _scatter_outputs(raw[0], n, engine.cfg.max_steps)

        fetches.append(
            _dispatch_pooled_recovering(
                call, engine, xkv, gi, enc_pool, chunk, tokenizer, pool, "anchor_pooled",
            )
        )
    return lambda: [o for f in fetches for o in f()]
