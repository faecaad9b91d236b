"""Batch dispatch layer: pack N sessions' ticks into device programs (port of
whisperlivekit_tpu/streaming/dispatch.py).

Routes TickInputs batches to the tick programs in streaming/alignatt.py,
partitioned by encode mode (legacy / anchor / inc / pooled xkv), with the
dispatch/fetch split of the JAX layer: a dispatch enqueues the group's work
on the device and returns a closure that fetches the packed outputs to the
host, and the whole-group anchor's budget guard. The tick programs are
looked up through the alignatt module at call time, so tests and the smoke
can wrap them there. ``precompile_serving_programs`` is the JAX layer's
ahead-of-time compile as a warm pass: nothing compiles ahead in eager
PyTorch, so it runs each serving program once on scratch pools, which
builds the kernels they launch and measures the whole-group anchor's
transient for the guard.
"""

from __future__ import annotations

import functools
import logging
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import alignatt as _A
from ..audio.mel import N_SAMPLES
from ..engine.trace import TRACER
from .alignatt import SKV_REFRESH_ROWS
from .pools import AudioPool, EncPool, XKVAllocator, XKVGroupPool, _dispatch_pooled_recovering
from .session_plan import TickInputs, TickOutputs, _skv_full_refresh_rows

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
    with TRACER.span("phase.pool_update", lanes=len(ticks)):
        pool.update(
            [
                (t.pool_lane, *t.pool_update)
                for t in ticks
                if t.pool_lane is not None and t.pool_update is not None
            ]
        )


def dispatch_tick_batch(engine, ticks, tokenizer, pool, enc_pool, xkv) -> list:
    """Dispatch every group's tick without fetching outputs.
    Returns [(phase_key, lane_idxs, fetch, t_dispatch_start_ns), ...]."""
    TRACER.tick_dispatched()
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
        t_g = time.perf_counter_ns()
        group = [ticks[i] for i in idxs]
        mk = mode[2] + "_xkv" if isinstance(mode, tuple) else (mode or "legacy")
        with TRACER.span("dispatch." + mk, lanes=len(idxs)):
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
        pends.append((mk, idxs, fetch, t_g))
    TRACER.tick_enqueued()
    return pends


def finalize_tick_batch(pends: list, n: int) -> List[TickOutputs]:
    """Fetch every dispatched group's outputs (input order restored).
    Each mode's phase (``TICK_PHASE_STATS``) spans its dispatch start ->
    its fetch done, so the phases of a tick that mixes modes overlap."""
    outs: List[Optional[TickOutputs]] = [None] * n
    for mk, idxs, fetch, t_g in pends:
        with TRACER.span("fetch." + mk, lanes=len(idxs)):
            res = fetch()
        TRACER.record("phase." + mk, t_g, time.perf_counter_ns(), lanes=len(idxs))
        for i, o in zip(idxs, res):
            outs[i] = o
    TRACER.tick_fetched()
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


def _whole_group_anchor_fits(engine, xkv: XKVAllocator, gi: int, G: int, p_max: int) -> bool:
    """Budget guard for the whole-group anchor: its measured transient
    (_A._anchor_group_temp_bytes) plus a margin must fit in what the device
    can still allocate (_A._device_free_bytes; the pools of every resident
    group count against it). Without memory statistics (the CPU) or a
    measured transient (the warm pass turned off), the JAX package's
    fallback: only while one group is resident. A memoized failure blocks
    the whole-group anchor on that group for good."""
    g = xkv.groups[gi]
    if g.whole_anchor_blocked:
        return False
    free = _A._device_free_bytes(engine.device)
    if free is None:
        return len(xkv.groups) == 1
    temp = _A._anchor_group_temp_bytes(engine, xkv, G, p_max)
    if temp is None:
        return len(xkv.groups) == 1
    return temp + _A._ANCHOR_HBM_MARGIN <= free


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
    finds that its transient fits beside every resident group's pools; small
    subsets (session join, resets) run the slot-scatter program in chunks of
    at most 8 lanes, so the dense per-chunk cross-KV transient stays
    bounded. If a pooled program still fails, the pools are rebuilt and the
    lanes served by the legacy program (_dispatch_pooled_recovering)."""
    g = xkv.groups[gi]
    G = g.group_width
    p_group = max(engine.bucket_for(len(t.prefix_ids)) for t in ticks)
    if len(ticks) >= max(2, G // 2) and _whole_group_anchor_fits(engine, xkv, gi, G, p_group):
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


# ---------------------------------------------------------------------------
# The warm pass: the serving programs on scratch pools
# ---------------------------------------------------------------------------


class _ScratchGroup:
    """One lane group's pools at an allocator's dtypes and widths, an
    encoder pool and an audio pool of ``lanes`` rows (synthetic audio), on
    the engine's device: the warm pass runs the serving programs on these,
    never on a live group, because the programs update their pools in
    place. Every lane is live, with a full window and a prefix that fills
    its bucket (up to the serving cap, as a pooled session's does). Each
    program method builds the program's inputs on the device and returns
    the call, ready to run (and to run again)."""

    def __init__(self, engine, xkv: XKVAllocator, G: int, lanes: int):
        dev = engine.device
        self.engine, self.G, self.lanes = engine, G, lanes
        self.group = XKVGroupPool(
            G, engine.dims, dtype=xkv.dtype, skv_width=xkv.skv_width,
            align_count=xkv.align_count, skv_dtype=xkv.skv_dtype, device=dev,
        )
        self.enc_pool = EncPool(lanes + 1, engine.dims, dtype=engine.model.dtype, device=dev)
        self.audio_pool = AudioPool(lanes, device=dev)
        rng = np.random.default_rng(0)
        noise = rng.integers(-4096, 4096, size=(lanes, N_SAMPLES), dtype=np.int16)
        self.audio_pool.pool.copy_(torch.from_numpy(noise))

    def _lanes(self, B: int, width: int, plen: int) -> dict:
        """Host inputs of B live lanes, each with a ``plen``-token prefix
        (the sot sequence, then text) in a ``width``-wide buffer."""
        eng = self.engine
        tok = eng.tokenizer
        sot = list(tok.sot_sequence)
        prefix = np.full((B, width), tok.eot, np.int32)
        prefix[:, :plen] = tok.encode(" ")[0]
        prefix[:, : len(sot)] = sot
        return dict(
            prefix=prefix,
            prefix_len=np.full(B, plen, np.int32),
            sot_index=np.full(B, sot.index(tok.sot), np.int32),
            content_frames=np.full(B, eng.dims.n_audio_ctx, np.int32),
            last_attend=np.zeros(B, np.int32),
            is_last=np.zeros(B, bool),
            max_new=np.full(B, eng.cfg.max_steps, np.int32),
            active=np.ones(B, bool),
        )

    def _anchor_args(self, B: int, p_max: int):
        """(audio, encoder rows, core args, statics) of a B-lane anchor at
        bucket ``p_max``, each prefix as long as a pooled session's can be
        in that bucket (the serving cap bounds it)."""
        eng = self.engine
        arr = self._lanes(B, p_max, min(p_max, eng.serving_prefix_cap or p_max))
        audio = self.audio_pool.gather([i % self.lanes for i in range(B)])
        enc_lanes = _to_device(eng, 1 + np.arange(B) % self.lanes)
        return (audio, enc_lanes, *_core_device_args(eng, arr, eng.tokenizer, p_max))

    def anchor_group(self, p_max: int):
        g = self.group
        audio, enc_lanes, args, statics = self._anchor_args(self.G, p_max)
        return functools.partial(
            _A.alignatt_tick_anchor_group,
            self.engine.model, audio, g.k, g.v, self.enc_pool.pool,
            g.skv_k, g.skv_v, g.asum, g.asq, g.alast, g.acount, g.tok,
            enc_lanes, *args, **statics,
        )

    def anchor_pooled(self, B: int, p_max: int):
        g = self.group
        audio, enc_lanes, args, statics = self._anchor_args(B, p_max)
        slots = np.minimum(np.arange(B), self.G)  # lanes past the group write nowhere
        return functools.partial(
            _A.alignatt_tick_anchor_pooled,
            self.engine.model, audio, g.k, g.v, self.enc_pool.pool,
            g.skv_k, g.skv_v, g.asum, g.asq, g.alast, g.acount, g.tok,
            enc_lanes, _to_device(self.engine, slots), *args, **statics,
        )

    def inc_skv(self, R: int):
        """The group inc tick at refresh width R, every lane with the
        longest prefix the self-KV pool holds (the serving cap plus the
        commit budget) and its last R-1 rows refreshed."""
        g, eng = self.group, self.engine
        cfg, tok = eng.cfg, eng.tokenizer
        G, Wc, T = self.G, g.skv_width, eng.dims.n_audio_ctx
        plen = Wc - cfg.max_steps - 2
        arr = self._lanes(G, plen, plen)
        r_tok = np.full((G, R), tok.encode(" ")[0], np.int64)
        r_pos = np.full((G, R), Wc - 1, np.int64)  # scratch rows between
        r_tok[:, 0], r_pos[:, 0] = tok.sot, 0
        k = min(R - 1, plen - 1)
        r_pos[:, R - k :] = np.arange(plen - k, plen)
        dev = lambda a: _to_device(eng, a)  # noqa: E731
        win = np.full(G, T, np.int64)
        return functools.partial(
            _A.alignatt_tick_inc_skv,
            eng.model, self.audio_pool.pool, g.k, g.v, self.enc_pool.pool,
            g.skv_k, g.skv_v, g.asum, g.asq, g.alast, g.acount, g.tok,
            dev(np.arange(G) % self.lanes), dev(1 + np.arange(G) % self.lanes),
            dev(win - cfg.enc_tail_frames), dev(win), dev(win - cfg.enc_rewrite_margin),
            dev(r_tok), dev(r_pos),
            dev(arr["prefix_len"]), dev(arr["content_frames"]), dev(arr["last_attend"]),
            dev(arr["is_last"]), dev(arr["max_new"]),
            eng.suppress_mask, eng.align_layers, eng.align_heads,
            int(cfg.frame_threshold), int(cfg.rewind_threshold),
            float(cfg.nonspeech_prob), dev(arr["active"]), eng.cif_w, eng.cif_b,
            dims=eng.dims, max_steps=cfg.max_steps, eot=tok.eot,
            ts_begin=tok.timestamp_begin, no_speech_tok=tok.no_speech,
            space_tok=tok.encode(" ")[0],
            xkv_f8=cfg.xkv_f8, xkv_transposed=getattr(cfg, "xkv_transposed", True),
            tail_frames=cfg.enc_tail_frames,
        )


def _measured(device, call) -> Tuple[float, Optional[int]]:
    """Run a program ``call`` once, to a synchronize: (seconds, the peak of
    device memory over the run above what was allocated before it, the
    call's inputs included; None off CUDA, which has no memory statistics).
    The peak counters are the device's, not the caller's: measure only
    while nothing else allocates."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    call()
    if on_card:
        torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    return secs, (torch.cuda.max_memory_allocated(device) - before) if on_card else None


def measure_anchor_group_temp_bytes(engine, xkv: XKVAllocator, G: int, p_max: int,
                                    scratch: Optional[_ScratchGroup] = None) -> Optional[int]:
    """Run the whole-group anchor once on scratch pools at (G, p_max) and
    the allocator's dtypes, and cache its transient on the engine for
    _A._anchor_group_temp_bytes: the peak over the run above what was
    allocated before it, the scratch pools and the program's inputs
    included in "before", as a real call's are. Returns the bytes, or None
    off CUDA (the program still runs)."""
    scratch = scratch or _ScratchGroup(engine, xkv, G, G)
    _, temp = _measured(engine.device, scratch.anchor_group(p_max))
    if temp is not None:
        if not hasattr(engine, "_anchor_temp_cache"):
            engine._anchor_temp_cache = {}
        engine._anchor_temp_cache[_A._anchor_temp_key(xkv, G, p_max)] = temp
    return temp


def precompile_serving_programs(engine, xkv: XKVAllocator, enc_capacity: int,
                                audio_capacity: int) -> dict:
    """Warm and measure the steady-serving program set, the JAX layer's
    ahead-of-time compile: each program runs once on scratch pools
    (_ScratchGroup) at the group's width, which builds the kernels it
    launches before the first session's tick and measures its transient:

    - the group inc tick (_A.alignatt_tick_inc_skv) at both refresh widths,
    - the chunked anchor (_A.alignatt_tick_anchor_pooled) at B 4 and 8 at
      the cap's bucket (the one shape capped engines route every chunk to),
    - the whole-group anchor at that bucket (measure_anchor_group_temp_bytes),
      whose transient the budget guard reads.

    The capacities bound the scratch pools' rows: a program's transient
    depends on the lanes it touches, not on its pools' rows. Run it before
    the scheduler admits ticks (the transients are read from the device's
    peak counters); a failure raises. Returns {program: seconds}, and keeps
    each program's transient bytes on the engine
    (``_serving_transient_bytes``)."""
    G = xkv.group_width
    scratch = _ScratchGroup(engine, xkv, G, max(1, min(G, enc_capacity - 1, audio_capacity)))
    p_max = engine.bucket_for(engine.serving_prefix_cap or engine.prefix_buckets[-1])
    runs = {}
    for key, R in (
        ("inc_skv", SKV_REFRESH_ROWS),
        ("inc_skv_full", _skv_full_refresh_rows(engine, xkv.skv_width)),
    ):
        runs[key] = _measured(engine.device, scratch.inc_skv(R))
    for B in (4, 8):  # both chunked-anchor widths (CHUNK_SMALL and CHUNK)
        runs[f"anchor_pooled_b{B}"] = _measured(engine.device, scratch.anchor_pooled(B, p_max))
    t0 = time.perf_counter()
    temp = measure_anchor_group_temp_bytes(engine, xkv, G, p_max, scratch)
    runs["anchor_group"] = (time.perf_counter() - t0, temp)
    times = {k: round(s, 3) for k, (s, _) in runs.items()}
    engine._serving_transient_bytes = {k: b for k, (_, b) in runs.items()}
    logger.info("serving programs warmed at G=%d, p_max=%d: seconds %s, transient bytes %s",
                G, p_max, times, engine._serving_transient_bytes)
    return times
