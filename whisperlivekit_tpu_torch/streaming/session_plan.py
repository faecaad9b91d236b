"""Host-side session state + per-tick planning for the AlignAtt path.

AlignAttSession owns one stream's mutable host state (audio window segments,
committed tokens, scrolling text context, pool lanes and device-cache
mirrors) and assembles TickInputs for the device programs in
streaming/alignatt.py — the equivalent of the reference's AlignAtt object +
DecoderState for one stream (reference simul_whisper/simul_whisper.py,
decoder_state.py), with all tensor work moved into the engine's compiled
tick. Port of whisperlivekit_tpu/streaming/session_plan.py: host numpy
logic, copied intact apart from the imports, including the large form's
group-pool branches (``xkv_alloc``, epoch anchors, self-KV refresh plans)
and language auto-detect (``_maybe_detect_language``: a full-window encode
and one decoder step, ``decoding/task.py``). Measurements quoted in the
comments were taken with the JAX package on a TPU v5e, not with this port.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..audio.mel import N_SAMPLES, SAMPLE_RATE, TOKENS_PER_SECOND, log_mel_spectrogram, pad_or_trim
from ..decoding.task import WhisperDecoder
from ..models.whisper import model as wm
from ..models.whisper.tokenizer import Tokenizer, get_tokenizer
from ..timed import ASRToken
from .alignatt import (
    SKV_REFRESH_ROWS,
    STOP_REWIND,
    AlignAttConfig,
    AlignAttEngine,
    _count_anchor,
)
from .pools import AudioPool, EncPool, XKVAllocator

logger = logging.getLogger(__name__)


class TokenBufferCtx:
    """Scrolling text context prompt (reference simul_whisper/token_buffer.py)."""

    def __init__(self, tokenizer: Tokenizer, text: str = "", prefix_token_ids=None):
        self.tokenizer = tokenizer
        self.text = text
        self.prefix_token_ids = list(prefix_token_ids or [])
        self.pending_token_ids: List[int] = []

    def as_token_ids(self) -> List[int]:
        return self.prefix_token_ids + self.tokenizer.encode(self.text)

    def is_empty(self) -> bool:
        return not self.text

    def trim_words(self, num: int = 1, after: int = 0) -> int:
        ids = self.tokenizer.encode(self.text[after:])
        words, wids = self.tokenizer.split_to_word_tokens(ids)
        if not words:
            return 0
        self.text = self.text[:after] + "".join(words[num:])
        return sum(len(w) for w in wids[:num])

    def append_token_ids(self, token_ids: List[int]) -> None:
        all_tokens = self.pending_token_ids + list(token_ids)
        decoded = self.tokenizer.decode(all_tokens)
        if "�" in decoded:
            if len(all_tokens) > 1:
                partial_dec = self.tokenizer.decode(all_tokens[:-1])
                if "�" not in partial_dec:
                    self.text += partial_dec
                    self.pending_token_ids = [all_tokens[-1]]
                else:
                    self.pending_token_ids = all_tokens
            else:
                self.pending_token_ids = all_tokens
        else:
            self.text += decoded
            self.pending_token_ids = []



# ---------------------------------------------------------------------------
# Tick input/output records (host <-> device boundary)
# ---------------------------------------------------------------------------


@dataclass
class TickInputs:
    """Per-lane host-assembled inputs for one streaming tick."""

    audio: Optional[np.ndarray]  # [<=N_SAMPLES] float32; None in pool mode
    prefix_ids: List[int]
    sot_index: int
    content_frames: int
    last_attend: int
    is_last: bool
    max_new: int
    pool_lane: Optional[int] = None
    pool_update: Optional[Tuple[int, int, np.ndarray]] = None  # (shift, start, new_i16)
    # incremental-encoding plan (None = legacy full re-encode)
    enc_mode: Optional[str] = None   # "anchor" | "inc"
    enc_lane: Optional[int] = None
    tail_start: int = 0
    write_start: int = 0
    enc_commit: Optional[Tuple] = None  # ((gen, evicted), win) applied in finish_tick
    # group-resident cross-KV cache routing (XKVAllocator)
    xkv_gi: Optional[int] = None
    xkv_slot: Optional[int] = None
    # self-KV refresh plan (pooled inc ticks; see alignatt_tick_inc_skv):
    # slot 0 = sot row, slot R-1 = last prefix row, scratch-padded between
    skv_refresh_tokens: Optional[np.ndarray] = None  # [R] int32
    skv_refresh_pos: Optional[np.ndarray] = None     # [R] int32


@dataclass
class TickOutputs:
    """Per-lane device outputs of one streaming tick."""

    new_tokens: List[int]     # max_steps entries
    n_keep: int
    frames: np.ndarray        # [max_steps]
    reason: int
    no_speech_p: float
    last_attend: int
    fire: bool = True         # CIF end-of-word boundary at chunk end


def _skv_full_refresh_rows(engine, skv_width: int) -> int:
    """Static width of the FULL-prefix refresh plan: slot 0 (sot row) + up
    to (serving cap + commit budget) prefix rows — the mid-epoch prefix
    ceiling — rounded up to a multiple of 8 so the block decode keeps the
    flash-prefill path (decode() requires S % 8 == 0). One of exactly two
    compiled refresh widths (the other SKV_REFRESH_ROWS), so serving never
    compiles a fresh shape mid-stream."""
    cap = engine.serving_prefix_cap or (skv_width - engine.cfg.max_steps - 2)
    if engine.serving_prefix_cap:
        cap += getattr(engine, "serving_commit_budget", 0)
    return -(-(cap + 1) // 8) * 8



class AlignAttSession:
    """Per-session mutable state + the infer() host policy.

    Equivalent of reference AlignAtt + DecoderState for one stream; all
    tensor work happens in AlignAttEngine's compiled tick.
    """

    def __init__(self, engine: AlignAttEngine, tokenizer: Optional[Tokenizer] = None):
        self.engine = engine
        self.cfg = engine.cfg
        self.tokenizer = tokenizer or engine.tokenizer
        self.speaker: int = -1
        self.global_time_offset = 0.0
        self.detected_language: Optional[str] = None
        self.first_timestamp: Optional[float] = None
        self.pool: Optional[AudioPool] = None  # set by the scheduler
        self.pool_lane: Optional[int] = None
        self._pool_synced: Optional[Tuple[int, int, int]] = None  # (gen, start, len)
        # incremental-encoding cache (set by the scheduler when enabled)
        self.enc_pool: Optional[EncPool] = None
        self.enc_lane: Optional[int] = None
        self._enc_synced_frames = 0
        self._enc_key: Optional[Tuple[int, int]] = None  # (audio_gen, evicted)
        self._enc_pool_gen = 0
        # group-resident cross-KV cache (set by the scheduler when enabled)
        self.xkv_alloc: Optional[XKVAllocator] = None
        self.xkv_gi: Optional[int] = None
        self.xkv_slot: Optional[int] = None
        self._xkv_epoch_seen = 0
        self._xkv_group_gen = 0
        self._reset_segment_state()
        max_ctx = self.cfg.max_context_tokens
        if max_ctx is None:
            # large class: keep steady-state prefixes inside the 128 bucket
            # (context 64 + sot 4 + current-window tokens) — prefill time
            # and the tick program's temp both scale with the bucket (see
            # prefix_buckets above); smaller models keep the reference-like
            # half-context default
            dims_ = engine.dims
            large = dims_.n_audio_state >= 1280 and dims_.n_text_layer >= 16
            max_ctx = 64 if large else dims_.n_text_ctx // 2
        self._max_ctx_auto = self.cfg.max_context_tokens is None
        self.max_context_tokens = max_ctx
        self.max_text_len = engine.dims.n_text_ctx

    # ---- state management ----------------------------------------------------

    def _reset_segment_state(self) -> None:
        self.segments: List[np.ndarray] = []
        self.committed_tokens: List[List[int]] = []  # per retained audio segment era
        self.context = TokenBufferCtx(
            self.tokenizer, prefix_token_ids=[self.tokenizer.sot_prev]
        )
        if self.cfg.static_init_prompt:
            self.context.text = self.cfg.static_init_prompt
        if self.cfg.init_prompt:
            self.context.text += self.cfg.init_prompt
        self.cumulative_time_offset = 0.0
        self.last_attend_frame = -self.cfg.rewind_threshold
        self.pending_incomplete_tokens: List[int] = []
        self.pending_incomplete_token_timestamps: List[float] = []
        self.pending_retries = 0
        # device self-KV cache token mirror (None = pooled rows invalid; the
        # next pooled tick rebuilds them via the anchor prefill)
        self.skv_tokens: Optional[List[int]] = None
        # prepare_tick's cap tail-keep: head tokens currently dropped (block-
        # aligned with hysteresis so the kept head stays put across ticks)
        self._cap_head_drop = 0
        # set when this tick will pay a full prefill anyway (eviction, pool
        # resync): trim_context then trims DEEP (two blocks under the cap)
        # so the cap does not bind again before the next forced anchor —
        # cap-trim head shifts between anchors each cost one extra full
        # prefill (measured e2e n=24: skv_miss.head_shift 580/1178 anchors)
        self._deep_trim = False
        # audio-pool sync bookkeeping
        self.evicted_samples = 0
        self._audio_gen = getattr(self, "_audio_gen", 0) + 1

    def refresh_segment(self, complete: bool = False) -> None:
        keep = [] if (complete or len(self.segments) <= 2) else self.segments[-2:]
        self._reset_segment_state()
        self.segments = list(keep)

    @property
    def initial_tokens(self) -> List[int]:
        return list(self.tokenizer.sot_sequence_including_notimestamps)

    def segments_len(self) -> float:
        return sum(s.shape[0] for s in self.segments) / SAMPLE_RATE

    def insert_audio(self, segment: Optional[np.ndarray] = None) -> float:
        """Append audio; evict oldest past audio_max_len, scrolling committed
        tokens into the text context (reference simul_whisper.py:219-237).

        With an encoder cache, eviction happens in blocks instead of
        continuously: every eviction shifts the window coordinates and
        invalidates the cached frames (one full re-anchor), so batching
        evictions amortizes re-anchors to ~1 per block instead of 1/tick."""
        if segment is not None:
            self.segments.append(np.asarray(segment, np.float32))
        removed = 0.0
        total = self.segments_len()
        limit = self.cfg.audio_max_len
        if (self.enc_pool is not None or self.xkv_slot is not None) and total > limit:
            block = self.cfg.evict_block_s or self.cfg.audio_max_len / 2
            limit = max(self.cfg.audio_max_len - block, 1.0)
        while len(self.segments) > 1 and total > limit:
            removed = self.segments[0].shape[0] / SAMPLE_RATE
            total -= removed
            self.last_attend_frame -= int(TOKENS_PER_SECOND * removed)
            self.cumulative_time_offset += removed
            self.evicted_samples += self.segments[0].shape[0]
            self.segments = self.segments[1:]
            if self.committed_tokens:
                self.context.append_token_ids(self.committed_tokens[0])
                self.committed_tokens = self.committed_tokens[1:]
            self._deep_trim = True  # eviction forces an anchor: trim deep
        return removed

    def trim_context(self) -> None:
        ctx_ids = self.context.as_token_ids()
        c = len(ctx_ids) - len(self.context.prefix_token_ids)
        committed = sum(len(t) for t in self.committed_tokens)
        l = len(self.initial_tokens) + committed + c
        # pooled serving bounds the WHOLE prefix (context + sot + in-window
        # committed) at the serving cap so the self-KV pool width stays
        # small (see serving_prefix_cap). Context is trimmed first: it is
        # scrolled committed history, so the effective text history is
        # still the last ~cap tokens — the split between "context" and
        # "committed" just shifts within the window as tokens commit.
        cap = self.engine.serving_prefix_cap if self.xkv_alloc is not None else 0
        total = l + len(self.context.prefix_token_ids)
        max_ctx = self.max_context_tokens
        if cap and self._max_ctx_auto:
            # let context fill the cap early in the epoch (the cap trim
            # below is the real bound); a fixed 64 would waste cap room
            max_ctx = max(max_ctx, cap)
        after = len(self.cfg.static_init_prompt or "")
        # Trim scheduling: ANY head trim shifts every prefix row's position,
        # misses the slim self-KV refresh plan, and upgrades the whole group
        # tick to the padded full-width refresh program (measured n=24 e2e:
        # fullrefresh.head_shift 829 over 265 inc ticks — with ~22 lanes a
        # single trimming lane taxes everyone, so the group ran full-width
        # nearly every tick, 725 ms vs the 286 ms model). So trims align
        # with ticks that pay a full prefill anyway (eviction, mirror
        # resync): those trim TWO blocks below the cap, and the commit
        # budget (extra pool rows past the cap) absorbs mid-epoch commit
        # growth until the next one. Mid-epoch trims fire only when commits
        # exhaust the budget (a sustained burst) — then trim a block below
        # the cap so the emergency does not repeat next tick.
        deep = self._deep_trim or self.skv_tokens is None
        budget = getattr(self.engine, "serving_commit_budget", 0) if cap else 0
        blk = min(32, cap // 4) if cap else 0
        cap_lo = max(1, cap - (2 * blk if deep else blk)) if cap else 0
        ceil = cap if deep else cap + budget
        trim_now = cap and (total > ceil or (deep and total > cap_lo))
        cap_target = cap_lo if trim_now else ceil
        while c > max_ctx or l > self.max_text_len - 20 or (cap and total > cap_target):
            t = self.context.trim_words(after=after)
            l -= t
            c -= t
            total -= t
            if t == 0:
                break

    def _prefix_ids(self) -> Tuple[List[int], int]:
        ids: List[int] = []
        if not self.context.is_empty() or self.context.prefix_token_ids:
            ctx = self.context.as_token_ids()
            if len(ctx) > 1:  # skip bare sot_prev with no text
                ids.extend(ctx)
        sot_index = len(ids) + self.tokenizer.sot_sequence.index(self.tokenizer.sot)
        ids.extend(self.initial_tokens)
        for seg_tokens in self.committed_tokens:
            ids.extend(seg_tokens)
        return ids, sot_index

    # ---- the per-tick inference ---------------------------------------------

    def prepare_tick(self, is_last: bool = False) -> Optional["TickInputs"]:
        """Host phase 1: assemble per-lane device inputs, or None (no work)."""
        if not self.segments:
            return None
        if self.segments_len() < self.cfg.audio_min_len:
            return None
        self._maybe_epoch_evict()

        eng = self.engine
        dims = eng.dims

        audio = np.concatenate(self.segments) if len(self.segments) > 1 else self.segments[0]
        audio = audio[:N_SAMPLES]  # first 30 s, like reference pad_or_trim(3000)
        audio_s = len(audio) / SAMPLE_RATE
        content_frames = int(len(audio) // 320)  # encoder frames (20 ms each)

        self._maybe_detect_language(audio)

        self.trim_context()
        prefix_ids, sot_index = self._prefix_ids()
        # pooled serving: hard cap even when context trimming could not get
        # under it (in-window committed + sot alone exceed the cap) — the
        # self-KV pool rows only exist up to the cap
        cap = eng.serving_prefix_cap if self.xkv_alloc is not None else 0
        # mid-epoch the commit budget raises the ceiling so in-window commits
        # grow the prefix instead of shifting the head (trim_context's
        # scheduling, same predicate); ticks that will anchor (deep trim /
        # no mirror) keep the hard cap — the anchor prefill program is
        # compiled at p_max = cap
        deep = self._deep_trim or self.skv_tokens is None
        ceil = cap + getattr(eng, "serving_commit_budget", 0) if cap and not deep else cap
        p_need = eng.bucket_for(len(prefix_ids))
        if cap:
            p_need = min(p_need, eng.bucket_for(cap))
        keep_max = min(p_need, cap or p_need)
        if ceil > keep_max:
            keep_max = ceil
        if deep:
            # this tick pays a full prefill (anchor) that rebuilds every
            # row, so a previously applied head drop is stale state
            self._cap_head_drop = 0
        if len(prefix_ids) > keep_max or (cap and self._cap_head_drop):
            # Head drop with hysteresis AND persistence: once applied, the
            # SAME drop re-applies on every later mid-epoch tick —
            # prefix_ids is rebuilt from context/committed each tick, so
            # letting the drop lapse would re-include the dropped head and
            # mismatch the device mirror (one padded full-width refresh per
            # tick). When the drop must move it grows a block PAST the
            # need, keeping the head fixed for the next ~block of commits;
            # with the commit budget raising keep_max mid-epoch, a move
            # here means a sustained burst exhausted the budget (or the
            # first-epoch case: context empty, commits alone exceed it).
            drop_need = max(0, len(prefix_ids) - keep_max)
            blk = min(32, max(8, keep_max // 4))
            extra = 2 * blk if deep else blk
            if (
                self._cap_head_drop < drop_need
                or self._cap_head_drop > drop_need + 2 * blk + extra
                or self._cap_head_drop >= len(prefix_ids) - 1
            ):
                self._cap_head_drop = drop_need + extra
            drop = min(self._cap_head_drop, len(prefix_ids) - 1)
            sot_in_seq = self.tokenizer.sot_sequence.index(self.tokenizer.sot)
            n_ctx = sot_index - sot_in_seq  # context tokens ahead of the sot seq
            if drop <= n_ctx:
                prefix_ids = prefix_ids[drop:]
                sot_index -= drop
            else:
                # The drop reaches past the context into the sot sequence
                # (first-epoch case: context empty, in-window commits exceed
                # the cap). A prompt without sot/lang/task is malformed and
                # the refresh plan's slot-0 "sot row" would re-decode an
                # arbitrary token, skewing no_speech_p until the next anchor
                # — keep the initial tokens at the head and take the
                # overflow from the committed head instead (same kept
                # length, same hysteresis-fixed head).
                n_init = len(self.initial_tokens)
                body = prefix_ids[n_ctx + n_init:]
                cut = min(drop - n_ctx, len(body))
                prefix_ids = prefix_ids[n_ctx:n_ctx + n_init] + body[cut:]
                sot_index = sot_in_seq
        elif not cap:
            self._cap_head_drop = 0
        self._deep_trim = False

        ti = TickInputs(
            audio=audio,
            prefix_ids=prefix_ids,
            sot_index=sot_index,
            content_frames=content_frames,
            last_attend=self.last_attend_frame,
            is_last=is_last,
            max_new=max(50, int(audio_s * 15 * 1.5)),
        )
        self._attach_pool_update(ti, audio)
        self._attach_enc_plan(ti)
        return ti

    def _maybe_epoch_evict(self) -> None:
        """Group-synchronized eviction: when a new anchor sub-epoch matching
        this session's cohort (slot % anchor_cohorts) has passed, evict a
        block early (window permitting) so the cohort re-anchors in one
        batched program and eviction phases stay aligned per cohort (the
        scheduler paces sub-epochs at anchor_cohorts per evict block of
        group ticks; cohorts=1 reproduces whole-group anchors)."""
        if self.xkv_alloc is None or self.xkv_slot is None:
            return
        g = self.xkv_alloc.groups[self.xkv_gi]
        cur = g.sub_epoch
        if cur == self._xkv_epoch_seen:
            return
        C = self.xkv_alloc.anchor_cohorts
        due = any(
            k % C == self.xkv_slot % C
            for k in range(self._xkv_epoch_seen + 1, cur + 1)
        )
        self._xkv_epoch_seen = cur
        if not due:
            return
        block = self.cfg.evict_block_s or self.cfg.audio_max_len / 2
        limit = max(self.cfg.audio_max_len - block, 1.0)
        total = self.segments_len()
        while len(self.segments) > 1 and total > limit:
            removed = self.segments[0].shape[0] / SAMPLE_RATE
            total -= removed
            self.last_attend_frame -= int(TOKENS_PER_SECOND * removed)
            self.cumulative_time_offset += removed
            self.evicted_samples += self.segments[0].shape[0]
            self.segments = self.segments[1:]
            if self.committed_tokens:
                self.context.append_token_ids(self.committed_tokens[0])
                self.committed_tokens = self.committed_tokens[1:]
        # eviction shifts coordinates -> _enc_key mismatch -> anchor plan;
        # sessions whose window was below the threshold anchor anyway (the
        # refresh is exact, and it keeps the whole group in one program)
        self._enc_key = None
        self._deep_trim = True

    def _attach_enc_plan(self, ti: TickInputs) -> None:
        """Choose how this tick encodes: "inc" extends the cached frames with
        a tail re-encode; "anchor" recomputes the full window (first tick,
        after eviction/reset, or when the lane fell too far behind)."""
        if ti.pool_lane is None:
            return  # tail slicing needs the device-resident audio window
        if self.cfg.decoder_type == "beam" and self.cfg.beam_size > 1:
            return
        # failure-recovery resync: a destroyed-and-rebuilt pool
        # (_recover_group generation bump) invalidates this session's device
        # mirrors — drop them so this tick re-anchors from host state
        if self.enc_pool is not None and self._enc_pool_gen != self.enc_pool.generation:
            self._enc_pool_gen = self.enc_pool.generation
            self._enc_key = None
            self._enc_synced_frames = 0
        if self.xkv_alloc is not None and self.xkv_slot is not None:
            gen = self.xkv_alloc.groups[self.xkv_gi].generation
            if self._xkv_group_gen != gen:
                self._xkv_group_gen = gen
                self.skv_tokens = None
        use_xkv = (
            self.xkv_alloc is not None
            and self.enc_pool is not None  # pooled ticks project from cached rows
            and not self.engine.use_cif
        )
        if use_xkv and self.xkv_slot is None:
            got = self.xkv_alloc.acquire()
            if got is not None:
                self.xkv_gi, self.xkv_slot = got
                self._xkv_epoch_seen = self.xkv_alloc.groups[self.xkv_gi].sub_epoch
                self._xkv_group_gen = self.xkv_alloc.groups[self.xkv_gi].generation
        if self.enc_pool is not None:
            if self.enc_lane is None:
                self.enc_lane = self.enc_pool.acquire()
            if self.enc_lane is None:
                return  # cache exhausted: legacy full re-encode
        else:
            return
        win = ti.content_frames
        key = (self._audio_gen, self.evicted_samples)
        tail = self.cfg.enc_tail_frames
        write_start = max(0, self._enc_synced_frames - self.cfg.enc_rewrite_margin)
        pooled = use_xkv and self.xkv_slot is not None
        if pooled:
            # the pool splice re-projects the aligned 256-column window
            # [align128(win-128), +256) from the updated rows: every
            # unsynced frame must fall inside it (longer catch-up bursts
            # re-anchor)
            dst0 = max(0, ((win - 128) // 128) * 128)
            splice_ok = write_start >= dst0
        else:
            splice_ok = True
        if (
            self._enc_key == key
            and 0 < self._enc_synced_frames <= win
            # tail - 2: the device rounds tail_start UP to even for the
            # aligned audio row gather, shortening coverage by <= 1 frame
            and win - write_start <= tail - 2
            and splice_ok
        ):
            ti.enc_mode = "inc"
            ti.write_start = write_start
            ti.tail_start = max(0, win - tail)
        else:
            ti.enc_mode = "anchor"
            if self._enc_key != key:
                _count_anchor("evict_or_reset")
            elif not (0 < self._enc_synced_frames <= win):
                _count_anchor("unsynced")
            elif win - write_start > tail - 2:
                _count_anchor("catchup_burst")
            else:
                _count_anchor("splice_window")
        if pooled and ti.enc_mode == "inc":
            plan = self._skv_refresh_plan(ti)
            if plan is None:
                # prefix shifted beyond the refresh reach (context trim,
                # truncation, >R-1 delta rows): rebuild the pooled decoder
                # state with a full prefill via the anchor path
                ti.enc_mode = "anchor"
                _count_anchor("skv_plan_miss")
            else:
                ti.skv_refresh_tokens, ti.skv_refresh_pos = plan
        if pooled:
            ti.xkv_gi, ti.xkv_slot = self.xkv_gi, self.xkv_slot
            cap = self.engine.serving_prefix_cap
            if ti.enc_mode == "anchor" and cap and len(ti.prefix_ids) > cap:
                # With the commit budget the mid-epoch prefix may exceed the
                # cap; the anchor prefill programs are compiled at
                # p_max = cap (warmup precompile) and a larger bucket would
                # compile mid-serve (~30 s stall). Anchors rebuild every row
                # anyway, so head-truncate to the cap here (sot-preserving)
                # and fold the extra into the persistent head drop so the
                # next tick's prefix matches the rebuilt mirror.
                over = len(ti.prefix_ids) - cap
                ids = ti.prefix_ids
                sot_in_seq = self.tokenizer.sot_sequence.index(self.tokenizer.sot)
                n_ctx = ti.sot_index - sot_in_seq
                if over <= n_ctx:
                    ti.prefix_ids = ids[over:]
                    ti.sot_index -= over
                else:
                    n_init = len(self.initial_tokens)
                    body = ids[n_ctx + n_init:]
                    cut = min(over - n_ctx, len(body))
                    ti.prefix_ids = ids[n_ctx:n_ctx + n_init] + body[cut:]
                    ti.sot_index = sot_in_seq
                self._cap_head_drop += over
        ti.enc_lane = self.enc_lane
        ti.enc_commit = (key, win)

    def _skv_refresh_plan(self, ti: TickInputs):
        """Per-tick self-KV refresh rows (see alignatt_tick_inc_skv).

        The device cache mirror (``skv_tokens`` — prefix + kept tokens as of
        the last tick) tells which cache rows already match this tick's
        prefix; the refresh must cover the delta rows [common, plen) plus
        the always-fresh sot row (slot 0) and last prefix row (slot R-1).
        Returns (tokens [R], positions [R]) or None when the delta exceeds
        the refresh reach (→ full prefill)."""
        m = self.skv_tokens
        p = ti.prefix_ids
        plen = len(p)
        if m is None or plen == 0:
            _count_anchor("skv_miss.no_mirror")
            return None
        R = SKV_REFRESH_ROWS
        common = 0
        for a, b in zip(m, p):
            if a != b:
                break
            common += 1
        g = self.xkv_alloc.groups[self.xkv_gi]
        Wc = g.skv_width
        if plen > Wc - 2:  # would collide with the scratch row; anchor instead
            _count_anchor("skv_miss.width")
            return None
        if plen - common > R - 1:
            # Delta exceeds the slim refresh reach (prefix head moved — cap
            # trim / eviction reshuffle — or a commit burst). The encoder
            # state is still valid in inc mode, so a full-window anchor
            # would waste a 30 s re-encode on an unchanged window: instead
            # re-decode the WHOLE prefix through the same refresh machinery
            # (R_full rows; decode() scatters each row's K/V before
            # attending, so the rebuilt self-KV rows equal an anchor
            # prefill's). Gate running stats keep their inter-anchor
            # bounded staleness, same as the slim refresh.
            Rf = _skv_full_refresh_rows(self.engine, Wc)
            if plen > Rf - 1:
                _count_anchor(
                    "skv_miss.head_shift" if common < plen // 2
                    else "skv_miss.delta_burst"
                )
                return None
            _count_anchor(
                "fullrefresh.head_shift" if common < plen // 2
                else "fullrefresh.delta_burst"
            )
            R = Rf
            start = 0
        else:
            start = max(0, min(common, plen - 1), plen - (R - 1))
        rows = list(range(start, plen))
        tok = np.full(R, self.tokenizer.eot, np.int32)
        pos = np.full(R, Wc - 1, np.int32)  # scratch padding
        si = min(ti.sot_index, plen - 1)
        tok[0], pos[0] = p[si], si
        k = R - len(rows)
        for j, q in enumerate(rows):
            tok[k + j], pos[k + j] = p[q], q
        return tok, pos

    def _attach_pool_update(self, ti: TickInputs, audio: np.ndarray) -> None:
        """Compute the incremental device-window update for pool mode."""
        if self.pool is None:
            return
        if self.cfg.decoder_type == "beam" and self.cfg.beam_size > 1:
            return  # beam ticks use direct transfer; don't advance sync state
        if self.pool_lane is None:
            self.pool_lane = self.pool.acquire()
            if self.pool_lane is None:  # pool exhausted: plain transfer path
                return
        gen, cur_start, cur_len = self._audio_gen, self.evicted_samples, len(audio)

        def to_i16(a):
            return (np.clip(a, -1.0, 1.0 - 1 / 32768) * 32768.0).astype(np.int16)

        synced = self._pool_synced
        incremental = (
            synced is not None
            and synced[0] == gen
            and synced[1] <= cur_start
            and cur_start - synced[1] <= synced[2]
            and synced[1] + synced[2] <= cur_start + cur_len
            and cur_len <= N_SAMPLES
        )
        if incremental:
            shift = cur_start - synced[1]
            kept = synced[2] - shift
            # align the write start to a 128-sample boundary (resending the
            # <=127 overlapping samples) so the device-side chunk write is a
            # fast aligned row gather (_pool_update)
            start_al = (kept // 128) * 128
            ti.pool_update = (shift, start_al, to_i16(audio[start_al:]))
        else:
            ti.pool_update = (N_SAMPLES, 0, to_i16(audio))
        ti.pool_lane = self.pool_lane
        self._pool_synced = (gen, cur_start, cur_len)
        # ti.audio is kept as the fallback for mixed batches (pool exhausted
        # on some lanes); pool-mode batches never transfer it.

    def release_pool_lane(self) -> None:
        if self.pool is not None and self.pool_lane is not None:
            self.pool.release(self.pool_lane)
            self.pool_lane = None
            self._pool_synced = None
        if self.enc_pool is not None and self.enc_lane is not None:
            self.enc_pool.release(self.enc_lane)
            self.enc_lane = None
            self._enc_synced_frames = 0
            self._enc_key = None
        if self.xkv_alloc is not None and self.xkv_slot is not None:
            self.xkv_alloc.release(self.xkv_gi, self.xkv_slot)
            self.xkv_gi = None
            self.xkv_slot = None
            self._enc_synced_frames = 0
            self._enc_key = None
            self.skv_tokens = None

    def infer(self, is_last: bool = False) -> List[ASRToken]:
        ti = self.prepare_tick(is_last)
        if ti is None:
            return []
        if self.cfg.decoder_type == "beam" and self.cfg.beam_size > 1:
            from .alignatt_beam import run_tick_batch_beam

            outs = run_tick_batch_beam(self.engine, [ti], self.tokenizer, self.cfg.beam_size)
        else:
            from .dispatch import run_tick_batch

            outs = run_tick_batch(
                self.engine, [ti], self.tokenizer, pool=self.pool,
                enc_pool=self.enc_pool, xkv=self.xkv_alloc,
            )
        return self.finish_tick(ti, outs[0])

    def finish_tick(self, ti: "TickInputs", out: "TickOutputs") -> List[ASRToken]:
        """Host phase 2: gate results → words, update session state."""
        if ti.enc_commit is not None and ti.enc_mode is not None:
            # the cache rows were written on device; record what they cover
            self._enc_key, self._enc_synced_frames = ti.enc_commit
        cfg = self.cfg
        n = out.n_keep
        reason_code = out.reason
        self.last_stop_reason = reason_code  # final-flush drain reads this
        self.last_attend_frame = out.last_attend

        kept = list(out.new_tokens[:n])
        if ti.xkv_slot is not None and ti.enc_mode is not None:
            # the device cache rows hold prefix + kept MINUS the final kept
            # token: its decode can be the loop's dead last step (skipped —
            # see DEAD_DECODE_SKIP), so its K/V row may not exist. Leaving
            # it out of the mirror makes the next tick's refresh re-decode
            # it (the refresh always covers [common, plen) plus the last
            # row). Rows beyond are dropped-token leftovers, masked until
            # overwritten.
            mirror = kept if reason_code != STOP_REWIND else []
            self.skv_tokens = list(ti.prefix_ids) + [int(t) for t in mirror[:-1]]
        step_frames = out.frames
        # timestamps: one per executed step; token i gets frame of step i
        # (= attention of the previous token — reference off-by-one semantics,
    	# align_att_base.py:240-247).
        n_steps = max(n, 1)
        timestamps = [
            float(step_frames[min(i, cfg.max_steps - 1)]) * 0.02 + self.cumulative_time_offset
            for i in range(n_steps)
        ]

        if reason_code == STOP_REWIND:
            kept = []

        tokens_to_split = kept
        token_timestamps = self._normalize_ts(timestamps, len(tokens_to_split))
        if self.pending_incomplete_tokens:
            tokens_to_split = self.pending_incomplete_tokens + tokens_to_split
            token_timestamps = (
                self.pending_incomplete_token_timestamps + token_timestamps
            )

        if cfg.never_fire:
            fire_detected = False
        elif self.engine.use_cif:
            fire_detected = out.fire
        else:
            fire_detected = True  # CIF absent ⇒ always_fire
        new_hypothesis, split_words, split_tokens = self._split_tokens(
            tokens_to_split, fire_detected, ti.is_last
        )

        if new_hypothesis:
            self.committed_tokens.append(list(new_hypothesis))

        if len(timestamps) >= 2 and self.first_timestamp is None:
            self.first_timestamp = timestamps[0]

        words = self._build_timestamped_words(split_words, split_tokens, token_timestamps)
        self._handle_pending(split_words, split_tokens, token_timestamps)
        return words

    def _maybe_detect_language(self, audio: np.ndarray) -> None:
        if (
            self.cfg.language == "auto"
            and self.detected_language is None
            and self.first_timestamp is not None
            and self.segments_len() - self.first_timestamp >= 2.0
        ):
            eng = self.engine
            dec = WhisperDecoder(eng.model, eng.dims)
            mel = pad_or_trim(
                log_mel_spectrogram(
                    torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(eng.device),
                    n_mels=eng.dims.n_mels,
                    padding=N_SAMPLES - len(audio),
                ),
                2 * eng.dims.n_audio_ctx,
            )[None]
            enc = wm.encode(eng.model, mel, eng.dims)
            codes, _ = dec.detect_language(enc, self.tokenizer)
            top = codes[0]
            logger.info("Detected language: %s", top)
            self.tokenizer = get_tokenizer(
                True,
                num_languages=eng.dims.num_languages,
                language=top,
                task=self.cfg.task,
            )
            self.last_attend_frame = -self.cfg.rewind_threshold
            self.cumulative_time_offset = 0.0
            self.committed_tokens = []
            self.context = TokenBufferCtx(
                self.tokenizer, prefix_token_ids=[self.tokenizer.sot_prev]
            )
            self.skv_tokens = None
            self.detected_language = top

    # ---- post-decode helpers (reference align_att_base.py:325-470) -----------

    @staticmethod
    def _normalize_ts(timestamps: List[float], expected: int) -> List[float]:
        norm = [float(t) for t in timestamps[:expected]]
        if len(norm) >= expected:
            return norm
        fallback = norm[-1] if norm else 0.0
        return norm + [fallback] * (expected - len(norm))

    def _split_tokens(self, tokens_list, fire_detected, is_last):
        if fire_detected or is_last:
            new_hypothesis = tokens_list
            split_words, split_tokens = self.tokenizer.split_to_word_tokens(tokens_list)
        else:
            split_words, split_tokens = self.tokenizer.split_to_word_tokens(tokens_list)
            if len(split_words) > 1:
                new_hypothesis = [i for sub in split_tokens[:-1] for i in sub]
            else:
                new_hypothesis = []
        return new_hypothesis, split_words, split_tokens

    def _build_timestamped_words(self, split_words, split_tokens, token_timestamps):
        MIN_WORD_DURATION = 0.02
        FALLBACK_WORD_DURATION = 0.10
        out: List[ASRToken] = []
        ts_idx = 0
        for word, wtoks in zip(split_words, split_tokens):
            count = len(wtoks)
            if "�" in word:
                cleaned = word.replace("�", "")
                if not cleaned.strip():
                    ts_idx += count
                    continue
                word = cleaned
            wts = token_timestamps[ts_idx : ts_idx + count]
            if not wts:
                fallback = (
                    token_timestamps[min(ts_idx, len(token_timestamps) - 1)]
                    if token_timestamps
                    else 0.0
                )
                wts = [fallback]
            start = wts[0]
            nxt = ts_idx + count
            if nxt < len(token_timestamps):
                end = token_timestamps[nxt]
            else:
                end = wts[-1] + FALLBACK_WORD_DURATION
            end = max(end, start + MIN_WORD_DURATION)
            ts_idx += count
            out.append(
                ASRToken(
                    start=round(start, 2),
                    end=round(end, 2),
                    text=word,
                    speaker=self.speaker,
                    detected_language=self.detected_language,
                ).with_offset(self.global_time_offset)
            )
        return out

    def _handle_pending(self, split_words, split_tokens, token_timestamps):
        MAX_PENDING_TOKENS = 10
        MAX_PENDING_RETRIES = 2
        if split_words and "�" in split_words[-1]:
            self.pending_retries += 1
            if self.pending_retries > MAX_PENDING_RETRIES:
                self.pending_incomplete_tokens = []
                self.pending_incomplete_token_timestamps = []
                self.pending_retries = 0
            elif len(split_tokens[-1]) <= MAX_PENDING_TOKENS:
                self.pending_incomplete_tokens = split_tokens[-1]
                start_idx = sum(len(t) for t in split_tokens[:-1])
                pend_ts = token_timestamps[start_idx : start_idx + len(split_tokens[-1])]
                self.pending_incomplete_token_timestamps = self._normalize_ts(
                    pend_ts, len(split_tokens[-1])
                )
            else:
                self.pending_incomplete_tokens = []
                self.pending_incomplete_token_timestamps = []
                self.pending_retries = 0
        else:
            self.pending_incomplete_tokens = []
            self.pending_incomplete_token_timestamps = []
            self.pending_retries = 0
