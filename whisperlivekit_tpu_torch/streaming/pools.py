"""Device-resident serving pools for the AlignAtt streaming path (port of
whisperlivekit_tpu/streaming/pools.py).

Per-lane 30 s audio windows (AudioPool), per-lane encoder-frame caches
(EncPool) and the large form's per-group cross-KV and self-KV caches
(XKVGroupPool, allocated by XKVAllocator) live on the engine's device, with
the pooled-program failure containment (_recover_group /
_dispatch_pooled_recovering). Where the JAX programs donate a pool and
return a new one, the port updates the torch tensor IN PLACE
(``index_put_`` / slice writes / ``copy_``); the functions still return the
pool so the call sites read like the JAX ones.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..engine.trace import TRACER
from ..models.whisper.dims import ModelDimensions
from ..audio.mel import N_SAMPLES
from ..ops.f8 import F8, write_cast

logger = logging.getLogger(__name__)


def _pool_t(dims: ModelDimensions) -> int:
    """Cross-KV pool width: n_audio_ctx padded to a multiple of 128 (the
    splice window's alignment); the padding columns are masked."""
    return -(-dims.n_audio_ctx // 128) * 128


class XKVGroupPool:
    """Per-lane-group cross-KV cache resident on the device.

    k/v: [L, G, H, Dh, Tp] in ``dtype`` (the params' dtype, or
    float8_e4m3fn under ``xkv_cache_dtype="f8"``: half the bf16 bytes per
    slot; ``ops/f8.py`` casts as JAX does). Slot order IS the batch order of
    the group's tick programs; sessions pin to a slot for their lifetime and
    a migration forces a re-anchor. Scale-out = more groups, not wider ones.

    With ``skv_width`` it also holds the persistent decoder state of
    alignatt_tick_inc_skv: self-KV rows for prefix + decoded tokens
    ([L, G, Wc, H, Dh]; row Wc-1 is the scratch row where inactive lanes
    park their writes), the gate-stat running sums and the cache-row token
    mirror the DRY penalty reads."""

    def __init__(
        self,
        group_width: int,
        dims: ModelDimensions,
        dtype=torch.bfloat16,
        skv_width: int = 0,
        align_count: int = 0,
        skv_dtype=torch.bfloat16,
        device="cpu",
    ):
        self.group_width = group_width
        G = group_width
        shape = (dims.n_text_layer, G, dims.n_text_head, dims.head_dim, _pool_t(dims))
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self.skv_width = skv_width
        if skv_width:
            sshape = (dims.n_text_layer, G, skv_width, dims.n_text_head, dims.head_dim)
            self.skv_k = torch.zeros(sshape, dtype=skv_dtype, device=device)
            self.skv_v = torch.zeros(sshape, dtype=skv_dtype, device=device)
            stat = (G, align_count, dims.n_audio_ctx)
            self.asum = torch.zeros(stat, device=device)
            self.asq = torch.zeros(stat, device=device)
            self.alast = torch.zeros(stat, device=device)
            self.acount = torch.zeros((G,), device=device)
            self.tok = torch.zeros((G, dims.n_text_ctx), dtype=torch.int32, device=device)
        self._free = list(range(group_width))
        # group-synchronized anchor epochs: the scheduler bumps `sub_epoch`
        # once per (eviction block / anchor_cohorts) of inc ticks; a session
        # in cohort c (= slot % cohorts) force-evicts and plans an anchor
        # when a sub-epoch with index = c (mod cohorts) passes, so each
        # cohort re-anchors in ONE batched program
        self.sub_epoch = 0
        self.ticks_since_epoch = 0
        # failure recovery: _recover_group zeroes the pools and bumps
        # `generation`, so every session of the group drops its device
        # mirrors (skv_tokens) and re-anchors
        self.generation = 0
        # memoized "the whole-group anchor failed here": never retry it on
        # this group (the chunked path is the survivable fallback)
        self.whole_anchor_blocked = False

    def reset(self) -> None:
        """Zero every pool in place (failure recovery)."""
        tensors = [self.k, self.v]
        if self.skv_width:
            tensors += [self.skv_k, self.skv_v, self.asum, self.asq, self.alast,
                        self.acount, self.tok]
        for t in tensors:
            write_cast(t, ..., 0)

    @staticmethod
    def row_bytes(
        dims: ModelDimensions, dtype, skv_width: int = 0, align_count: int = 0,
        skv_dtype=torch.bfloat16,
    ) -> int:
        """Device bytes of one slot: cross-KV, plus the self-KV, gate-stat
        and token rows when ``skv_width`` is set."""
        itemsize = torch.empty((), dtype=dtype).element_size()
        b = 2 * dims.n_text_layer * dims.n_text_head * dims.head_dim * _pool_t(dims) * itemsize
        if skv_width:
            b += (
                2 * dims.n_text_layer * skv_width * dims.n_text_head
                * dims.head_dim * torch.empty((), dtype=skv_dtype).element_size()
            )
            b += 3 * align_count * dims.n_audio_ctx * 4 + dims.n_text_ctx * 4 + 4
        return b

    def acquire(self) -> Optional[int]:
        return self._free.pop() if self._free else None

    def release(self, slot: int) -> None:
        self._free.append(slot)

    @property
    def occupancy(self) -> int:
        return self.group_width - len(self._free)


def xkv_pool_dtype(engine) -> torch.dtype:
    """The cross-KV pools' dtype: float8_e4m3fn under
    ``xkv_cache_dtype="f8"``, else the params' dtype (JAX ``for_engine``)."""
    if getattr(engine.cfg, "xkv_cache_dtype", "bf16") == "f8":
        return F8
    return engine.model.dtype


class XKVAllocator:
    """Scheduler-owned registry of cross-KV cache groups.

    Groups are created lazily up to a device-memory budget; a session holds
    one (group, slot) for its lifetime (slot order IS batch order: the
    decode reads the pool directly, so slots cannot be regathered).
    ``epoch_period`` paces group-synchronized anchors; ``anchor_cohorts``
    staggers them (slot % cohorts) so only ~G/cohorts lanes anchor per
    sub-epoch instead of the whole group at once."""

    def __init__(
        self,
        group_width: int,
        dims: ModelDimensions,
        dtype=torch.bfloat16,
        budget_bytes: int = 9 << 30,
        epoch_period: int = 15,
        anchor_cohorts: int = 1,
        skv_width: int = 0,
        align_count: int = 0,
        skv_dtype=torch.bfloat16,
        device="cpu",
    ):
        self.group_width = group_width
        self.dims = dims
        self.dtype = dtype
        self.skv_width = skv_width
        self.align_count = align_count
        self.skv_dtype = skv_dtype
        self.device = torch.device(device)
        self.epoch_period = epoch_period
        self.anchor_cohorts = max(1, min(anchor_cohorts, epoch_period))
        self.sub_period = max(1, epoch_period // self.anchor_cohorts)
        row = XKVGroupPool.row_bytes(
            dims, dtype, skv_width=skv_width, align_count=align_count,
            skv_dtype=skv_dtype,
        )
        self.max_groups = max(1, int(budget_bytes // (row * group_width)))
        self.groups: List[XKVGroupPool] = []

    @classmethod
    def for_engine(cls, engine, group_width: int, **kw) -> "XKVAllocator":
        """Allocator sized for an engine's serving programs, on its device:
        self-KV width = serving prefix cap + commit budget + step budget +
        1 legit slot + 1 scratch row. The cap (not the top prefix bucket)
        sizes the pool, so the decode's per-step work over the cache stays
        proportional to the prefixes pooled sessions actually carry. The
        cross-KV dtype is ``xkv_pool_dtype``'s."""
        cfg = engine.cfg
        kw.setdefault("dtype", xkv_pool_dtype(engine))
        kw.setdefault("skv_dtype", engine.model.dtype)
        kw.setdefault("device", engine.device)
        return cls(
            group_width, engine.dims,
            skv_width=(engine.serving_prefix_cap or engine.prefix_buckets[-1])
            + engine.serving_commit_budget
            + cfg.max_steps + 2,
            align_count=int(engine.align_layers.shape[0]),
            **kw,
        )

    def acquire(self) -> Optional[Tuple[int, int]]:
        for gi, g in enumerate(self.groups):
            slot = g.acquire()
            if slot is not None:
                return gi, slot
        if len(self.groups) < self.max_groups:
            self.groups.append(
                XKVGroupPool(
                    self.group_width, self.dims, dtype=self.dtype,
                    skv_width=self.skv_width, align_count=self.align_count,
                    skv_dtype=self.skv_dtype, device=self.device,
                )
            )
            return len(self.groups) - 1, self.groups[-1].acquire()
        return None

    def release(self, gi: int, slot: int) -> None:
        self.groups[gi].release(slot)

    def note_group_tick(self, gi: int) -> None:
        g = self.groups[gi]
        g.ticks_since_epoch += 1
        if g.ticks_since_epoch >= self.sub_period:
            g.ticks_since_epoch = 0
            g.sub_epoch += 1

    def stats(self) -> dict:
        return {
            "n_groups": len(self.groups),
            "max_groups": self.max_groups,
            "group_width": self.group_width,
            "anchor_cohorts": self.anchor_cohorts,
            "slots_used": sum(g.occupancy for g in self.groups),
            "epochs": [g.sub_epoch // self.anchor_cohorts for g in self.groups],
        }


class EncPool:
    """Per-lane encoder-frame caches on the device.

    [capacity, n_audio_ctx, n_audio_state] in the params dtype; rows are
    written in place by the anchor/incremental tick programs. Row 0 is a
    scratch target for batch-padding lanes and never allocated."""

    SCRATCH = 0

    def __init__(self, capacity: int, dims: ModelDimensions, dtype=torch.bfloat16, device="cpu"):
        self.capacity = capacity
        self.pool = torch.zeros(
            (capacity, dims.n_audio_ctx, dims.n_audio_state), dtype=dtype, device=device
        )
        self._free = list(range(1, capacity))
        # bumped when the pool is rebuilt; sessions re-anchor on a mismatch
        self.generation = 0

    def acquire(self) -> Optional[int]:
        return self._free.pop() if self._free else None

    def release(self, lane: int) -> None:
        if lane != self.SCRATCH:
            self._free.append(lane)


# ---------------------------------------------------------------------------
# Device-resident audio pool
# ---------------------------------------------------------------------------


def _pool_update(
    pool: torch.Tensor,    # [W, N] int16, updated in place
    lanes: torch.Tensor,   # [U] int — distinct rows
    shifts: torch.Tensor,  # [U] int — samples evicted at window front
    starts: torch.Tensor,  # [U] int — write offset after the shift
    lens: torch.Tensor,    # [U] int — new samples
    chunks: torch.Tensor,  # [U, C] int16, C % 128 == 0
) -> torch.Tensor:
    N = pool.shape[1]
    U, C = chunks.shape
    lanes = lanes.long()
    dev = pool.device
    rows = pool[lanes]

    # eviction shift (identity where shift == 0)
    idx = torch.arange(N, device=dev)[None, :] + shifts.long()[:, None]
    shifted = torch.where(idx < N, rows.gather(1, idx.clamp(max=N - 1)), 0)

    # chunk write as a 128-sample ROW gather: the session host sends
    # 128-aligned starts, so chunk element s - start lives at row
    # s//128 - start//128, lane s%128
    starts = starts.long()
    row_idx = (
        torch.arange(N // 128, device=dev)[None, :] - starts[:, None] // 128
    ).clamp(0, C // 128 - 1)
    vals = chunks.reshape(U, C // 128, 128).gather(
        1, row_idx[:, :, None].expand(U, N // 128, 128)
    ).reshape(U, N)
    pos = torch.arange(N, device=dev)[None, :] - starts[:, None]
    in_chunk = (pos >= 0) & (pos < lens.long()[:, None])
    pool[lanes] = torch.where(in_chunk, vals, shifted)
    return pool


def _pool_gather(pool: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    return pool[lanes.long()]


class AudioPool:
    """Per-lane 30 s audio windows on the device.

    Sessions ship only the samples appended since their last tick instead of
    re-uploading the whole window; window eviction is an on-device shift.
    Chunk width is bucketed like the JAX pool's."""

    CHUNK_BUCKETS = (32000, 160000, N_SAMPLES)  # 2 s / 10 s / full window

    def __init__(self, capacity: int, device="cpu"):
        self.capacity = capacity
        self.device = torch.device(device)
        self.pool = torch.zeros((capacity, N_SAMPLES), dtype=torch.int16, device=self.device)
        self._free = list(range(capacity))
        self.n_updates = 0

    def acquire(self) -> Optional[int]:
        return self._free.pop() if self._free else None

    def release(self, lane: int) -> None:
        self._free.append(lane)

    def update(self, updates: List[Tuple[int, int, int, np.ndarray]]) -> None:
        """updates: (lane, shift, start, new_i16)."""
        if not updates:
            return
        U = len(updates)
        max_new = max(len(u[3]) for u in updates)
        C = next(b for b in self.CHUNK_BUCKETS if b >= max_new)
        lanes = np.zeros(U, np.int64)
        shifts = np.zeros(U, np.int64)
        starts = np.zeros(U, np.int64)
        lens = np.zeros(U, np.int64)
        chunks = np.zeros((U, C), np.int16)
        for i, (lane, shift, start, new) in enumerate(updates):
            lanes[i], shifts[i], starts[i], lens[i] = lane, shift, start, len(new)
            chunks[i, : len(new)] = new
        dev = self.device
        _pool_update(
            self.pool,
            torch.from_numpy(lanes).to(dev),
            torch.from_numpy(shifts).to(dev),
            torch.from_numpy(starts).to(dev),
            torch.from_numpy(lens).to(dev),
            torch.from_numpy(chunks).to(dev),
        )
        self.n_updates += 1

    def gather(self, lanes: List[int]) -> torch.Tensor:
        idx = torch.from_numpy(np.asarray(lanes, np.int64)).to(self.device)
        return _pool_gather(self.pool, idx)


# ---------------------------------------------------------------------------
# Pooled-program failure containment
# ---------------------------------------------------------------------------


def _recover_group(engine, xkv: XKVAllocator, gi: int, enc_pool: Optional[EncPool]) -> None:
    """Zero a group's pools (and the encoder pool) after a pooled program
    failed part-way through writing them, and bump the generations:
    sessions notice on their next prepare_tick, drop their device mirrors
    and re-anchor from host audio and prefix. The anchor prefill reseeds
    every pool row exactly, so recovery costs one anchor per session and
    loses no audio (host segments and the audio pool are intact). The JAX
    package swaps in fresh zero arrays; zeroing in place needs no new
    device memory right after a failure that may have been out of it."""
    g = xkv.groups[gi]
    g.reset()
    g.generation += 1
    if enc_pool is not None:
        enc_pool.pool.zero_()
        enc_pool.generation += 1
    TRACER.add("phase.pool_recovery")  # counted as a phase of no time


def _dispatch_pooled_recovering(dispatch, engine, xkv, gi, enc_pool, ticks,
                                tokenizer, pool, what: str):
    """Dispatch a pooled group program; on failure at either phase (the
    dispatch, or the deferred fetch where asynchronous device errors
    surface), contain it: recover the group's pools and serve the in-flight
    ticks through the legacy full-window program (correct from host state
    alone). A failed whole-group anchor is memoized so it is never retried
    on this group. ``RuntimeError`` covers ``torch.cuda.OutOfMemoryError``.
    A kernel that does not build or launch raises ``KernelError``, which is
    not a ``RuntimeError``: it fails the tick, since the legacy program
    never runs K2 and would hide it. Returns a fetch closure either way."""

    def recover():
        from .dispatch import _run_group_legacy

        logger.exception(
            "pooled %s program failed for group %d: recovering pools, "
            "serving %d lanes via the legacy program", what, gi, len(ticks)
        )
        if what == "anchor_group":
            xkv.groups[gi].whole_anchor_blocked = True
        _recover_group(engine, xkv, gi, enc_pool)
        return _run_group_legacy(engine, ticks, tokenizer, pool)

    try:
        fetch = dispatch()
    except RuntimeError:
        outs = recover()
        return lambda: outs

    def safe_fetch():
        try:
            return fetch()
        except RuntimeError:
            return recover()

    return safe_fetch
