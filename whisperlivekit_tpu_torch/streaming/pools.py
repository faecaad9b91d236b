"""Device-resident serving pools for the AlignAtt streaming path (port of
whisperlivekit_tpu/streaming/pools.py, base form).

Per-lane 30 s audio windows (AudioPool) and per-lane encoder-frame caches
(EncPool) live on the engine's device. Where the JAX programs donate a pool
and return a new one, the port updates the torch tensor IN PLACE
(``index_put_`` / slice writes); the functions still return the pool so the
call sites read like the JAX ones. The large form's group pools
(XKVGroupPool, XKVAllocator) are not ported yet.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np
import torch

from whisperlivekit_tpu.models.whisper.dims import ModelDimensions

from ..audio.mel import N_SAMPLES

logger = logging.getLogger(__name__)


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
