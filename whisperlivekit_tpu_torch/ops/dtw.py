"""Monotonic DTW over cross-attention for word-level timestamps.

Equivalent of reference whisper/timing.py:57-133 (numba CPU backtrace +
Triton CUDA wavefront kernel). Here: a vectorized anti-diagonal dynamic
program in numpy — the matrix is at most 448×1500, the wavefront runs
N+M ≈ 2k vectorized steps on host, far off the device's hot path (timing
runs once per committed segment).

A host copy of whisperlivekit_tpu/ops/dtw.py.
"""

from __future__ import annotations

import numpy as np


def dtw(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Min-cost monotonic path through ``cost`` [N, M].

    Returns (text_indices, time_indices) tracing the path, reference-
    compatible (whisper/timing.py `backtrace` step preferences).
    """
    N, M = cost.shape
    INF = np.float64(np.inf)
    D = np.full((N + 1, M + 1), INF, dtype=np.float64)
    D[0, 0] = 0.0
    # trace: 0 = match (diag), 1 = skip text (up), 2 = skip time (left)
    trace = np.full((N + 1, M + 1), 2, dtype=np.uint8)

    # Anti-diagonal wavefront: cells (i, j) with i + j = d.
    for d in range(2, N + M + 1):
        lo = max(1, d - M)
        hi = min(N, d - 1)
        if lo > hi:
            continue
        i = np.arange(lo, hi + 1)
        j = d - i
        c0 = D[i - 1, j - 1]  # diag
        c1 = D[i - 1, j]      # up
        c2 = D[i, j - 1]      # left
        stacked = np.stack([c0, c1, c2])
        t = np.argmin(stacked, axis=0).astype(np.uint8)
        D[i, j] = cost[i - 1, j - 1] + stacked[t, np.arange(len(i))]
        trace[i, j] = t

    # Backtrace from (N, M).
    i, j = N, M
    text_indices, time_indices = [], []
    while i > 0 and j > 0:
        text_indices.append(i - 1)
        time_indices.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return (
        np.array(text_indices[::-1], dtype=np.int64),
        np.array(time_indices[::-1], dtype=np.int64),
    )
