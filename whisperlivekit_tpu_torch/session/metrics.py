"""Per-session runtime tallies and the SESSION_METRICS summary line.

Plays the observability role of the reference's per-session collector
(reference metrics_collector.py:16-83) and keeps its wire line's key names
(`to_dict` is consumed by `wlk bench`/`diagnose` and logged on cleanup), but
is built differently: per-call latencies live in a fixed-capacity ring with
a running exact total — sessions run for hours and the summary only needs
the running aggregate plus recent-window quantiles — and every derived
figure is computed from those aggregates on demand.
"""

from __future__ import annotations

import logging
import time
from typing import Dict

import numpy as np

logger = logging.getLogger(__name__)

# Quantiles are computed over the most recent window; the exact sum/count
# run over the whole session. 4096 calls ≈ 30+ min of ticks at 2 Hz.
LATENCY_WINDOW = 4096


class CallTimes:
    """Append-only record of per-call wall durations, O(1) memory.

    Keeps an exact running ``total``/count for RTF and averages, and a ring
    of the most recent ``LATENCY_WINDOW`` samples for quantiles. Supports
    the two operations the session plane uses: ``append(seconds)`` and
    aggregate reads.
    """

    __slots__ = ("_ring", "_count", "_total")

    def __init__(self) -> None:
        self._ring = np.zeros(LATENCY_WINDOW, np.float64)
        self._count = 0
        self._total = 0.0

    def append(self, seconds: float) -> None:
        self._ring[self._count % LATENCY_WINDOW] = seconds
        self._count += 1
        self._total += seconds

    def __len__(self) -> int:
        return self._count

    def __bool__(self) -> bool:
        return self._count > 0

    @property
    def total_s(self) -> float:
        return self._total

    @property
    def mean_ms(self) -> float:
        return 1000.0 * self._total / self._count if self._count else 0.0

    def quantile_ms(self, q: float) -> float:
        if not self._count:
            return 0.0
        window = self._ring[: min(self._count, LATENCY_WINDOW)]
        return 1000.0 * float(np.quantile(window, q))


class SessionMetrics:
    """Mutable per-session tallies; one instance per AudioProcessor.

    The session plane increments the counters in place; ``log_summary``
    emits the single structured SESSION_METRICS line on cleanup.
    """

    __slots__ = (
        "session_start",
        "total_audio_duration_s",
        "total_processing_time_s",
        "n_chunks_received",
        "n_transcription_calls",
        "n_tokens_produced",
        "n_responses_sent",
        "transcription_durations",
        "n_silence_events",
        "total_silence_duration_s",
    )

    def __init__(self) -> None:
        self.session_start = 0.0
        self.total_audio_duration_s = 0.0
        # Optional externally-measured total; falls back to the per-call sum.
        self.total_processing_time_s = 0.0
        self.n_chunks_received = 0
        self.n_transcription_calls = 0
        self.n_tokens_produced = 0
        self.n_responses_sent = 0
        self.transcription_durations = CallTimes()
        self.n_silence_events = 0
        self.total_silence_duration_s = 0.0

    # -- derived figures --------------------------------------------------

    def _processing_total_s(self) -> float:
        return self.total_processing_time_s or self.transcription_durations.total_s

    @property
    def rtf(self) -> float:
        audio = self.total_audio_duration_s
        return self._processing_total_s() / audio if audio > 0 else 0.0

    @property
    def avg_latency_ms(self) -> float:
        return self.transcription_durations.mean_ms

    @property
    def p95_latency_ms(self) -> float:
        return self.transcription_durations.quantile_ms(0.95)

    # -- wire line ----------------------------------------------------------

    def to_dict(self) -> Dict:
        """The SESSION_METRICS wire payload (key names are the contract)."""
        rounded = {
            "total_audio_duration_s": (self.total_audio_duration_s, 3),
            "total_processing_time_s": (self._processing_total_s(), 3),
            "rtf": (self.rtf, 3),
            "avg_latency_ms": (self.avg_latency_ms, 2),
            "p95_latency_ms": (self.p95_latency_ms, 2),
            "total_silence_duration_s": (self.total_silence_duration_s, 3),
        }
        out: Dict = {"session_start": self.session_start}
        for key in (
            "n_chunks_received",
            "n_transcription_calls",
            "n_tokens_produced",
            "n_responses_sent",
            "n_silence_events",
        ):
            out[key] = getattr(self, key)
        out.update({k: round(v, nd) for k, (v, nd) in rounded.items()})
        return out

    def log_summary(self) -> None:
        line = self.to_dict()
        elapsed = time.time() - self.session_start if self.session_start else 0.0
        line["session_elapsed_s"] = round(elapsed, 3)
        logger.info("SESSION_METRICS %s", line)
