"""What a metric reader is handed, and the arithmetic readers share."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

SR = 16000


def percentile(values: List[float], q: float) -> Optional[float]:
    """Linear interpolation between closest ranks (numpy's default)."""
    if not values:
        return None
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def audio_rate(records: list, a: float, b: float) -> Optional[float]:
    """Seconds of audio the sessions advanced in [a, b], over its seconds.

    A tick advances the audio fed to its session since that session's
    previous tick. Its audio is spread evenly over its cycle, from the
    session's previous result (or, for a session's first tick, from when it
    was planned) to its own result, and each cycle counts with the part of
    it that lies inside [a, b]."""
    last = {}
    audio = 0.0
    for r in sorted(records, key=lambda r: r.t_prep):
        start = last.get(r.sid, r.t_prep)
        last[r.sid] = r.t_done
        span = r.t_done - start
        inside = min(r.t_done, b) - max(start, a)
        if span > 0 and inside > 0:
            audio += r.advanced * inside / span
    return audio / SR / (b - a) if audio else None


def mean_tick_s(records: list, a: float, b: float) -> Optional[float]:
    """Mean seconds from a tick's planning to its result, over the ticks
    whose result came in [a, b]."""
    ts = [r.t_done - r.t_prep for r in records if a <= r.t_done <= b]
    return sum(ts) / len(ts) if ts else None


@dataclass
class Context:
    cfg: dict
    traffic: dict
    workload: str
    window: object               # drive.Window
    records: list                # system.TickRecord, every tick of the run
    setup_s: float
    max_steps: int
    eot: int
    tail_frames: int
    trace: Optional[dict] = None  # trace.DeviceTrace.summary() plus the kernel calls

    @property
    def window_s(self) -> float:
        return self.window.w1 - self.window.w0

    def done_in_window(self) -> list:
        """Ticks whose result reached their session inside the window."""
        return [r for r in self.records if self.window.w0 <= r.t_done <= self.window.w1]

    def kernel_seconds(self, patterns) -> float:
        """Device seconds of the traced kernels whose names hold a pattern."""
        if not self.trace:
            return 0.0
        return sum(s for n, s in self.trace["by_name"].items() if any(p in n for p in patterns))
