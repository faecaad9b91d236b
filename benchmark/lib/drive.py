"""What every traffic loop shares.

A mix (``traffic/<mix>.json``) is data. Its ``"loop"`` names the arrival
shape that drives it: a module ``traffic/loops/<loop>.py``, found by name
(``run.loop``), with

- ``plan(traffic, seed, n)``: what the seed decides, and
- ``async run(system, traffic, seed, seconds, trace=None, sessions=None)``:
  feeds sessions until warmed up, opens the window (``Window.w0``),
  measures for ``seconds``, closes it (``close_window``), traces
  ``trace_s`` more seconds of the same load in a traced run
  (``trace_after``), then stops feeding, lets the ticks in flight return
  and returns the ``Window``.

A new arrival shape is a new file there; no file here changes. The loops
know the system under test only through its family's contract
(``families/__init__.py``): the configuration's ``model_type`` finds it,
the fourth thing found by name after the mix, its loop and the metric
readers. A model of a new kind is a family file, a plain reference and a
configuration file; no file here changes for it either.

Seeds: where a mix gives ``base_seed``, the voices and the plan come from
it, the same for every run, and ``--seed`` only adds ``sample_noise`` (a
standard deviation, in samples of full scale 1) to every voice. The work a
window holds (which sessions reset, and so anchor) then does not change
with the seed, while every input does. Without it the seed draws both.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np

from .audio import SR, Voices

VOICES = 8
VOICE_OFFSET_S = 2.5


@dataclass
class Window:
    w0: float = 0.0
    w1: float = 0.0
    stats: dict = field(default_factory=dict)
    phases: dict = field(default_factory=dict)
    reasons: dict = field(default_factory=dict)
    streams: Dict[int, Tuple[int, int]] = field(default_factory=dict)  # sid -> (voice, start)
    feeder_late_s: float = 0.0
    sessions: int = 0
    span: Tuple[float, float] = None  # the traced span's (start, end), after the window


def plan_seed(traffic: dict, seed: int) -> int:
    """The seed the voices and the plan are drawn from."""
    return int(traffic.get("base_seed", seed))


def voices_for(traffic: dict, seed: int) -> Voices:
    voices = Voices(plan_seed(traffic, seed), VOICES, traffic.get("voice_s", 60.0))
    noise = float(traffic.get("sample_noise", 0.0))
    if "base_seed" in traffic and noise:
        rng = np.random.default_rng([seed, 13])
        voices.voices = [(v + noise * rng.standard_normal(len(v))).astype(np.float32)
                         for v in voices.voices]
    return voices


def slot_voice(j: int, perm: np.ndarray, voices: Voices) -> Tuple[int, int]:
    """(voice, start sample) of the stream in slot ``j``."""
    k = int(perm[j])
    return k % VOICES, int((k // VOICES) * VOICE_OFFSET_S * SR) % voices.length


async def trace_after(win: Window, trace, span_s: float) -> None:
    """With a trace, record ``span_s`` more seconds of the same load after
    the window has closed: the profiler slows a launch-bound program, so
    the window's own counters stay untraced. The span's ends are kept, so
    its pace can be set beside the window's."""
    if trace is not None:
        trace.start()
        t0 = time.perf_counter()
        await asyncio.sleep(span_s)
        trace.stop()
        win.span = (t0, time.perf_counter())


def close_window(win: Window, system) -> None:
    win.w1 = time.perf_counter()
    win.stats = system.scheduler.stats()
    win.phases = system.phase_stats()
    win.reasons = system.anchor_reasons()


async def wait_until(ready, tasks) -> None:
    """Poll ``ready()``, raising what a task raised meanwhile."""
    while not ready():
        await asyncio.sleep(0.02)
        for t in tasks:
            if t.done() and t.exception() is not None:
                raise t.exception()
