"""The ``--trace 1`` run's device trace and kernel-call records.

A ``torch.profiler`` session with CUDA activity only covers a fixed span
right after the measured window, under the same load (tracing a whole
window of a launch-bound program would be millions of events, and the
profiler slows it). From its raw events:
the device's busy seconds (the union of every kernel, copy and set on the
card), the longest idle gaps, and device seconds by kernel name.

While the span is traced, the benchmark also records each call into the
two hand-written kernels the per-layer rooflines read: K1
(``ops.flash_encoder.flash_encoder_attn``: its shapes, from the host) and
K2 (``ops.xkv_merge.xkv_splice``: its pool shape and dtypes, with the
active lanes taken from the group dispatch that calls it). Their least
times come from ``flops.py``.
"""

from __future__ import annotations

import functools
import re
import threading
import time
from typing import Dict, Iterable, List, Tuple

from . import flops


def short_name(name: str) -> str:
    """A kernel's name without its return type, template and arguments."""
    n = re.sub(r"^void ", "", name.strip())
    for ch in "<(":
        i = n.find(ch)
        if i > 0:
            n = n[:i]
    return n[:64] or "?"


def busy_and_gaps(events: Iterable[Tuple[str, int, int]], t0: int, t1: int):
    """events: (name, start_ns, end_ns) of device activity. Returns the
    seconds in [t0, t1] covered by at least one activity and the gaps
    between activities as (seconds, name before, name after)."""
    ev = sorted((max(s, t0), min(e, t1), n) for n, s, e in events if e > t0 and s < t1)
    busy = 0
    gaps = []
    cur_s = cur_e = last = None
    for s, e, n in ev:
        if cur_e is None:
            cur_s, cur_e, last = s, e, n
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append(((s - cur_e) * 1e-9, last, n))
            cur_s, cur_e, last = s, e, n
        elif e >= cur_e:
            cur_e, last = e, n
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-9, gaps


class KernelCalls:
    """Wraps K1's and K2's entry points to add up their least times while
    ``active``. Install only in traced runs."""

    def __init__(self):
        self.active = False
        self.k1_least_s = 0.0
        self.k1_calls = 0
        self.k2_least_s = 0.0
        self.k2_calls = 0
        self._lanes = threading.local()
        self._undo = []

    def install(self) -> None:
        from whisperlivekit_tpu_torch.ops import flash_encoder, xkv_merge
        from whisperlivekit_tpu_torch.streaming import dispatch

        k1 = flash_encoder.flash_encoder_attn

        @functools.wraps(k1)
        def k1_counted(q, k, v, t_valid, v_transposed=False):
            if self.active:
                B, H, S, Dh = q.shape
                self.k1_least_s += flops.k1_least_s(B, H, S, int(t_valid), Dh, q.element_size())
                self.k1_calls += 1
            return k1(q, k, v, t_valid, v_transposed)

        k2 = xkv_merge.xkv_splice

        @functools.wraps(k2)
        def k2_counted(pool_k, pool_v, tail_k, tail_v, win):
            lanes = getattr(self._lanes, "n", None)
            if self.active and lanes is not None:
                L, _, H, Dh, _ = pool_k.shape
                self.k2_least_s += flops.k2_least_s(lanes, L, H, Dh, tail_k.element_size(), pool_k.element_size())
                self.k2_calls += 1
            return k2(pool_k, pool_v, tail_k, tail_v, win)

        inc = dispatch._dispatch_group_xkv_inc

        @functools.wraps(inc)
        def inc_counted(engine, ticks, *a, **kw):
            self._lanes.n = len(ticks)
            try:
                return inc(engine, ticks, *a, **kw)
            finally:
                self._lanes.n = None

        for mod, name, fn in ((flash_encoder, "flash_encoder_attn", k1_counted),
                              (xkv_merge, "xkv_splice", k2_counted),
                              (dispatch, "_dispatch_group_xkv_inc", inc_counted)):
            self._undo.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)

    def uninstall(self) -> None:
        for mod, name, fn in reversed(self._undo):
            setattr(mod, name, fn)
        self._undo = []


class DeviceTrace:
    """One traced span: ``start()`` and ``stop()`` each synchronize the card
    first, so the span's host seconds bound its device activity."""

    def __init__(self, calls: KernelCalls):
        self.calls = calls
        self.prof = None
        self.window_s = None
        self.events: List[Tuple[str, int, int]] = []

    def start(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        self.calls.active = True
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.calls.active = False
        self.prof.stop()
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if "CUDA" not in str(e.device_type()):
                continue
            s = e.start_ns()
            out.append((e.name(), s, s + e.duration_ns()))
        self.events = out
        self.prof = None

    def summary(self) -> Dict:
        """busy_s, window_s, device seconds by kernel name, breakdown."""
        if not self.events:
            return {"busy_s": 0.0, "window_s": self.window_s, "by_name": {}, "breakdown": None}
        t0 = min(s for _, s, _ in self.events)
        t1 = max(e for _, _, e in self.events)
        busy, gaps = busy_and_gaps(self.events, t0, t1)
        by_name: Dict[str, float] = {}
        for n, s, e in self.events:
            by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-9
        short: Dict[str, float] = {}
        for n, sec in by_name.items():
            short[short_name(n)] = short.get(short_name(n), 0.0) + sec
        top = sorted(short.items(), key=lambda kv: -kv[1])[:10]
        gaps.sort(key=lambda g: -g[0])
        idle = [[f"after {short_name(a)} before {short_name(b)}"[:120], sec] for sec, a, b in gaps[:10]]
        return {
            "busy_s": busy,
            "window_s": self.window_s,
            "by_name": by_name,
            "breakdown": {"device_ops": [[n, s] for n, s in top], "idle_gaps": idle},
        }
