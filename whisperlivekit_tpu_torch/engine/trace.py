"""The serving path's one tracer: span and counter aggregates that are always
on, and span records, per-tick CUDA events and a clock pair while enabled.

Always on (``Tracer.spans``, ``Tracer.counters``, ``Tracer.hists``): per
span name a count, total seconds and lanes; per counter name a count; per
histogram name the count of observations in each 1 ms bin. A span costs
two ``perf_counter_ns`` reads and a locked update. ``TICK_PHASE_STATS``
(``phase.*`` spans) and ``ANCHOR_REASONS`` (``anchor.*`` counters) are
views of these, and ``BatchScheduler.stats()`` hands out the rest under
``"trace"``; ``BatchScheduler.reset_stats()`` zeroes them.

While enabled (``Tracer.enable``; ``Tracer.disable``), each span also
leaves a ``Span`` record in ``Tracer.records``: its name, start and end as
``time.perf_counter_ns()``, thread, parent record, group-tick id and a few
integer attributes. Nothing is written out on the hot path. The group-tick
id is ``TICK_ID``, a context variable the scheduler sets on its task;
``asyncio.to_thread`` copies it to the worker thread. Spans that cross an
``await`` (other coroutines run meanwhile on the same thread) are recorded
as explicit pairs (``Tracer.record``), never on the thread's span stack.
Enabled on a CUDA device, each group tick's dispatch start and last
enqueue are CUDA events, read after the tick's fetch has synchronised and
converted to the host clock through one reference event recorded at
``enable``: a ``device.tick`` record on the ``cuda`` thread, which runs from
the dispatch start until the device finished what the tick enqueued. Off
CUDA that record takes the host's dispatch start and fetch end (attribute
``host`` 1). ``Tracer.clock`` is a (``perf_counter_ns``, ``time_ns``) pair
read at ``enable``: ``torch.profiler`` event times are Unix nanoseconds, so
``to_unix_ns`` puts a span on the profiler's clock.

Spans (the tree of one group tick) and counters, and what reads them:

- ``sched.gather`` (loop thread; lanes, ``carried``, ``first_wait_ns``,
  ``window_wait_ns``), ``sched.tick`` (worker; lanes, ``cpu_ns`` the
  worker's thread CPU time), ``sched.finish`` (loop; the group's
  ``finish_tick`` calls), ``device.tick``;
- under ``sched.tick``: ``phase.pool_update``, ``dispatch.<mode>`` (the
  enqueue), ``fetch.<mode>`` (the read of the packed outputs),
  ``phase.<mode>`` (dispatch start to fetch end, the ``TICK_PHASE_STATS``
  phase; modes overlap when a tick mixes them), ``core`` (each decode
  loop; lanes the padded batch; its record carries ``steps``, ``rows`` and
  ``live``) and in it ``step.launch`` (host enqueue between two reads) and
  ``step.sync`` (the read of the lanes still active); ``anchor.sync`` the
  chunked anchor's lane read;
- per lane (loop thread, ``sid`` the session): ``session.prepare`` and
  ``session.wait`` (submit to result; ``tick`` the group tick that served
  it);
- counters ``core.calls``, ``core.steps`` (decode-loop iterations),
  ``core.rows`` (padded batch x iterations), ``core.live`` (lanes still
  active at each iteration's start); ``dry.kernel`` (each launch of the
  decode step's DRY kernel, ``ops/dry.py``: ``core.steps`` when every step
  ran it); ``anchor.<reason>``; histogram
  ``sched.queue_wait`` (submit to the tick's start on the loop, every lane);
- the causal audio-LLM path (``streaming/qwen3_batch.py``,
  ``models/qwen3_asr.py``, ``models/llama.py``): spans ``causal.prime``,
  ``causal.append``, ``causal.decode`` (one per pooled op, lanes its
  sessions' rows) and ``causal.decode_step`` (one per greedy step);
  counters ``causal.decode_steps``, ``causal.decode_rows``,
  ``causal.append_rows``, ``causal.logits_rows``, and for expert layers
  ``moe.calls``, ``moe.rows``, ``moe.pairs`` (row and routed-expert pairs
  chosen), ``moe.null`` (slots the null expert took) and ``moe.hit``
  (routed experts with a row, summed over calls): the benchmark's
  ``*.causal`` readers; ``causal.graph_captures`` (each capture of the
  pooled decode step as a CUDA graph, ``streaming/qwen3_batch.py``
  ``DecodeGraphs``) and ``causal.graph_replays`` (each step that replayed
  one: ``decode_graph_share.causal``). A capture runs the step's host code
  once with its counts diverted (``Tracer.diverted``), and each replay adds
  them, so the counters read as if every step ran eagerly.

``window_summary`` reads a window's records: the share of it that no
group tick's device interval covers and which host span covered that time,
the sync-wait share, steps a tick and the lanes' queue waits.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import time
from collections.abc import MutableMapping
from typing import Dict, Iterable, List, Optional, Tuple

#: the group tick the current task or thread works for
TICK_ID: contextvars.ContextVar = contextvars.ContextVar("wlk_tick_id", default=None)

#: spans that wait on the device (the host idles in them)
SYNC_SPANS = ("step.sync", "anchor.sync")
SYNC_PREFIXES = ("fetch.",)


class Span:
    """One span record; times are ``time.perf_counter_ns()``."""

    __slots__ = ("name", "t0", "t1", "thread", "parent", "tick", "attrs")

    def __init__(self, name, t0, t1, thread, parent, tick, attrs):
        self.name, self.t0, self.t1 = name, t0, t1
        self.thread, self.parent, self.tick, self.attrs = thread, parent, tick, attrs


class _Open:
    """The context manager ``Tracer.span`` returns: aggregates on exit, and
    keeps a record on the thread's stack while the tracer is enabled. Set
    ``lanes`` or ``attrs`` inside the block."""

    __slots__ = ("tr", "name", "lanes", "attrs", "t0", "rec")

    def __init__(self, tr, name, lanes, attrs):
        self.tr, self.name, self.lanes, self.attrs, self.rec = tr, name, lanes, attrs, None

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        if self.tr.enabled:
            self.rec = self.tr._push(self.name, self.t0, self.attrs)
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.tr.add(self.name, t1 - self.t0, self.lanes)
        if self.rec is not None:
            self.tr._pop(self.rec, t1)
        return False


class View(MutableMapping):
    """The entries of one of the tracer's tables whose names start with
    ``prefix``, keyed without it."""

    def __init__(self, table: dict, prefix: str):
        self._t, self._p = table, prefix

    def __getitem__(self, k):
        return self._t[self._p + k]

    def __setitem__(self, k, v):
        self._t[self._p + k] = v

    def __delitem__(self, k):
        del self._t[self._p + k]

    def __iter__(self):
        n = len(self._p)
        return iter([k[n:] for k in list(self._t) if k.startswith(self._p)])

    def __len__(self):
        return sum(1 for k in list(self._t) if k.startswith(self._p))


class Tracer:
    def __init__(self):
        self.spans: Dict[str, Tuple[int, float, int]] = {}
        self.counters: Dict[str, int] = {}
        self.hists: Dict[str, Dict[int, int]] = {}
        self.enabled = False
        self.records: List[Span] = []
        self.clock: Optional[Tuple[int, int]] = None
        self.clock_drift_ns: Optional[int] = None
        self.last_device_ns: Optional[int] = None
        self._lock = threading.Lock()
        self._local = threading.local()
        self._sink = threading.local()  # ``diverted``'s dict, per thread
        self._ticks = itertools.count(1)
        self._ref = None  # (reference CUDA event, its perf_counter_ns, device)

    # ---- always on -------------------------------------------------------

    def add(self, name: str, dt_ns: int = 0, lanes: int = 0) -> None:
        """One span of ``dt_ns`` into ``name``'s aggregate, and no record."""
        with self._lock:
            n, tot, ln = self.spans.get(name, (0, 0.0, 0))
            self.spans[name] = (n + 1, tot + dt_ns * 1e-9, ln + lanes)

    def count(self, name: str, n: int = 1) -> None:
        sink = getattr(self._sink, "counts", None)
        if sink is not None:
            sink[name] = sink.get(name, 0) + n
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    @contextlib.contextmanager
    def diverted(self):
        """Counts made on this thread inside the block go into the dict it
        yields, not into ``counters`` (other threads count as before)."""
        prev = getattr(self._sink, "counts", None)
        counts = self._sink.counts = {}
        try:
            yield counts
        finally:
            self._sink.counts = prev

    def observe(self, name: str, seconds: float) -> None:
        """One observation into ``name``'s 1 ms bins."""
        b = int(seconds * 1e3)
        with self._lock:
            h = self.hists.setdefault(name, {})
            h[b] = h.get(b, 0) + 1

    def quantile_ms(self, name: str, q: float) -> Optional[float]:
        """The ``q`` quantile of a histogram, as its bin's lower edge in ms
        (the nearest-rank rule of ``BatchScheduler``'s reservoir)."""
        h = dict(self.hists.get(name, {}))
        n = sum(h.values())
        if not n:
            return None
        rank = min(int(q * n), n - 1)
        seen = 0
        for b in sorted(h):
            seen += h[b]
            if seen > rank:
                return float(b)
        return float(max(h))

    def reset(self) -> None:
        """Zero every aggregate (the views included); records stay."""
        with self._lock:
            self.spans.clear()
            self.counters.clear()
            self.hists.clear()

    def span(self, name: str, lanes: int = 0, **attrs) -> _Open:
        return _Open(self, name, lanes, attrs)

    def record(self, name: str, t0: int, t1: int, lanes: int = 0, tick=None,
               thread: Optional[str] = None, **attrs) -> None:
        """A span whose ends the caller measured (``perf_counter_ns``): for
        spans that cross an ``await`` or overlap others on their thread."""
        self.add(name, t1 - t0, lanes)
        if self.enabled:
            stack = getattr(self._local, "stack", None)
            self.records.append(Span(
                name, t0, t1, thread or threading.current_thread().name,
                stack[-1][0] if stack else None, TICK_ID.get() if tick is None else tick, attrs))

    def new_tick(self) -> int:
        return next(self._ticks)

    # ---- records, while enabled --------------------------------------------

    def _push(self, name, t0, attrs) -> Span:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        rec = Span(name, t0, None, threading.current_thread().name,
                   stack[-1][0] if stack else None, TICK_ID.get(), attrs)
        stack.append((len(self.records), rec))
        self.records.append(rec)
        return rec

    def _pop(self, rec: Span, t1: int) -> None:
        rec.t1 = t1
        stack = getattr(self._local, "stack", None)
        if stack and stack[-1][1] is rec:
            stack.pop()

    @staticmethod
    def _side_event(device):
        """A timing event recorded and synchronised on a stream of its own,
        so it waits for none of the work in flight on the serving stream."""
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.Stream(device))
        ev.synchronize()
        return ev

    def enable(self, device=None) -> None:
        """Start recording (the records of an earlier enable are dropped).
        On a CUDA device, record the reference event."""
        self.records = []
        self._local = threading.local()
        self._ref = None
        self.clock_drift_ns = None
        if device is not None and str(device).startswith("cuda"):
            ref = self._side_event(device)
            self._ref = (ref, time.perf_counter_ns(), device)
        self.clock = (time.perf_counter_ns(), time.time_ns())
        self.enabled = True

    def disable(self) -> List[Span]:
        """Stop recording; returns the records. On CUDA, a second event
        against the reference gives the device clock's drift from the
        host's over the recording (``clock_drift_ns``)."""
        self.enabled = False
        if self._ref is not None:
            end = self._side_event(self._ref[2])
            self.clock_drift_ns = self._device_ns(end) - time.perf_counter_ns()
        return self.records

    def to_unix_ns(self, t: int) -> int:
        """A ``perf_counter_ns`` reading on the profiler's (Unix) clock."""
        p, u = self.clock
        return t - p + u

    def _device_ns(self, event) -> int:
        ref, ref_ns, _ = self._ref
        return ref_ns + int(round(ref.elapsed_time(event) * 1e6))

    # ---- a group tick's device interval -----------------------------------

    def tick_dispatched(self) -> None:
        """At a group tick's dispatch start (its thread keeps the mark
        until ``tick_fetched``)."""
        self._local.mark = None
        if not self.enabled:
            return
        ev = None
        if self._ref is not None:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        self._local.mark = [time.perf_counter_ns(), ev, None]

    def tick_enqueued(self) -> None:
        """After the tick's last enqueue, before any fetch."""
        mark = getattr(self._local, "mark", None)
        if mark is not None and mark[1] is not None:
            import torch

            mark[2] = torch.cuda.Event(enable_timing=True)
            mark[2].record()

    def tick_fetched(self) -> None:
        """After the tick's fetch: its ``device.tick`` record (the events
        are read now, after the fetch synchronised)."""
        mark = getattr(self._local, "mark", None)
        self._local.mark = None
        if mark is None:
            return
        if mark[1] is None:
            self.record("device.tick", mark[0], time.perf_counter_ns(), thread="cuda", host=1)
            return
        t0, t1 = self._device_ns(mark[1]), self._device_ns(mark[2])
        self.last_device_ns = t1 - t0
        self.record("device.tick", t0, t1, thread="cuda")


TRACER = Tracer()

#: ``stats()``'s phases: (calls, total seconds, lanes) per phase
TICK_PHASE_STATS = View(TRACER.spans, "phase.")
#: why lanes fell off the cheap "inc" path: count per reason
ANCHOR_REASONS = View(TRACER.counters, "anchor.")


def aggregates(tracer: Tracer = TRACER) -> dict:
    """The aggregates as ``stats()`` hands them out."""
    with tracer._lock:
        spans = {k: list(v) for k, v in tracer.spans.items()}
        counters = dict(tracer.counters)
        hists = list(tracer.hists)
    return {
        "spans": spans,
        "counters": counters,
        "hists": {h: {"n": sum(tracer.hists.get(h, {}).values()),
                      "p50_ms": tracer.quantile_ms(h, 0.5),
                      "p95_ms": tracer.quantile_ms(h, 0.95)} for h in hists},
    }


def chrome_events(records: Iterable[Span], tracer: Tracer = TRACER, base_ns: int = 0) -> list:
    """The records as Chrome trace events ("X") on the profiler's clock:
    ``ts`` in microseconds after ``base_ns`` Unix nanoseconds, as
    ``torch.profiler``'s ``export_chrome_trace`` writes them."""
    out = []
    for r in records:
        if r.t1 is None:
            continue
        out.append({"ph": "X", "cat": "wlk_span", "name": r.name, "pid": "wlk spans",
                    "tid": r.thread, "ts": (tracer.to_unix_ns(r.t0) - base_ns) / 1e3,
                    "dur": (r.t1 - r.t0) / 1e3, "args": {"tick": r.tick, **r.attrs}})
    return out


# ---------------------------------------------------------------------------
# A window's records
# ---------------------------------------------------------------------------


def gaps_ns(intervals: Iterable[Tuple[int, int]], t0: int, t1: int) -> List[Tuple[int, int]]:
    """The parts of [t0, t1] outside the union of the intervals."""
    out, at = [], t0
    for a, b in sorted((max(a, t0), min(b, t1)) for a, b in intervals if b > t0 and a < t1):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < t1:
        out.append((at, t1))
    return out


def split_by_span(spans: List[Span], t0: int, t1: int) -> Dict[str, int]:
    """Nanoseconds of [t0, t1] by the innermost (shortest) of ``spans``
    open at each instant; "-" where none is."""
    spans = [r for r in spans if r.t1 is not None and r.t1 > t0 and r.t0 < t1]
    cuts = sorted({t0, t1, *(max(r.t0, t0) for r in spans), *(min(r.t1, t1) for r in spans)})
    out: Dict[str, int] = {}
    for a, b in zip(cuts, cuts[1:]):
        best = None
        for r in spans:
            if r.t0 <= a and r.t1 >= b and (best is None or r.t1 - r.t0 < best.t1 - best.t0):
                best = r
        name = best.name if best else "-"
        out[name] = out.get(name, 0) + (b - a)
    return out


def host_spans(records: Iterable[Span]) -> Dict[str, List[Span]]:
    """Each thread's finished spans that stand for host work, keyed
    ``loop`` (the thread of ``sched.gather``), ``worker`` (of
    ``sched.tick``) or the thread's name; a session's wait for its result
    is no host work and ``device.tick`` no host span, so both are left out."""
    done = [r for r in records if r.t1 is not None]
    role = {}
    for r in done:
        if r.name == "sched.gather":
            role.setdefault(r.thread, "loop")
        elif r.name == "sched.tick":
            role.setdefault(r.thread, "worker")
    out: Dict[str, List[Span]] = {}
    for r in done:
        if r.name not in ("session.wait", "device.tick"):
            out.setdefault(role.get(r.thread, r.thread), []).append(r)
    return out


def gap_label(by_thread: Dict[str, List[Span]], t0: int, t1: int) -> str:
    """``loop:<span> | worker:<span>``: on each thread, the innermost span
    that covered the most of [t0, t1] ("-": none did)."""
    parts = []
    for thread in sorted(by_thread, key=lambda t: (t != "loop", t != "worker", t)):
        split = split_by_span(by_thread[thread], t0, t1)
        parts.append(f"{thread}:{max(split, key=split.get)}")
    return " | ".join(parts)


def window_summary(records: List[Span], t0: int, t1: int) -> dict:
    """What a window [t0, t1] (``perf_counter_ns``) of records shows:

    - ``between_ticks_share``: % of the window no ``device.tick`` covers;
      ``between_by_span``: those seconds by the host span that covered them
      on the loop thread (the ``sched.gather`` thread), the innermost one;
    - ``sync_wait_share``: % of the ``sched.tick`` seconds spent in the
      sync spans (``step.sync``, ``anchor.sync``, ``fetch.*``);
    - ``lane_step_fill``: % of the decode rows computed whose lane was live
      (``core.live`` over ``core.rows``, from ``core`` records);
    - ``finish_ms``: mean ``sched.finish`` ms; ``tick_ms``: mean
      ``sched.tick`` wall ms; ``worker_cpu_share``: the worker's CPU
      seconds over its ``sched.tick`` seconds; ``steps_per_tick``;
    - ``queue_waits_ms``: each lane's wait from its submission to the start
      of the ``sched.tick`` that served it, for ticks that started in the
      window.

    Spans count when they start inside the window; device intervals are
    clipped to it."""
    w = max(1, t1 - t0)
    done = [r for r in records if r.t1 is not None]
    inside = [r for r in done if t0 <= r.t0 < t1]
    dev = [(r.t0, r.t1) for r in done if r.name == "device.tick"]
    between = gaps_ns(dev, t0, t1)
    loop = host_spans(done).get("loop", [])
    by_span: Dict[str, float] = {}
    for a, b in between:
        for name, ns in split_by_span(loop, a, b).items():
            by_span[name] = by_span.get(name, 0.0) + ns * 1e-9
    ticks = [r for r in inside if r.name == "sched.tick"]
    tick_s = sum(r.t1 - r.t0 for r in ticks) * 1e-9
    sync_s = sum(r.t1 - r.t0 for r in inside
                 if r.name in SYNC_SPANS or r.name.startswith(SYNC_PREFIXES)) * 1e-9
    cores = [r for r in inside if r.name == "core"]
    rows = sum(r.attrs.get("rows", 0) for r in cores)
    finish = [r for r in inside if r.name == "sched.finish"]
    start_of = {r.tick: r.t0 for r in done if r.name == "sched.tick"}
    waits = [(start_of[r.tick] - r.t0) * 1e-6 for r in done
             if r.name == "session.wait" and t0 <= start_of.get(r.tick, -1) < t1]
    return {
        "between_ticks_share": 100.0 * sum(b - a for a, b in between) / w if dev else None,
        "between_by_span": by_span,
        "sync_wait_share": 100.0 * sync_s / tick_s if tick_s else None,
        "lane_step_fill": 100.0 * sum(r.attrs.get("live", 0) for r in cores) / rows if rows else None,
        "finish_ms": 1e3 * sum(r.t1 - r.t0 for r in finish) * 1e-9 / len(finish) if finish else None,
        "tick_ms": 1e3 * tick_s / len(ticks) if ticks else None,
        "worker_cpu_share": (100.0 * sum(r.attrs.get("cpu_ns", 0) for r in ticks) * 1e-9 / tick_s
                             if tick_s else None),
        "steps_per_tick": sum(r.attrs.get("steps", 0) for r in cores) / len(ticks) if ticks else None,
        "queue_waits_ms": waits,
    }
