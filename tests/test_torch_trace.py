"""The port's tracer (whisperlivekit_tpu_torch/engine/trace.py) on the CPU:

- with tracing off, a tiny scheduler run (dev-tiny, the large form, two
  sessions through ``SimulStreamingOnlineProcessor`` and ``BatchScheduler``)
  makes no span record, and its ``TICK_PHASE_STATS`` keys, call counts and
  lanes and its ``ANCHOR_REASONS`` are what the same run gave before the
  tracer (the tables below);
- with tracing on, the spans of a group tick carry one tick id on the loop
  and the worker thread, nest under ``sched.tick`` on the worker, and each
  lane's ``session.wait`` carries the id of the tick that served it; off
  CUDA a tick's ``device.tick`` falls back to its host interval;
- a ``torch.profiler`` CPU trace's ``record_function`` marker inside a span
  lands inside that span on the shared clock, and ``profile_dir``'s trace
  holds the spans (``tests/test_torch_bench.py``);
- the new benchmark readers (loaded by path, as ``benchmark/run.py`` loads
  them) on hand-built ``stats()``, and ``window_summary`` on hand-built
  records: overlapping device intervals, a window edge cutting one, the
  between-tick time split by host span, the queue waits.
"""

import asyncio
import importlib.util
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from whisperlivekit_tpu_torch.engine import trace as T
from whisperlivekit_tpu_torch.harness.vocab import write_standin_vocab
from whisperlivekit_tpu_torch.models.whisper import model as TM
from whisperlivekit_tpu_torch.models.whisper.dims import MODEL_DIMS
from whisperlivekit_tpu_torch.models.whisper.tokenizer import get_tokenizer
from whisperlivekit_tpu_torch.streaming import alignatt as TA

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

REPO = Path(__file__).resolve().parent.parent
DIMS = MODEL_DIMS["dev-tiny"]
CFG = dict(language="en", max_steps=4, audio_max_len=16.0, enc_tail_frames=384,
           enc_rewrite_margin=16, xkv_cache=True)
ROUNDS = 12

# the run below before the tracer existed: (calls, lanes) per phase, and
# the anchor reasons (three epochs, each anchoring both lanes)
PHASES_BEFORE = {"pool_update": (12, 24), "anchor_xkv": (3, 6), "inc_xkv": (9, 18)}
REASONS_BEFORE = {"evict_or_reset": 6}


def chunk(seed, seconds=1.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    return (0.3 * np.sin(2 * np.pi * (150 + 35 * seed) * t)
            + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    path = write_standin_vocab(tmp_path_factory.mktemp("vocab"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WLK_TPU_ASSET_DIR", str(path.parent))
        tok = get_tokenizer(True, language="en", task="transcribe")
    model = TM.init_params(DIMS, torch.Generator().manual_seed(0))
    return TA.AlignAttEngine(model, DIMS, tok, TA.AlignAttConfig(**CFG))


def tiny_run(engine):
    """Two sessions, ROUNDS rounds of 1 s each through the scheduler; both
    sessions' ticks of a round join one group tick. Returns the scheduler."""
    from whisperlivekit_tpu_torch.engine.scheduler import BatchScheduler
    from whisperlivekit_tpu_torch.streaming.simul_processor import SimulStreamingOnlineProcessor

    sched = BatchScheduler(engine, max_lanes=2, window_s=0.01)
    procs = [SimulStreamingOnlineProcessor(engine, scheduler=sched) for _ in range(2)]

    async def main():
        for r in range(ROUNDS):
            for i, p in enumerate(procs):
                p.insert_audio_chunk(chunk(10 * r + i), float(r + 1))
            await asyncio.gather(*(p.process_iter_async() for p in procs))
        sched._task.cancel()

    asyncio.run(main())
    return sched


def test_tracing_off_records_nothing_and_keeps_the_phase_stats(engine):
    T.TRACER.disable()
    T.TRACER.records = []
    sched = tiny_run(engine)
    assert T.TRACER.records == [] and not T.TRACER.enabled
    phases = {k: (v[0], v[2]) for k, v in TA.TICK_PHASE_STATS.items()}
    assert phases == PHASES_BEFORE
    assert all(isinstance(v, tuple) and len(v) == 3 for v in TA.TICK_PHASE_STATS.values())
    assert dict(TA.ANCHOR_REASONS) == REASONS_BEFORE
    st = sched.stats()
    assert st["n_ticks"] == ROUNDS
    assert {k: (v["n"], round(v["mean_lanes"] * v["n"])) for k, v in st["tick_phases"].items()} == PHASES_BEFORE
    # the always-on aggregates: one gather, tick and finish a group tick,
    # a decode loop a program call, every lane's wait and queue wait
    spans, counters = st["trace"]["spans"], st["trace"]["counters"]
    assert [spans[k][0] for k in ("sched.gather", "sched.tick", "sched.finish")] == [ROUNDS] * 3
    assert spans["session.wait"][0] == spans["session.prepare"][0] == 2 * ROUNDS
    assert spans["core"][0] == ROUNDS and spans["core"][2] == 2 * ROUNDS  # B = 2 lanes a group
    assert counters["core.rows"] == 2 * counters["core.steps"]
    assert 0 < counters["core.live"] <= counters["core.rows"]
    assert st["trace"]["hists"]["sched.queue_wait"]["n"] == 2 * ROUNDS
    assert spans["step.sync"][0] >= ROUNDS and "device.tick" not in spans
    sched.reset_stats()
    assert not TA.TICK_PHASE_STATS and not sched.stats()["trace"]["spans"]


def test_spans_nest_under_one_tick_across_threads(engine):
    T.TRACER.enable(engine.device)
    try:
        tiny_run(engine)
    finally:
        recs = T.TRACER.disable()
    by = {}
    for r in recs:
        by.setdefault(r.name, []).append(r)
    ticks = {r.tick: r for r in by["sched.tick"]}
    assert len(ticks) == ROUNDS and None not in ticks
    loop = {r.thread for r in by["sched.gather"] + by["sched.finish"]}
    worker = {r.thread for r in by["sched.tick"]}
    assert len(loop) == 1 and loop != worker and loop == {threading.main_thread().name}
    for name in ("sched.gather", "sched.finish"):
        assert sorted(r.tick for r in by[name]) == sorted(ticks)
    # every span the worker made is inside its tick's sched.tick span
    for r in recs:
        if r.thread in worker and r.name != "sched.tick":
            t = ticks[r.tick]
            assert t.t0 <= r.t0 <= r.t1 <= t.t1, r.name
    for r in by["step.sync"] + by["dispatch.inc_xkv"] + by["fetch.inc_xkv"] + by["phase.pool_update"]:
        assert recs[r.parent].tick == r.tick
    assert {recs[r.parent].name for r in by["phase.pool_update"]} == {"sched.tick"}
    # each lane's wait carries the tick that served it: two lanes a tick
    waits = by["session.wait"]
    assert sorted(r.tick for r in waits) == sorted(list(ticks) * 2)
    for r in waits:
        assert r.t0 <= ticks[r.tick].t0 and r.t1 >= ticks[r.tick].t1 and r.thread in loop
    assert len(by["session.prepare"]) == 2 * ROUNDS
    # off CUDA a tick's device interval is its host interval, inside sched.tick
    assert len(by["device.tick"]) == ROUNDS
    for r in by["device.tick"]:
        assert r.attrs == {"host": 1} and r.thread == "cuda"
        assert ticks[r.tick].t0 <= r.t0 <= r.t1 <= ticks[r.tick].t1
    for r in by["sched.tick"]:
        assert 0 < r.attrs["cpu_ns"] <= (r.t1 - r.t0) * 1.05 + 1e6
    cores = by["core"]
    assert all(c.attrs["rows"] == 2 * c.attrs["steps"] and c.attrs["live"] <= c.attrs["rows"] for c in cores)
    s = T.window_summary(recs, min(r.t0 for r in recs), max(r.t1 for r in recs))
    assert 0 < s["between_ticks_share"] < 100 and s["steps_per_tick"] > 0
    assert len(s["queue_waits_ms"]) == 2 * ROUNDS and min(s["queue_waits_ms"]) >= 0
    assert 0 < s["lane_step_fill"] <= 100 and 0 <= s["sync_wait_share"] <= 100


def test_profiler_marker_lands_inside_its_span():
    T.TRACER.enable()
    try:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
        prof.start()
        with T.TRACER.span("outer"):
            time.sleep(0.002)
            with torch.autograd.profiler.record_function("wlk_marker"):
                torch.ones(64).sum()
            time.sleep(0.002)
        prof.stop()
    finally:
        recs = T.TRACER.disable()
    (span,) = [r for r in recs if r.name == "outer"]
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "wlk_marker"]
    lo, hi = T.TRACER.to_unix_ns(span.t0), T.TRACER.to_unix_ns(span.t1)
    assert lo <= ev.start_ns() and ev.start_ns() + ev.duration_ns() <= hi
    (chrome,) = T.chrome_events(recs, base_ns=lo - 1000)
    assert chrome["name"] == "outer" and chrome["ts"] == pytest.approx(1.0)


def test_views_keep_the_dict_interface():
    tr = T.Tracer()
    phases, reasons = T.View(tr.spans, "phase."), T.View(tr.counters, "anchor.")
    tr.add("phase.inc", 2_000_000, lanes=3)
    tr.add("phase.inc", 1_000_000, lanes=1)
    tr.add("sched.tick", 5)
    tr.count("anchor.unsynced")
    tr.count("core.steps", 4)
    assert dict(phases) == {"inc": (2, pytest.approx(3e-3), 4)}
    assert phases.get("anchor", (0, 0.0, 0)) == (0, 0.0, 0) and "inc" in phases and len(phases) == 1
    assert dict(reasons) == {"unsynced": 1}
    phases.clear()
    assert not phases and "sched.tick" in tr.spans and tr.counters["core.steps"] == 4
    for w in (0.0004, 0.0101, 0.0102, 0.25):
        tr.observe("q", w)
    assert tr.quantile_ms("q", 0.5) == 10.0 and tr.quantile_ms("q", 0.95) == 250.0
    tr.reset()
    assert not tr.spans and not tr.counters and tr.quantile_ms("q", 0.5) is None


def _reader(name):
    path = REPO / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _stats_ctx(trace):
    return SimpleNamespace(window=SimpleNamespace(stats={"n_ticks": 4, **({"trace": trace} if trace else {})}))


TRACE_STATS = {
    "spans": {"sched.tick": [4, 2.0, 256], "sched.finish": [4, 0.1, 256], "step.sync": [40, 0.5, 0],
              "anchor.sync": [1, 0.1, 0], "fetch.inc_xkv": [4, 0.2, 256], "fetch.anchor_xkv": [1, 0.2, 8],
              "dispatch.inc_xkv": [4, 1.0, 256]},
    "counters": {"core.steps": 30, "core.rows": 1920, "core.live": 480},
    "hists": {"sched.queue_wait": {"n": 256, "p50_ms": 310.0, "p95_ms": 522.0}},
}


@pytest.mark.parametrize("name, want", [
    ("finish_ms.closed", 25.0),
    ("tick_sync_wait_share.closed", 50.0),
    ("lane_step_fill.closed", 25.0),
    ("queue_wait_p95_ms.live", 522.0),
])
def test_readers_on_hand_built_stats(name, want):
    read = _reader(name)
    assert read(_stats_ctx(TRACE_STATS)) == pytest.approx(want)
    # a program without the tracer (the parent's stats) reads nothing
    assert read(_stats_ctx(None)) is None
    empty = {"spans": {}, "counters": {}, "hists": {}}
    assert read(_stats_ctx(empty)) is None


def _span(name, t0, t1, thread="loop-t", tick=None, **attrs):
    return T.Span(name, t0, t1, thread, None, tick, attrs)


def test_window_summary_arithmetic():
    ms = 1_000_000
    recs = [
        # device intervals: two overlap, one is cut by the window's start
        _span("device.tick", -5 * ms, 10 * ms, "cuda", 1),
        _span("device.tick", 30 * ms, 50 * ms, "cuda", 2),
        _span("device.tick", 40 * ms, 60 * ms, "cuda", 3),
        _span("device.tick", 95 * ms, 130 * ms, "cuda", 4),
        # the loop thread between them: a gather, a finish inside a longer
        # gather, nothing from 60 to 70
        _span("sched.gather", 10 * ms, 30 * ms, tick=2, lanes=2, carried=0),
        _span("sched.finish", 12 * ms, 14 * ms, tick=1),
        _span("session.prepare", 70 * ms, 80 * ms),
        _span("session.wait", 0, 95 * ms, tick=2),  # not host work: not a label
        _span("sched.tick", 30 * ms, 62 * ms, "worker-t", 2, cpu_ns=16 * ms),
        _span("sched.tick", 95 * ms, 131 * ms, "worker-t", 4, cpu_ns=9 * ms),
        _span("step.sync", 35 * ms, 43 * ms, "worker-t", 2),
        _span("fetch.inc_xkv", 55 * ms, 60 * ms, "worker-t", 2),
        _span("core", 31 * ms, 54 * ms, "worker-t", 2, steps=3, rows=6, live=4),
        _span("session.wait", 20 * ms, 70 * ms, tick=2),
        _span("session.wait", 80 * ms, 140 * ms, tick=4),
        _span("session.wait", 90 * ms, 140 * ms, tick=5),  # its tick never started
    ]
    s = T.window_summary(recs, 0, 100 * ms)
    # covered: [0,10] + [30,60] + [95,100] = 45 of 100 ms
    assert s["between_ticks_share"] == pytest.approx(55.0)
    # the 55 ms between ticks: [10,30] gather but [12,14] finish, [60,70]
    # none, [70,80] prepare, [80,95] none
    assert s["between_by_span"] == pytest.approx({"sched.gather": 0.018, "sched.finish": 0.002,
                                                  "-": 0.025, "session.prepare": 0.010})
    assert s["sync_wait_share"] == pytest.approx(100.0 * 13 / 68)
    assert s["lane_step_fill"] == pytest.approx(100.0 * 4 / 6)
    assert s["tick_ms"] == pytest.approx(34.0) and s["finish_ms"] == pytest.approx(2.0)
    assert s["worker_cpu_share"] == pytest.approx(100.0 * 25 / 68)
    assert s["steps_per_tick"] == pytest.approx(1.5)
    assert sorted(s["queue_waits_ms"]) == pytest.approx([10.0, 15.0, 30.0])
    assert T.gap_label(T.host_spans(recs), 65 * ms, 80 * ms) == "loop:session.prepare | worker:-"
    assert T.gap_label(T.host_spans(recs), 50 * ms, 64 * ms) == "loop:- | worker:fetch.inc_xkv"
    assert T.gaps_ns([(0, 10), (5, 20), (30, 40)], 8, 45) == [(20, 30), (40, 45)]
