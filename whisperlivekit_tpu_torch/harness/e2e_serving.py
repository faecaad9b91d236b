"""End-to-end serving benchmark of the port: N live real-time sessions on one card.

    python -m whisperlivekit_tpu_torch.harness.e2e_serving --n 48 64 --duration 60 [--out FILE]

Port of the repository's ``scripts/bench_e2e_serving.py``. Where the
capacity sweep (``harness/capacity.py``) models the device tick (pinned
decode steps, gates off, no host plane), this drives N concurrent sessions
through the product path: TestHarness -> AudioProcessor (VAD, silence
state machine, watermarks) -> BatchScheduler (EDF admission, lane groups,
pooled cross-KV cache) -> AlignAtt ticks -> host policy -> TokensAlignment
-> FrontData, with audio fed at speed 1.0, and reports what a client would
see:

- ``word_emission_p50/p95_ms``: wall-clock delay from the moment the audio
  containing a word has been fed to the moment the word is visible in the
  committed transcript (the policy's hold-back, scheduler queueing, device
  time and host formatting);
- ``keep_up``: the emission lag in the last third of the run exceeds the
  middle third's by at most ``--drift-tolerance``;
- the scheduler's counters (queue wait, lanes a tick, backlog, failed
  ticks, tick phases) from ``BatchScheduler.stats()``.

The summary line carries the JAX script's keys plus ``device`` (the
card's name and power limit) and ``vad`` (the VAD that served: with
``vad_backend="auto"`` the host Silero model when ``silero_vad.jit`` is in
``WLK_TPU_ASSET_DIR``, else the energy VAD). Weights are random; the
tokenizer must be found (``harness/vocab.py`` writes a stand-in). Priming:
a 2-session run builds the engine first; its scheduler's warm pass runs in
the constructor (the JAX script joins a compile thread instead).
``main(argv, device="cpu")`` runs on the CPU (tests); without ``device``
the engine serves on the card. Imports no JAX.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time
from pathlib import Path

import numpy as np

SR = 16000
CHUNK_S = 0.5


def speech_like(seconds: float, seed: int = 0, t0: float = 0.0) -> np.ndarray:
    """Formant-synthesized pseudo-speech: glottal sawtooth with prosody/
    vibrato pitch contour, three time-varying formant resonators, and a
    syllable-rate voiced/gap envelope. All phases are analytic functions of
    absolute time ``t0`` and the 20 ms filter frames reset per frame, so
    successive chunks of one session stitch continuously as long as chunks
    are multiples of 20 ms."""
    from scipy import signal

    rng = np.random.default_rng(seed)
    ph = rng.uniform(0, 2 * np.pi, 6)
    n = int(SR * seconds)
    t = t0 + np.arange(n) / SR
    base = 105 + 6 * (seed % 5)
    # analytic pitch-phase integral: f0 = base + 15 sin(2π·0.31 t) + 4 sin(2π·5.1 t)
    integ = (
        base * t
        - 15 / (2 * np.pi * 0.31) * np.cos(2 * np.pi * 0.31 * t + ph[0])
        - 4 / (2 * np.pi * 5.1) * np.cos(2 * np.pi * 5.1 * t + ph[1])
    )
    src = signal.sawtooth(2 * np.pi * integ + ph[2], width=0.9)
    vow = 0.5 + 0.5 * np.sin(2 * np.pi * 0.9 * t + ph[3])
    F1 = 350 + 450 * vow
    F2 = 900 + 900 * (1 - vow)
    F3 = 2500 + 200 * vow
    out = np.zeros(n)
    frame = int(0.02 * SR)
    for i in range(0, n, frame):
        y = src[i : i + frame]
        for F, bw in ((F1[i], 80.0), (F2[i], 120.0), (F3[i], 160.0)):
            r = np.exp(-np.pi * bw / SR)
            th = 2 * np.pi * F / SR
            y = signal.lfilter([1 - r], [1, -2 * r * np.cos(th), r * r], y)
        out[i : i + frame] = y
    env = np.clip(1.5 * np.sin(2 * np.pi * 2.3 * t + ph[4]), 0, 1) ** 0.5
    out = out * env * 50.0  # fixed gain ≈ 0.3 peak (chunk-independent)
    out += 0.008 * np.random.default_rng((seed, int(round(t0 * SR)))).standard_normal(n)
    return out.astype(np.float32)


class SessionProbe:
    """Per-session observer: emission latency of the committed frontier."""

    def __init__(self):
        self.t0 = None          # wall clock when feeding started
        self.rejected = False   # admission control turned the session away
        self.committed_end = 0.0
        self.samples = []       # (audio_end_s, emission_latency_s)
        self.proc_lag = []      # (audio_pos, remaining_time_transcription)
        self.n_infer_calls = 0
        self.mean_infer_s = None

    def on_update(self, st) -> None:
        if self.t0 is None:
            return
        now = time.monotonic()
        ends = [t["end"] for t in st.timestamps]
        end = max(ends) if ends else 0.0
        if end > self.committed_end:
            # the word ending at audio-time `end` was fed at t0 + end
            self.samples.append((end, (now - self.t0) - end))
            self.committed_end = end
        self.proc_lag.append((st.audio_position, st.remaining_time_transcription))


async def drive_session(idx, engine_kwargs, duration, stagger_s, warm_s,
                        shakeout_s, probe, barrier, started):
    from ..engine.core import EngineAtCapacity
    from .harness import TestHarness

    try:
        ctx = TestHarness(**engine_kwargs)
        entered = await ctx.__aenter__()
    except EngineAtCapacity:
        # the product's admission control rejected this session; count it
        probe.rejected = True
        await barrier.wait()
        started.set()
        return
    try:
        await _drive_admitted(entered, idx, duration, stagger_s, warm_s,
                              shakeout_s, probe, barrier, started)
    finally:
        await ctx.__aexit__(None, None, None)


async def _drive_admitted(h, idx, duration, stagger_s, warm_s, shakeout_s,
                          probe, barrier, started):
    h.on_update(probe.on_update)
    # warm phase: pour `warm_s` seconds of audio instantly, then hold at the
    # barrier until every session's tick has run at least once
    if warm_s > 0:
        await h.feed_audio(speech_like(warm_s, seed=idx), speed=0)
        deadline = time.monotonic() + 600
        while (h.metrics.n_transcription_calls < 1
               and time.monotonic() < deadline):
            await asyncio.sleep(0.25)
    await barrier.wait()
    started.set()
    await asyncio.sleep((idx % 16) * stagger_s / 16)
    # the shakeout prefix of the real-time feed is discarded by the
    # measurement cut in run_once
    probe.t0 = time.monotonic() - (warm_s if warm_s > 0 else 0.0)
    t = warm_s
    deadline = time.monotonic() + shakeout_s + duration
    while time.monotonic() < deadline:
        await h.feed_audio(speech_like(CHUNK_S, seed=idx, t0=t), speed=0)
        t += CHUNK_S
        # real-time pacing against the session clock (feed_audio's own sleep
        # would drift under host load; an absolute schedule does not)
        target = probe.t0 + t
        delay = target - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
    await h.finish(timeout=30)
    probe.n_infer_calls = h.metrics.n_transcription_calls
    mean_ms = h.metrics.transcription_durations.mean_ms  # CallTimes ring
    probe.mean_infer_s = mean_ms / 1e3 if mean_ms else None


def _quant(xs, q):
    if not xs:
        return None
    s = sorted(xs)
    return s[min(int(q * len(s)), len(s) - 1)]


def _scheduler():
    from .harness import _engine_cache

    for eng in _engine_cache.values():
        s = getattr(eng, "scheduler", None)
        if s is not None and hasattr(s, "stats"):
            return s
    return None


async def run_once(n, duration, engine_kwargs, stagger_s, warm_s, shakeout_s,
                   drift_tol):
    async def reset_after_shakeout(started):
        await started.wait()
        await asyncio.sleep(shakeout_s + stagger_s)
        s = _scheduler()
        if s is not None and hasattr(s, "reset_stats"):
            s.reset_stats()

    probes = [SessionProbe() for _ in range(n)]
    barrier = asyncio.Barrier(n)
    started = asyncio.Event()
    t_start = time.monotonic()
    await asyncio.gather(*(
        [drive_session(i, engine_kwargs, duration, stagger_s, warm_s,
                       shakeout_s, probes[i], barrier, started)
         for i in range(n)]
        + [reset_after_shakeout(started)]
    ))
    wall = time.monotonic() - t_start

    # measurement window: the timed `duration` after warm pour + shakeout
    cut = warm_s + shakeout_s
    lats = [
        lat for p in probes for (end, lat) in p.samples if end >= cut
    ]

    # keep-up: emission lag must be flat over the run, not growing
    def window(lo, hi):
        return [
            lat for p in probes for (end, lat) in p.samples
            if lo <= end - cut < hi
        ]
    mid = _quant(window(duration / 3, 2 * duration / 3), 0.5)
    late = _quant(window(2 * duration / 3, duration), 0.5)
    keep_up = (
        mid is not None and late is not None and late - mid <= drift_tol
    )
    emitted = len(lats)
    rejected = sum(1 for p in probes if p.rejected)
    starved = sum(
        1 for p in probes
        if not p.rejected and not any(end >= cut for (end, _) in p.samples)
    )

    s = _scheduler()
    sched = s.stats() if s is not None else None
    return {
        "n_sessions": n,
        "n_admitted": n - rejected,
        "n_rejected": rejected,
        "duration_s": duration,
        "wall_s": round(wall, 1),
        "keep_up": keep_up,
        "word_emission_p50_ms": _ms(_quant(lats, 0.5)),
        "word_emission_p95_ms": _ms(_quant(lats, 0.95)),
        "emission_lag_mid_p50_ms": _ms(mid),
        "emission_lag_late_p50_ms": _ms(late),
        "n_frontier_advances": emitted,
        "n_sessions_without_output": starved,
        "infer_calls_per_session": round(
            float(np.mean([p.n_infer_calls for p in probes])), 1
        ),
        "mean_infer_ms": _ms(float(np.mean(
            [p.mean_infer_s for p in probes if p.mean_infer_s is not None]
        )) if any(p.mean_infer_s is not None for p in probes) else None),
        "scheduler": sched,
    }


def _ms(v):
    return round(v * 1e3, 1) if v is not None else None


def summarize(args, results: list, device_label: str, vad: str) -> dict:
    """The summary line: the sustained counts over the runs, the card and
    the VAD that served."""
    sustained = [r["n_admitted"] for r in results if r["keep_up"]
                 and not r["n_sessions_without_output"]]
    # keep_up is a drift criterion; the latency-honest count also needs the
    # session-clock word-emission p50 within the 500 ms clause
    rt = [r["n_admitted"] for r in results if r["keep_up"]
          and not r["n_sessions_without_output"]
          and r["word_emission_p50_ms"] <= 500.0]
    return {
        "model": args.model,
        "xkv_dtype": args.xkv_dtype,
        "decoder_dtype": args.decoder_dtype,
        "max_steps": args.max_steps,
        "anchor_cohorts": args.anchor_cohorts,
        "commit_budget": args.commit_budget,
        "max_sustained_streams": max(sustained) if sustained else 0,
        "max_sustained_streams_at_500ms_p50": max(rt) if rt else 0,
        "device": device_label,
        "vad": vad,
        "runs": results,
    }


def served_vad(engine) -> str:
    """Which VAD an engine serves: the batched scheduler, the host model's
    class, or "off"."""
    if getattr(engine, "vad_scheduler", None) is not None:
        return type(engine.vad_scheduler).__name__
    model = getattr(engine, "vac_model", None)
    return type(model).__name__ if model is not None else "off"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[64])
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--model", default="random:large-v3")
    ap.add_argument("--model-path", default=None,
                    help="checkpoint (OpenAI .pt, HF directory or the port's native "
                    "directory, e.g. harness/train_structured.py --out-native): "
                    "overrides --model's random init")
    ap.add_argument("--xkv-dtype", default="f8", choices=["bf16", "f8"])
    ap.add_argument("--policy", default="simulstreaming")
    ap.add_argument("--stagger", type=float, default=8.0,
                    help="spread session starts over this many seconds")
    ap.add_argument("--warm", type=float, default=20.0,
                    help="seconds of audio poured instantly before timing")
    ap.add_argument("--shakeout", type=float, default=30.0,
                    help="untimed real-time seconds before the measured window")
    ap.add_argument("--drift-tolerance", type=float, default=1.0,
                    help="allowed p50 lag growth (s) between run thirds")
    ap.add_argument("--frame-threshold", type=int, default=1,
                    help="AlignAtt attention gate headroom. Default 1 "
                    "(permissive): with RANDOM weights the alignment "
                    "attention is noise and the production gate (25) holds "
                    "back nearly every word; 1 yields a word flux through the "
                    "same code path. With real weights, use 25.")
    ap.add_argument("--no-vac", action="store_true",
                    help="disable the VAD front-end (isolation experiments)")
    ap.add_argument("--max-steps", type=int, default=8,
                    help="per-tick decode budget (= the product default); "
                    "32 for an adversarial worst-case row")
    ap.add_argument("--decoder-dtype", default="bf16", choices=["bf16", "f8"],
                    help="weight-only f8 decoder storage")
    ap.add_argument("--max-sessions", type=int, default=0,
                    help="admission cap override (0 = product auto); rejected "
                    "sessions are reported")
    ap.add_argument("--anchor-cohorts", type=int, default=None,
                    help="xkv_anchor_cohorts override: stagger group "
                    "re-anchors over N sub-epochs")
    ap.add_argument("--commit-budget", type=int, default=None,
                    help="serving_commit_budget override (extra self-KV "
                    "pool rows past the prefix cap)")
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def engine_kwargs_for(args, device=None) -> dict:
    kw = dict(
        model_size=args.model,
        **({"model_path": args.model_path} if args.model_path else {}),
        lan="en",
        backend_policy=args.policy,
        vac=not args.no_vac,
        scheduler=True,
        xkv_cache_dtype=args.xkv_dtype,
        frame_threshold=args.frame_threshold,
        max_decode_steps=args.max_steps,
        decoder_dtype=args.decoder_dtype,
        max_sessions=args.max_sessions,
        log_level="WARNING",
    )
    if args.anchor_cohorts is not None:
        kw["xkv_anchor_cohorts"] = args.anchor_cohorts
    if args.commit_budget is not None:
        kw["serving_commit_budget"] = args.commit_budget
    if device is not None:
        kw["device"] = device
    return kw


def run(argv=None, device=None) -> dict:
    """Prime, run each ``--n``, print each run's line and the summary line;
    returns the summary."""
    from .capacity import card_label
    from .harness import _cache_key, _engine_cache

    args = parse_args(argv)
    engine_kwargs = engine_kwargs_for(args, device)
    # prime: a tiny throwaway run builds the (cached) engine; the large
    # form's scheduler runs its warm pass in its constructor, so no measured
    # window below starts with a kernel build
    print("[e2e] priming engine ...", flush=True)
    asyncio.run(run_once(2, 5.0, engine_kwargs, 0.0, 5.0, 5.0,
                         args.drift_tolerance))
    print("[e2e] priming done", flush=True)

    results = []
    for n in args.n:
        print(f"[e2e] n={n} duration={args.duration}s ...", flush=True)
        res = asyncio.run(run_once(
            n, args.duration, engine_kwargs, args.stagger, args.warm,
            args.shakeout, args.drift_tolerance,
        ))
        results.append(res)
        print(json.dumps(res), flush=True)

    engine = _engine_cache[_cache_key(dict(engine_kwargs, pcm_input=True))]
    summary = summarize(args, results, card_label(engine.device), served_vad(engine))
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(summary, indent=2) + "\n")
    return summary


def main(argv=None, device=None) -> int:
    run(argv, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
