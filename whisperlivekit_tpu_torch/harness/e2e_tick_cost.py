"""Cost of the serving tick by phase: host prepare, the tick call, host finish.

    python -m whisperlivekit_tpu_torch.harness.e2e_tick_cost --n 24 --ticks 40 [--model large-v3]
        [--xkv-dtype f8] [--out FILE]

Port of the repository's ``scripts/probe_e2e_tick_cost.py``. The capacity
sweep (``harness/capacity.py``) times the bare tick programs; the e2e
benchmark (``harness/e2e_serving.py``) sees whole serving ticks. This
drives ``run_tick_batch`` as ``BatchScheduler`` does, N sessions wired to
its audio, encoder-row and cross-KV pools, 1 s of ``speech_like`` audio
per session per tick, and prints each tick's wall time split three ways:

- ``prepare_ms``: synthesizing the sessions' audio and ``prepare_tick``
  (host);
- ``tick_wall_ms``: the host's wall clock around ``run_tick_batch``,
  which ends with the read of the packed outputs, so it holds the
  launches, the device's work and that read (the JAX script's
  ``device_ms``);
- ``tick_device_ms``: from the tracer's CUDA events (``engine/trace.py``),
  the tick's dispatch start to the end of the device work it enqueued;
  null off CUDA;
- ``finish_ms``: ``finish_tick``, the host policy.

The summary's percentiles and means skip the first five ticks (warm-up).
``phases`` is the dispatch's ``TICK_PHASE_STATS`` (calls and total ms per
program) over the whole run.

Differences from the JAX script: its ``BatchScheduler(engine,
inline=True)`` has no counterpart (the port's scheduler has no inline
mode), so the scheduler is constructed and its loop never started; on
CUDA the large form's constructor runs the serving programs' warm pass
(``precompile_serving_programs``), which is timed apart and printed on its
own line (``warm_pass_s``); the tracer records while the ticks run, for
``tick_device_ms``. The summary's ``tick_wall_ms_*`` are the script's
``device_ms_*``; it adds ``tick_device_ms_p50`` and ``device`` (the card's
name and power limit). Weights: ``harness/ab_inc_exact.py``'s ``build_engine``
(random bf16 from a seed, published alignment heads).
``main(argv, device="cpu")`` (or ``run``, which returns the rows and the
summary) runs on the CPU (tests); without ``device`` it needs CUDA.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--ticks", type=int, default=40)
    ap.add_argument("--model", default="large-v3")
    ap.add_argument("--xkv-dtype", default="f8")
    ap.add_argument("--out", default=None)
    return ap


def run(argv=None, device=None) -> dict:
    """Run the probe; prints the warm pass's line, one line a tick and the
    summary line; returns ``{"rows", "summary", "warm_pass_s"}``."""
    from ..engine.scheduler import BatchScheduler
    from ..engine.trace import TRACER
    from ..streaming import alignatt as A
    from .ab_inc_exact import build_engine
    from .capacity import card_label
    from .e2e_serving import speech_like

    args = build_parser().parse_args(argv)
    engine = build_engine(args.model, 1, args.xkv_dtype, device=device)
    # the scheduler ONLY for its pool wiring (its loop is never started)
    t = time.perf_counter()
    sched = BatchScheduler(engine)
    warm_s = time.perf_counter() - t
    print(json.dumps({"warm_pass_s": round(warm_s, 3), "warm_times": sched.warm_times}), flush=True)
    sessions = []
    for _ in range(args.n):
        s = A.AlignAttSession(engine)
        s.pool = sched.pool
        s.enc_pool = sched.enc_pool
        s.xkv_alloc = sched.xkv
        sessions.append(s)

    tok = engine.tokenizer
    rows = []
    TRACER.enable(engine.device)
    for i in range(args.ticks):
        t0 = time.perf_counter()
        tis, live = [], []
        for j, s in enumerate(sessions):
            s.insert_audio(speech_like(1.0, seed=j, t0=float(i)))
            ti = s.prepare_tick(False)
            if ti is not None:
                tis.append(ti)
                live.append(s)
        t1 = time.perf_counter()
        if not tis:
            continue
        TRACER.last_device_ns = None
        outs = A.run_tick_batch(engine, tis, tok, pool=sched.pool, enc_pool=sched.enc_pool, xkv=sched.xkv)
        t2 = time.perf_counter()
        dev_ns = TRACER.last_device_ns
        for s, ti, o in zip(live, tis, outs):
            s.finish_tick(ti, o)
        t3 = time.perf_counter()
        modes = {}
        for ti in tis:
            k = ti.enc_mode or "legacy"
            if ti.xkv_slot is not None:
                k += "_xkv"
            modes[k] = modes.get(k, 0) + 1
        row = {
            "tick": i, "lanes": len(tis), "modes": modes,
            "prepare_ms": round((t1 - t0) * 1e3, 1),
            "tick_wall_ms": round((t2 - t1) * 1e3, 1),
            "tick_device_ms": round(dev_ns * 1e-6, 1) if dev_ns is not None else None,
            "finish_ms": round((t3 - t2) * 1e3, 1),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    TRACER.disable()
    wall = sorted(r["tick_wall_ms"] for r in rows[5:])
    dev = sorted(r["tick_device_ms"] for r in rows[5:] if r["tick_device_ms"] is not None)
    warm = len(rows) > 5
    summary = {
        "n": args.n, "model": args.model,
        "tick_wall_ms_p50": wall[len(wall) // 2] if wall else None,
        "tick_wall_ms_p95": wall[min(int(0.95 * len(wall)), len(wall) - 1)] if wall else None,
        "tick_device_ms_p50": dev[len(dev) // 2] if dev else None,
        "prepare_ms_mean": round(float(np.mean([r["prepare_ms"] for r in rows[5:]])), 1) if warm else None,
        "finish_ms_mean": round(float(np.mean([r["finish_ms"] for r in rows[5:]])), 1) if warm else None,
        "phases": {k: {"n": n, "total_ms": round(t * 1e3, 1)}
                   for k, (n, t, *_l) in A.TICK_PHASE_STATS.items()},
        "device": card_label(engine.device),
    }
    print(json.dumps(summary), flush=True)
    result = {"rows": rows, "summary": summary, "warm_pass_s": round(warm_s, 3)}
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=2) + "\n")
    return result


def main(argv=None, device=None) -> int:
    run(argv, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
