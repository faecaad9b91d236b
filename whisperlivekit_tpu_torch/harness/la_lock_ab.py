"""Concurrent LocalAgreement ``transcribe`` calls on one backend, with and
without the backend's lock, on the GPU.

    python -m whisperlivekit_tpu_torch.harness.la_lock_ab [--sessions 5]
        [--seconds 12] [--sample-len 64] [--rounds lock,none,none,lock,solo]

Builds ``random:base`` (bf16, seeded) under
``backend_policy="localagreement"`` on the card with the stand-in
vocabulary, pins temperature 0 and ``--sample-len`` steps a window (random
weights fall back on every window and rarely end one), warms up, then runs
each round of ``--sessions`` calls, one per session, on ``--seconds`` of
speech-like audio each: ``lock`` at once from as many threads, through
the backend's lock (``TorchWhisperASR._session_lock``, as the server runs
them); ``none`` at once with the lock taken away; ``solo`` one after
another. Prints one line per round (its wall and each call's ms, the lock
wait included) and a JSON line with the card's name. Needs CUDA; imports
no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import threading
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=5)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--sample-len", type=int, default=64)
    ap.add_argument("--rounds", default="lock,none,none,lock,solo")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("la_lock_ab: needs a CUDA device", file=sys.stderr)
        return 1

    from ..engine.core import TranscriptionEngine, WLKConfig
    from .signals import speech_like
    from .vocab import install_standin_vocab

    with tempfile.TemporaryDirectory(prefix="wlk_vocab_") as vocab_dir:
        install_standin_vocab(vocab_dir)
        engine = TranscriptionEngine(WLKConfig(model_size="random:base", lan="en", vac=False,
                                               param_dtype="bfloat16", backend_policy="localagreement"))
        TranscriptionEngine.reset()
        asr = engine.asr.asr
        asr.transcribe_kargs.update(temperature=0.0, sample_len=args.sample_len)
        lock = asr._session_lock
        audios = [speech_like(int(16000 * args.seconds), seed=50 + i, f0=130.0 + 10 * i)
                  for i in range(args.sessions)]
        asr.transcribe(audios[0][:16000])  # warm-up: builds K1
        torch.cuda.synchronize()
        rounds = []
        for label in args.rounds.split(","):
            asr._session_lock = contextlib.nullcontext() if label == "none" else lock
            ms = [0.0] * args.sessions

            def call(i):
                t = time.perf_counter()
                asr.transcribe(audios[i])
                torch.cuda.synchronize()
                ms[i] = (time.perf_counter() - t) * 1e3

            t0 = time.perf_counter()
            if label == "solo":
                for i in range(args.sessions):
                    call(i)
            else:
                threads = [threading.Thread(target=call, args=(i,)) for i in range(args.sessions)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join()
            wall = time.perf_counter() - t0
            rounds.append(dict(round=label, wall_s=round(wall, 3), call_ms=[round(m, 1) for m in ms]))
            print(f"[la_lock_ab] round={label} wall_s={wall:.3f} call_ms={[round(m) for m in ms]}", flush=True)
        asr._session_lock = lock
    print(json.dumps({"card": torch.cuda.get_device_name(0), "model": "random:base bf16",
                      "sessions": args.sessions, "seconds": args.seconds, "sample_len": args.sample_len,
                      "rounds": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
