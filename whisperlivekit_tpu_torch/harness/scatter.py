"""Policy x model sweep of WER and RTF for scatter plots, on the port.

    python -m whisperlivekit_tpu_torch.harness.scatter --dataset-dir DIR [--models base,small]
        [--policies simulstreaming,localagreement,windowed] [--aware both|true|false]
        [--compare-exact] [--out scatter.json]

Port of the repository's ``scripts/run_scatter_benchmark.py``. Each (model,
policy) point runs every clip of DIR (``*.wav`` files, each with an
optional sibling ``*.txt`` reference) through the in-process
``TestHarness``, compute-aware (``speed=1.0``: audio fed in real time, so
a slow configuration falls behind) and compute-unaware (``speed=0``: all
at once), each point on a freshly built engine. A point's ``rtf`` is the
processing wall time over the audio's seconds, its ``wer`` the mean of
the clips' word error rates (``harness/wer.py``). ``--compare-exact``
runs each simulstreaming point twice: the default incremental tail encode
and the exact full-window re-encode (``incremental_encode=False``). The
flags, the points' keys and the ``{"results": [...]}`` file are the JAX
script's. ``main(argv, device="cpu")`` runs on the CPU (tests); without
``device`` the engines serve on the card. Imports no JAX.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from pathlib import Path


async def run_point(model: str, policy: str, pairs, speed: float, exact: bool = False, device=None) -> dict:
    """One point: every clip through a fresh engine's TestHarness;
    ``device`` None serves on the card."""
    from .harness import TestHarness, reset_engine_cache
    from .wer import compute_wer

    reset_engine_cache()
    total_audio = 0.0
    total_proc = 0.0
    wers = []
    for wav, txt in pairs:
        async with TestHarness(
            model_size=model, backend_policy=policy, lan="en", log_level="ERROR",
            incremental_encode=not exact, device=device,
        ) as h:
            t0 = time.perf_counter()
            await h.feed(str(wav), speed=speed)
            await h.drain(1.0)
            final = await h.finish(timeout=600)
            total_proc += time.perf_counter() - t0
            total_audio += h.audio_position
            if txt:
                wers.append(compute_wer(txt.read_text(), final.text)["wer"])
    return {
        "model": model,
        "policy": policy,
        "aware": speed > 0,
        "encode": "exact" if exact else "incremental",
        "rtf": round(total_proc / total_audio, 4) if total_audio else None,
        "wer": round(sum(wers) / len(wers), 4) if wers else None,
        "n_samples": len(pairs),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset-dir", required=True)
    ap.add_argument("--models", default="base")
    ap.add_argument("--policies", default="simulstreaming,localagreement,windowed")
    ap.add_argument("--aware", default="both", choices=("both", "true", "false"))
    ap.add_argument("--compare-exact", action="store_true",
                    help="run each simulstreaming point twice — the default incremental tail-encode "
                    "vs the exact full-window re-encode (incremental_encode=False) — the one-command "
                    "inc-vs-exact WER A/B")
    ap.add_argument("--out", default="scatter.json")
    return ap


def main(argv=None, device=None) -> int:
    from .capacity import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(device)
    d = Path(args.dataset_dir)
    pairs = [
        (wav, wav.with_suffix(".txt") if wav.with_suffix(".txt").exists() else None)
        for wav in sorted(d.glob("*.wav"))
    ]
    if not pairs:
        print(f"no .wav files in {d}", file=sys.stderr)
        return 2

    speeds = {"both": (0.0, 1.0), "true": (1.0,), "false": (0.0,)}[args.aware]
    results = []
    for model in args.models.split(","):
        for policy in args.policies.split(","):
            for speed in speeds:
                modes = (False,)
                if args.compare_exact and policy.strip() == "simulstreaming":
                    modes = (False, True)
                for exact in modes:
                    point = asyncio.run(run_point(model.strip(), policy.strip(), pairs, speed, exact=exact,
                                                  device=device))
                    results.append(point)
                    print(json.dumps(point), file=sys.stderr)

    Path(args.out).write_text(json.dumps({"results": results}, indent=2))
    print(f"wrote {args.out} ({len(results)} points)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
