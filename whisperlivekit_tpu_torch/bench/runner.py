"""`wlk-torch bench`: quality/latency benchmark over audio files or datasets
(port of whisperlivekit_tpu/bench/runner.py; host code over the port's
TestHarness, whose engine serves on the card unless ``main`` is given
``device="cpu"``).

Reference parity: benchmark/runner.py:15-180 + datasets.py + report.py —
samples come from local files (--audio/--dataset-dir) or a registered public
corpus (--dataset librispeech_clean|mls_fr|fleurs_en|ami_ihm|synthetic…,
auto-downloaded and cached; see bench/datasets.py), run through the
in-process TestHarness, and report WER (EnglishTextNormalizer methodology
for English) / RTF / first-word latency per language (bench/report.py),
with JSON export.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time
from pathlib import Path
from typing import List, Optional

from ..harness.wer import compute_wer


def _pairs_from_dir(d: Path) -> List[tuple]:
    pairs = []
    for wav in sorted(d.glob("*.wav")):
        txt = wav.with_suffix(".txt")
        pairs.append((wav, txt if txt.exists() else None))
    return pairs


async def bench_one(
    path: Path, ref_text: Optional[str], config, speed: float,
    language: str = "?", dataset: str = "local", device=None,
) -> dict:
    from ..cli import _harness_kwargs
    from ..harness.harness import TestHarness

    kw = _harness_kwargs(config, device)

    first_word_latency = None
    t_start = time.perf_counter()

    async with TestHarness(**kw) as h:
        t_feed0 = time.perf_counter()

        def on_update(state):
            nonlocal first_word_latency
            if first_word_latency is None and state.text.strip():
                first_word_latency = time.perf_counter() - t_feed0

        h.on_update(on_update)
        await h.feed(str(path), speed=speed)
        await h.drain(1.0)
        final = await h.finish(timeout=300)
        processing = time.perf_counter() - t_feed0
        audio_s = h.audio_position
        out = {
            "file": str(path),
            "language": language,
            "dataset": dataset,
            "duration_s": round(audio_s, 2),
            "audio_s": round(audio_s, 2),
            "processing_s": round(processing, 2),
            "rtf": round(processing / audio_s, 4) if audio_s else None,
            "first_word_latency": round(first_word_latency, 3)
            if first_word_latency
            else None,
            "text": final.text,
            "metrics": h.metrics.to_dict(),
        }
        if ref_text:
            english = language in ("en", "?")
            out["wer"] = round(
                compute_wer(ref_text, final.text, english=english)["wer"], 4
            )
        return out


def main(argv: List[str], device=None) -> int:
    from ..cli import _pop_flag
    from ..cli_args import parse_args

    audio = _pop_flag(argv, "--audio")
    ref = _pop_flag(argv, "--ref")
    dataset_dir = _pop_flag(argv, "--dataset-dir")
    dataset_names = _pop_flag(argv, "--dataset")
    n_samples = int(_pop_flag(argv, "--n", "4"))
    out_json = _pop_flag(argv, "--json")
    speed = float(_pop_flag(argv, "--speed", "0"))
    config = parse_args(argv)

    tasks: List[tuple] = []  # (path, ref_text, language, dataset)
    if audio:
        ref_text = Path(ref).read_text().strip() if ref else None
        tasks.append((Path(audio), ref_text, config.lan or "?", "local"))
    elif dataset_dir:
        for wav, txt in _pairs_from_dir(Path(dataset_dir)):
            tasks.append(
                (wav, txt.read_text().strip() if txt else None, config.lan or "?", "local")
            )
    elif dataset_names:
        from .datasets import fetch

        for name in dataset_names.split(","):
            for s in fetch(name.strip(), n_samples=n_samples):
                tasks.append((Path(s.audio_path), s.reference, s.language, s.dataset))
    if not tasks:
        print(
            "usage: wlk-torch bench --audio FILE [--ref TEXT] | --dataset-dir DIR | "
            "--dataset NAME[,NAME..] [--n 4] [--speed 0|1] [--json OUT] [flags]",
            file=sys.stderr,
        )
        return 2

    results = []
    for wav, ref_text, language, dataset in tasks:
        res = asyncio.run(bench_one(wav, ref_text, config, speed, language, dataset, device))
        results.append(res)
        wer = f" wer={res['wer']:.3f}" if "wer" in res else ""
        print(
            f"{wav.name}: rtf={res['rtf']}{wer} "
            f"first_word={res['first_word_latency']}s",
            file=sys.stderr,
        )

    from .report import build_report, print_report, save_report

    report = build_report(
        results,
        config_summary={
            "model": config.model_size, "backend": config.backend,
            "policy": config.backend_policy, "speed": speed,
        },
    )
    print_report(report, file=sys.stderr)
    if out_json:
        save_report(report, out_json)
    print(json.dumps({"per_language": report["per_language"], "overall": report["overall"]}))
    return 0
