"""Benchmark datasets: public-corpus samples resolved to local wav/txt pairs
(the port's copy of whisperlivekit_tpu/bench/datasets.py, host-only).

Role of reference benchmark/datasets.py:256-478 — LibriSpeech / MLS / FLEURS
/ AMI samples auto-downloaded from public HuggingFace repos via the
``datasets`` package and cached as 16 kHz wav + reference-text files. On
zero-egress hosts the ``synthetic`` dataset generates local fixtures so the
whole bench pipeline stays runnable (machinery testable without network).
"""

from __future__ import annotations

import json
import logging
import wave
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

DEFAULT_CACHE = Path.home() / ".cache" / "wlk-tpu" / "bench-data"


@dataclass
class BenchSample:
    audio_path: str
    reference: str
    language: str
    dataset: str
    duration_s: float

    def to_dict(self) -> Dict:
        return asdict(self)


#: name -> (hf dataset, hf config, split, text field, language)
REGISTRY: Dict[str, Dict] = {
    "librispeech_clean": dict(
        repo="openslr/librispeech_asr", config="clean", split="test",
        text_field="text", language="en",
    ),
    "librispeech_other": dict(
        repo="openslr/librispeech_asr", config="other", split="test",
        text_field="text", language="en",
    ),
    **{
        f"mls_{lang}": dict(
            repo="facebook/multilingual_librispeech", config=full, split="test",
            text_field="transcript", language=lang,
        )
        for lang, full in [
            ("fr", "french"), ("de", "german"), ("es", "spanish"),
            ("it", "italian"), ("pt", "portuguese"), ("nl", "dutch"),
            ("pl", "polish"),
        ]
    },
    **{
        f"fleurs_{lang}": dict(
            repo="google/fleurs", config=cfg, split="test",
            text_field="transcription", language=lang,
        )
        for lang, cfg in [("en", "en_us"), ("fr", "fr_fr"), ("de", "de_de"),
                          ("zh", "cmn_hans_cn"), ("ja", "ja_jp")]
    },
    "ami_ihm": dict(
        repo="edinburghcstr/ami", config="ihm", split="test",
        text_field="text", language="en",
    ),
    "synthetic": dict(repo=None, config=None, split=None, text_field=None, language="en"),
}


def _write_wav(path: Path, audio: np.ndarray, sr: int = 16000) -> None:
    pcm = (np.clip(audio, -1.0, 1.0 - 1 / 32768) * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def _synthetic_samples(n: int, out_dir: Path) -> List[BenchSample]:
    """Local fixtures: modulated tones + known reference strings — exercises
    the full bench pipeline (harness, WER, report) without network."""
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    samples = []
    for i in range(n):
        dur = 3.0 + i
        t = np.arange(int(16000 * dur)) / 16000
        sig = 0.3 * np.sin(2 * np.pi * (180 + 40 * i) * t) * (1 + 0.4 * np.sin(2 * np.pi * 3 * t))
        sig += 0.03 * rng.standard_normal(t.shape)
        wav = out_dir / f"synthetic_{i}.wav"
        _write_wav(wav, sig.astype(np.float32))
        ref = f"synthetic sample number {i} reference text"
        (out_dir / f"synthetic_{i}.txt").write_text(ref)
        samples.append(BenchSample(str(wav), ref, "en", "synthetic", dur))
    return samples


def _download_hf(name: str, spec: Dict, n: int, skip: int, out_dir: Path) -> List[BenchSample]:
    try:
        import datasets as hf_datasets
    except ImportError as e:
        raise RuntimeError(
            "the 'datasets' package is required to download benchmark corpora; "
            "on zero-egress hosts use --dataset synthetic or local --audio pairs"
        ) from e
    from datasets import Audio, load_dataset

    ds = load_dataset(spec["repo"], spec["config"], split=spec["split"], streaming=True)
    ds = ds.cast_column("audio", Audio(sampling_rate=16000))
    out_dir.mkdir(parents=True, exist_ok=True)
    samples: List[BenchSample] = []
    for i, row in enumerate(ds):
        if i < skip:
            continue
        if len(samples) >= n:
            break
        audio = np.asarray(row["audio"]["array"], np.float32)
        wav = out_dir / f"{name}_{i}.wav"
        _write_wav(wav, audio)
        ref = str(row[spec["text_field"]])
        (out_dir / f"{name}_{i}.txt").write_text(ref)
        samples.append(
            BenchSample(str(wav), ref, spec["language"], name, len(audio) / 16000)
        )
    return samples


def fetch(
    name: str, n_samples: int = 4, skip: int = 0, cache_dir: Optional[Path] = None
) -> List[BenchSample]:
    """Resolve ``n_samples`` of a registered dataset to local files, cached
    under ``cache_dir`` with a manifest so repeat runs are offline."""
    if name not in REGISTRY:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(REGISTRY)}")
    cache = Path(cache_dir or DEFAULT_CACHE) / name
    manifest = cache / "manifest.json"
    if manifest.exists():
        entries = json.loads(manifest.read_text())
        if len(entries) >= n_samples and all(
            Path(e["audio_path"]).exists() for e in entries[:n_samples]
        ):
            return [BenchSample(**e) for e in entries[:n_samples]]

    if name == "synthetic":
        samples = _synthetic_samples(n_samples, cache)
    else:
        samples = _download_hf(name, REGISTRY[name], n_samples, skip, cache)
    cache.mkdir(parents=True, exist_ok=True)
    manifest.write_text(json.dumps([s.to_dict() for s in samples], indent=1))
    logger.info("dataset %s: %d samples cached at %s", name, len(samples), cache)
    return samples
