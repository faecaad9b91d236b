"""The port's ``wlk-torch bench`` (whisperlivekit_tpu_torch/bench/): twins of
tests/test_bench_machinery.py (registry, synthetic fetch and manifest,
unknown dataset, aggregate and table; its AOT-probe case is a TPU probe and
has no twin), the copies against the JAX modules, and the bench run in
process on ``random:dev-tiny`` on the CPU over ``--dataset-dir``,
``--dataset synthetic`` and ``--audio``. Also the scheduler's
``profile_dir``: a session's first ticks leave a ``torch.profiler`` trace.
"""

import asyncio
import json
from pathlib import Path

import pytest
import torch

from whisperlivekit_tpu.bench import datasets as JD
from whisperlivekit_tpu.bench import report as JR
from whisperlivekit_tpu_torch import cli as TC
from whisperlivekit_tpu_torch.bench import datasets as TD
from whisperlivekit_tpu_torch.bench import report as TR
from whisperlivekit_tpu_torch.harness import harness as TH
from whisperlivekit_tpu_torch.harness.vocab import write_standin_vocab
from torch_ckpt import write_wav

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

RESULTS = [
    {"language": "en", "dataset": "librispeech_clean", "wer": 0.05, "rtf": 0.1,
     "duration_s": 10, "first_word_latency": 0.4},
    {"language": "en", "dataset": "librispeech_clean", "wer": 0.07, "rtf": 0.2,
     "duration_s": 20, "first_word_latency": 0.6},
    {"language": "fr", "dataset": "mls_fr", "wer": 0.10, "rtf": 0.3,
     "duration_s": 5, "first_word_latency": None},
]
FLAGS = ["--model-size", "random:dev-tiny", "--lan", "en", "--no-vac", "--log-level", "ERROR"]


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WLK_TPU_ASSET_DIR", str(write_standin_vocab(root / "vocab").parent))
        mp.setenv("HOME", str(root / "home"))
        yield root
    TH.reset_engine_cache()


def test_registry_covers_reference_corpora():
    names = set(TD.REGISTRY)
    assert {"librispeech_clean", "librispeech_other", "ami_ihm", "synthetic"} <= names
    assert {n for n in names if n.startswith("mls_")} >= {"mls_fr", "mls_de", "mls_es"}
    assert any(n.startswith("fleurs_") for n in names)
    assert TD.REGISTRY == JD.REGISTRY


def test_synthetic_fetch_and_manifest(tmp_path):
    samples = TD.fetch("synthetic", n_samples=3, cache_dir=tmp_path)
    assert len(samples) == 3
    for s in samples:
        assert Path(s.audio_path).exists()
        assert s.reference
        assert s.language == "en"
    # second fetch comes from the manifest (no regeneration)
    manifest = tmp_path / "synthetic" / "manifest.json"
    before = manifest.stat().st_mtime_ns
    again = TD.fetch("synthetic", n_samples=2, cache_dir=tmp_path)
    assert len(again) == 2
    assert manifest.stat().st_mtime_ns == before
    # the JAX package writes the same fixtures
    want = JD.fetch("synthetic", n_samples=3, cache_dir=tmp_path / "jax")
    for a, b in zip(samples, want):
        assert Path(a.audio_path).read_bytes() == Path(b.audio_path).read_bytes()
        assert (a.reference, a.duration_s) == (b.reference, b.duration_s)


def test_unknown_dataset():
    with pytest.raises(KeyError):
        TD.fetch("nope")


def test_aggregate_and_table():
    rows = TR.aggregate(RESULTS)
    assert len(rows) == 2
    en = next(r for r in rows if r["language"] == "en")
    assert en["n"] == 2 and en["wer"] == 0.06 and en["audio_s"] == 30
    fr = next(r for r in rows if r["language"] == "fr")
    assert fr["first_word_s"] is None

    table = TR.render_table(rows)
    assert "librispeech_clean" in table and "mls_fr" in table
    report = TR.build_report(RESULTS, {"model": "x"})
    assert report["overall"]["n"] == 3
    assert report == JR.build_report(RESULTS, {"model": "x"})
    assert table == JR.render_table(JR.aggregate(RESULTS))


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("source", ["dataset-dir", "synthetic", "audio"])
def test_bench_runs_offline(assets, tmp_path, capsys, monkeypatch, source):
    """``wlk-torch bench`` in process on random dev-tiny weights, on the CPU:
    the JAX runner's JSON line on stdout, the report file and the table."""
    d = tmp_path / "data"
    d.mkdir()
    write_wav(d / "a.wav", 2.0, seed=3)
    (d / "a.txt").write_text("some reference words")
    write_wav(d / "b.wav", 2.0, seed=4)  # no reference: no wer
    monkeypatch.setattr(TD, "DEFAULT_CACHE", tmp_path / "cache")
    args = {"dataset-dir": ["--dataset-dir", str(d)],
            "synthetic": ["--dataset", "synthetic", "--n", "1"],
            "audio": ["--audio", str(d / "a.wav"), "--ref", str(d / "a.txt")]}[source]
    out_json = tmp_path / "report.json"
    assert TC.main(["bench", *args, "--json", str(out_json), *FLAGS], device="cpu") == 0
    cap = capsys.readouterr()
    line = _last_json(cap.out)
    assert set(line) == {"per_language", "overall"}
    n = {"dataset-dir": 2, "synthetic": 1, "audio": 1}[source]
    assert line["overall"]["n"] == n
    report = json.loads(out_json.read_text())
    assert report["config"]["model"] == "random:dev-tiny" and len(report["results"]) == n
    assert report["per_language"][0]["dataset"] == ("synthetic" if source == "synthetic" else "local")
    for res in report["results"]:
        assert res["audio_s"] > 0 and res["rtf"] is not None
    assert ["wer" in r for r in report["results"]] == ([True, False] if source == "dataset-dir" else [True])
    assert "overall: n=" in cap.err


def test_profile_dir_writes_a_trace(assets, tmp_path):
    """A session of ``random:dev-tiny`` with ``profile_dir`` leaves the
    first ticks' Chrome trace in the directory."""
    prof = tmp_path / "prof"
    wav = write_wav(tmp_path / "s.wav", 8.0, seed=5)

    async def run():
        async with TH.TestHarness(model_size="random:dev-tiny", lan="en", vac=False,
                                  profile_dir=str(prof), device="cpu") as h:
            await h.feed(str(wav), speed=0)
            await h.drain(1.0)
            await h.finish(timeout=120)
            return TH._engine_cache[TH._cache_key(h._engine_kwargs)]

    engine = asyncio.run(run())
    sched = engine.scheduler
    assert sched is not None and sched.n_ticks >= 5
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)
