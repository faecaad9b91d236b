"""The scatter sweep's twin (whisperlivekit_tpu_torch/harness/scatter.py)
against scripts/run_scatter_benchmark.py on the CPU:

- with ``TestHarness`` replaced on both sides by the same scripted harness
  (clip lengths and transcripts fixed per clip, policy and encode mode)
  and the clocks by the same scripted counter, the points equal the
  script's: their order, keys, ``rtf`` and ``wer``, over every policy,
  both awareness settings and ``--compare-exact``, and the engines are
  asked for with the script's arguments;
- an empty dataset directory returns 2;
- one real run of ``random:dev-tiny`` at speed 0 through the port's
  TestHarness on a written two-clip directory (event audio and its words);
- the twin runs without jax and the JAX package.
"""

import importlib.util
import itertools
import json
import subprocess
import sys
import textwrap
import types
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from whisperlivekit_tpu.harness import harness as JH
from whisperlivekit_tpu_torch.harness import harness as TH
from whisperlivekit_tpu_torch.harness import scatter as S
from whisperlivekit_tpu_torch.harness import train_structured as TS
from whisperlivekit_tpu_torch.harness.vocab import install_standin_vocab
from whisperlivekit_tpu_torch.models.whisper.tokenizer import get_tokenizer

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

REPO = Path(__file__).resolve().parent.parent
REFS = {"a": "the red stone river light", "b": "one two three", "c": "go up in on to"}


def _script():
    spec = importlib.util.spec_from_file_location("run_scatter_benchmark",
                                                  REPO / "scripts" / "run_scatter_benchmark.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J = _script()


def _scripted(calls):
    """A TestHarness stand-in: each clip lasts 1.5 s per letter of its
    stem's position, and the transcript drops words by policy and mode."""
    class Harness:
        def __init__(self, **kwargs):
            calls.append({k: v for k, v in kwargs.items() if k != "device"})
            self.kw = kwargs
            self.audio_position = 0.0

        async def __aenter__(self):
            return self

        async def __aexit__(self, *exc):
            return None

        async def feed(self, path, speed=1.0):
            stem = Path(path).stem
            self.stem, self.speed = stem, speed
            self.audio_position = 1.5 * ("abc".index(stem) + 1)

        async def drain(self, seconds):
            return None

        async def finish(self, timeout=30.0):
            words = REFS[self.stem].split()
            drop = len(self.kw["backend_policy"]) % 3 + (0 if self.kw["incremental_encode"] else 1)
            drop += int(self.speed > 0)
            return types.SimpleNamespace(text=" ".join(words[drop:] + ["extra"] * (drop % 2)))
    return Harness


def _clock():
    ticks = itertools.count(0.0, 0.37)
    return types.SimpleNamespace(perf_counter=lambda: next(ticks))


def _dataset(path: Path) -> Path:
    """Three clips, the second without a reference."""
    path.mkdir()
    for stem in "abc":
        (path / f"{stem}.wav").write_bytes(b"")
        if stem != "b":
            (path / f"{stem}.txt").write_text(REFS[stem])
    return path


ARGV = ["--models", "base,small", "--policies", "simulstreaming,localagreement,windowed", "--compare-exact"]


@pytest.mark.parametrize("aware", ["both", "true", "false"])
def test_points_equal_the_script(monkeypatch, tmp_path, capsys, aware):
    data = _dataset(tmp_path / "data")
    jcalls, tcalls = [], []
    monkeypatch.setattr(JH, "TestHarness", _scripted(jcalls))
    monkeypatch.setattr(JH, "reset_engine_cache", lambda: None)
    monkeypatch.setattr(TH, "TestHarness", _scripted(tcalls))
    monkeypatch.setattr(TH, "reset_engine_cache", lambda: None)
    monkeypatch.setattr(J, "time", _clock())
    monkeypatch.setattr(S, "time", _clock())
    argv = ["--dataset-dir", str(data), *ARGV, "--aware", aware]
    monkeypatch.setattr(sys, "argv", ["run_scatter_benchmark.py", *argv, "--out", str(tmp_path / "jax.json")])
    assert J.main() == 0
    assert S.main([*argv, "--out", str(tmp_path / "torch.json")], device="cpu") == 0
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "torch.json").read_text())
    assert got == want
    n_speeds = 2 if aware == "both" else 1
    assert len(got["results"]) == 2 * 4 * n_speeds  # simulstreaming twice (inc, exact), two other policies
    assert {p["encode"] for p in got["results"]} == {"incremental", "exact"}
    assert all(p["rtf"] is not None and p["wer"] is not None for p in got["results"])
    assert tcalls == jcalls
    # both sides print each point to stderr as it lands
    out = capsys.readouterr()
    assert [json.loads(ln) for ln in out.err.strip().splitlines()] == 2 * got["results"]


def test_empty_dataset_returns_2(tmp_path):
    (tmp_path / "empty").mkdir()
    assert S.main(["--dataset-dir", str(tmp_path / "empty"), "--out", str(tmp_path / "s.json")], device="cpu") == 2
    assert not (tmp_path / "s.json").exists()


def _write_wav(path: Path, audio: np.ndarray) -> None:
    pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm)


def test_real_run_on_the_cpu(tmp_path, monkeypatch):
    """random:dev-tiny, simulstreaming, speed 0, incremental and exact, on
    two 3 s clips of event audio with their words as references."""
    monkeypatch.setenv("WLK_TPU_ASSET_DIR", str(tmp_path))
    install_standin_vocab(tmp_path)
    words, _ = TS.word_vocab(get_tokenizer(True, language="en", task="transcribe"))
    data = tmp_path / "data"
    data.mkdir()
    for k, seed in enumerate((3, 4)):
        _write_wav(data / f"clip{k}.wav", TS.events_audio(3.0, seed=seed, t0=0.0))
        (data / f"clip{k}.txt").write_text(" ".join(TS.events_words(seed, 0.0, 3.0, words)))
    monkeypatch.setattr(TH, "_engine_cache", {})
    out = tmp_path / "scatter.json"
    assert S.main(["--dataset-dir", str(data), "--models", "random:dev-tiny", "--policies", "simulstreaming",
                   "--aware", "false", "--compare-exact", "--out", str(out)], device="cpu") == 0
    points = json.loads(out.read_text())["results"]
    assert [(p["encode"], p["aware"], p["n_samples"]) for p in points] == [
        ("incremental", False, 2), ("exact", False, 2)]
    for p in points:
        assert p["model"] == "random:dev-tiny" and p["policy"] == "simulstreaming"
        assert p["rtf"] > 0 and p["wer"] is not None and p["wer"] >= 0


def test_twin_imports_without_jax():
    code = textwrap.dedent(
        """
        import sys
        REFUSED = ("jax", "jaxlib", "whisperlivekit_tpu")
        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in REFUSED:
                    raise ImportError("refused in this process: " + name)
                return None
        sys.meta_path.insert(0, Refuse())
        from whisperlivekit_tpu_torch.harness import scatter as S
        import whisperlivekit_tpu_torch.harness.harness, whisperlivekit_tpu_torch.harness.wer
        import whisperlivekit_tpu_torch.engine.core
        S.build_parser().parse_args(["--dataset-dir", "."])
        assert not any(m.split(".")[0] in REFUSED for m in sys.modules)
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
