"""The end-to-end serving benchmark's twin
(whisperlivekit_tpu_torch/harness/e2e_serving.py) against
scripts/bench_e2e_serving.py on the CPU:

- ``speech_like`` is bit-equal to the script's over several seeds and
  start times, and 0.5 s chunks stitch into one long call's samples;
- with ``drive_session`` replaced on both sides by the same scripted probe
  samples, ``run_once`` returns the same record, and with ``run_once``
  replaced by the same scripted records, the summaries' sustained counts
  agree;
- a real run of 2 sessions of ``random:dev-tiny`` without the VAD: every
  session emits words, none is rejected, and the summary has the script's
  keys plus ``device`` and ``vad``;
- the twin imports without jax and the JAX package.
"""

import asyncio
import importlib.util
import json
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from whisperlivekit_tpu_torch.harness import e2e_serving as E
from whisperlivekit_tpu_torch.harness import harness as TH
from whisperlivekit_tpu_torch.harness.vocab import install_standin_vocab

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

REPO = Path(__file__).resolve().parent.parent


def _script():
    spec = importlib.util.spec_from_file_location("bench_e2e_serving", REPO / "scripts" / "bench_e2e_serving.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J = _script()


@pytest.mark.parametrize("seed,t0,seconds", [(0, 0.0, 1.0), (3, 2.5, 0.5), (7, 11.0, 1.3), (12, 0.02, 0.7)])
def test_speech_like_bit_equal(seed, t0, seconds):
    got, want = E.speech_like(seconds, seed=seed, t0=t0), J.speech_like(seconds, seed=seed, t0=t0)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_speech_like_chunks_stitch():
    """Chunks of 0.5 s at t0 = 0, 0.5, ... equal one 3 s call, apart from
    the noise floor, which each call draws from (seed, t0)."""
    whole = J.speech_like(3.0, seed=5)
    chunks = np.concatenate([E.speech_like(E.CHUNK_S, seed=5, t0=k * E.CHUNK_S) for k in range(6)])
    noise = np.concatenate([
        0.008 * np.random.default_rng((5, int(round(k * E.CHUNK_S * E.SR)))).standard_normal(8000)
        for k in range(6)
    ])
    whole_noise = 0.008 * np.random.default_rng((5, 0)).standard_normal(48000)
    np.testing.assert_allclose(chunks - noise, whole - whole_noise, rtol=0, atol=1e-5)


# (audio end s, emission latency s) per session: warm 2 s + shakeout 1 s
# = cut 3 s, duration 6 s (thirds at 5 s and 7 s); session 2 has samples
# only before the cut, session 3 is rejected
PROBES = [
    [(1.0, 0.4), (3.2, 0.35), (4.1, 0.3), (5.5, 0.42), (6.2, 0.5), (7.4, 0.61), (8.6, 0.7)],
    [(2.9, 0.2), (3.0, 0.25), (5.1, 0.38), (6.9, 0.45), (7.0, 0.9), (8.9, 1.2)],
    [(0.5, 0.1), (2.5, 0.2)],
    None,
]
RUN = dict(duration=6.0, stagger_s=0.0, warm_s=2.0, shakeout_s=1.0, drift_tol=0.3)


def _scripted_drive():
    async def drive(idx, engine_kwargs, duration, stagger_s, warm_s, shakeout_s, probe, barrier, started):
        samples = PROBES[idx]
        if samples is None:
            probe.rejected = True
        else:
            probe.samples = list(samples)
            probe.n_infer_calls = 10 + idx
            probe.mean_infer_s = 0.1 * (idx + 1)
        await barrier.wait()
        started.set()
    return drive


def test_run_once_equals_jax_on_scripted_samples(monkeypatch):
    from whisperlivekit_tpu.harness import harness as JH

    monkeypatch.setattr(JH, "_engine_cache", {})
    monkeypatch.setattr(TH, "_engine_cache", {})
    monkeypatch.setattr(J, "drive_session", _scripted_drive())
    monkeypatch.setattr(E, "drive_session", _scripted_drive())
    args = (len(PROBES), RUN["duration"], {}, RUN["stagger_s"], RUN["warm_s"], RUN["shakeout_s"], RUN["drift_tol"])
    want = asyncio.run(J.run_once(*args))
    got = asyncio.run(E.run_once(*args))
    assert want.pop("wall_s") >= 0 and got.pop("wall_s") >= 0
    assert got == want
    assert got["n_rejected"] == 1 and got["n_sessions_without_output"] == 1
    assert got["word_emission_p50_ms"] is not None and got["keep_up"] is False


@pytest.mark.parametrize("records", [
    # (n_admitted, keep_up, n_sessions_without_output, word_emission_p50_ms) per run
    [(48, True, 0, 420.0), (64, True, 0, 650.0)],
    [(48, True, 1, 300.0), (64, False, 0, 300.0)],
    [(16, True, 0, 500.0), (32, True, 0, 480.0), (48, True, 0, 900.0)],
])
def test_summary_sustained_counts_equal_jax(monkeypatch, capsys, records):
    """The summary's two sustained counts, from the same scripted run
    records, with run_once replaced on both sides."""
    from whisperlivekit_tpu.harness import harness as JH

    def scripted():
        it = iter([None] + [dict(n_admitted=a, keep_up=k, n_sessions_without_output=s, word_emission_p50_ms=p)
                            for a, k, s, p in records])

        async def run_once(*args, **kwargs):
            return next(it) or dict(n_admitted=2, keep_up=False, n_sessions_without_output=0,
                                    word_emission_p50_ms=None)
        return run_once

    argv = ["--n", *[str(r[0]) for r in records]]
    monkeypatch.setattr(JH, "_engine_cache", {})
    monkeypatch.setattr(J, "run_once", scripted())
    monkeypatch.setattr(sys, "argv", ["bench_e2e_serving.py", *argv])
    J.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setattr(E, "run_once", scripted())
    key = TH._cache_key(dict(E.engine_kwargs_for(E.parse_args(argv), "cpu"), pcm_input=True))
    monkeypatch.setattr(TH, "_engine_cache", {key: types.SimpleNamespace(
        device=torch.device("cpu"), vad_scheduler=None, vac_model=None)})
    got = E.run(argv, device="cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    assert got.pop("device") == "cpu" and got.pop("vad") == "off"
    assert got == want


def test_two_sessions_emit_words_on_the_cpu(tmp_path, monkeypatch):
    """A real run through TestHarness, the engine and the scheduler:
    random:dev-tiny, 2 sessions, no VAD, 1 s warm + 1 s shakeout + 3 s."""
    monkeypatch.setenv("WLK_TPU_ASSET_DIR", str(tmp_path))
    install_standin_vocab(tmp_path)
    monkeypatch.setattr(TH, "_engine_cache", {})
    out = tmp_path / "e2e.json"
    summary = E.run(["--n", "2", "--duration", "3", "--warm", "1", "--shakeout", "1", "--stagger", "0",
                     "--model", "random:dev-tiny", "--no-vac", "--out", str(out)], device="cpu")
    assert json.loads(out.read_text()) == summary
    assert set(summary) == {"model", "xkv_dtype", "decoder_dtype", "max_steps", "anchor_cohorts",
                            "commit_budget", "max_sustained_streams", "max_sustained_streams_at_500ms_p50",
                            "runs", "device", "vad"}
    assert summary["device"] == "cpu" and summary["vad"] == "off"
    (run,) = summary["runs"]
    assert run["n_admitted"] == 2 and run["n_rejected"] == 0
    assert run["n_sessions_without_output"] == 0 and run["n_frontier_advances"] >= 2
    assert run["scheduler"]["n_failed_ticks"] == 0 and run["scheduler"]["n_ticks"] > 0
    # the priming run and the measured run shared one engine
    assert len(TH._engine_cache) == 1


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
        from whisperlivekit_tpu_torch.harness import e2e_serving as E
        import whisperlivekit_tpu_torch.engine.core, whisperlivekit_tpu_torch.harness.harness
        E.speech_like(0.1, seed=1)
        E.parse_args(["--n", "2"])
        assert not any(m.split(".")[0] in REFUSED for m in sys.modules)
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
