"""The port's ``transcribe`` (decoding/transcribe.py, with decoding/timing.py's
word timestamps) against the JAX package's, on the CPU, at dev-tiny size:
JAX's ``init_params`` weights bridged through ``params_from_jax_numpy``,
speech-like audio made from numpy seeds (harness/signals.py), the stand-in
vocabulary.

Random weights give text whose average log-probability is far below the
-1 threshold, so the default temperature ladder would fall back on every
window, and sampling at temperature > 0 draws from ``jax.random`` in one
package and a ``torch.Generator`` in the other. The comparisons of tokens
therefore pin ``temperature=0.0`` in both; the fallback decision itself is
compared on the first (temperature 0) attempt of each window.

Tolerances: seeks, tokens, text and word times exact (DTW picks frames, and
times are frames / 50); f32 floats (avg_logprob, no_speech_prob, word
probabilities) within 2e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperlivekit_tpu.decoding import task as JT
from whisperlivekit_tpu.decoding import transcribe as JX
from whisperlivekit_tpu.models.whisper import model as JM
from whisperlivekit_tpu.models.whisper.dims import MODEL_DIMS
from whisperlivekit_tpu_torch.decoding import task as TT
from whisperlivekit_tpu_torch.decoding import transcribe as TX
from whisperlivekit_tpu_torch.harness.signals import speech_like
from whisperlivekit_tpu_torch.harness.vocab import write_standin_vocab
from whisperlivekit_tpu_torch.models.whisper import model as TM

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

DIMS = MODEL_DIMS["dev-tiny"]
F32_TOL = 2e-5
FLOAT_KEYS = ("avg_logprob", "no_speech_prob")


@pytest.fixture(scope="module")
def decoders(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WLK_TPU_ASSET_DIR", str(write_standin_vocab(tmp_path_factory.mktemp("vocab")).parent))
        jp = JM.init_params(DIMS, jax.random.PRNGKey(0), jnp.float32)
        tm = TM.params_from_jax_numpy(jax.tree.map(np.asarray, jp), DIMS)
        yield JT.WhisperDecoder(jp, DIMS), TT.WhisperDecoder(tm, DIMS)


def _audio(seconds: float, seed: int) -> np.ndarray:
    """Speech-like audio with a pause in the middle (a second of near
    silence), so windows hold speech and silence."""
    a = speech_like(int(16000 * seconds), seed=seed, f0=140.0 + 10 * seed)
    mid = len(a) // 2
    a[mid : mid + 16000] *= 1e-3
    return a


def _both(decoders, audio, **kw):
    jd, td = decoders
    return JX.transcribe(jd, audio, **dict(kw)), TX.transcribe(td, audio, **dict(kw))


def _assert_same(rj, rt):
    assert rt["language"] == rj["language"] and rt["text"] == rj["text"]
    assert rt["duration"] == rj["duration"]
    assert len(rt["segments"]) == len(rj["segments"])
    for sj, st in zip(rj["segments"], rt["segments"]):
        assert sorted(st) == sorted(sj)
        for key in sj:
            if key == "words":
                continue
            if key in FLOAT_KEYS:
                assert abs(st[key] - sj[key]) <= F32_TOL, key
            else:
                assert st[key] == sj[key], key
        wj, wt = sj.get("words", []), st.get("words", [])
        assert [(w["word"], w["start"], w["end"]) for w in wt] == [
            (w["word"], w["start"], w["end"]) for w in wj]
        for a, b in zip(wj, wt):
            assert abs(a["probability"] - b["probability"]) <= F32_TOL


@pytest.fixture(scope="module")
def long_run(decoders):
    """62 s in both packages at temperature 0, word timestamps on, language
    detected: three 30 s windows."""
    return _both(decoders, _audio(62.0, seed=1), temperature=0.0, word_timestamps=True)


def test_transcribe_segments_match(long_run):
    rj, rt = long_run
    _assert_same(rj, rt)
    seeks = sorted({s["seek"] for s in rt["segments"]})
    assert len(seeks) >= 2 and seeks[-1] >= 3000, seeks
    assert all(s["temperature"] == 0.0 for s in rt["segments"])


def test_word_timestamps_match(long_run):
    rj, rt = long_run
    words = [w for s in rt["segments"] for w in s["words"]]
    assert len({s["seek"] for s in rt["segments"] if s["words"]}) >= 2  # in two windows
    assert all(0 <= w["start"] <= w["end"] for w in words)
    _assert_same(rj, rt)


OPTION_CASES = {
    "clip_timestamps": dict(clip_timestamps="1,9.5,20,35"),
    "clip_timestamps_list": dict(clip_timestamps=[3.0, 34.0], word_timestamps=True),
    "hallucination_silence": dict(word_timestamps=True, hallucination_silence_threshold=2.0),
    "carry_initial_prompt": dict(initial_prompt="alpha beta gamma", carry_initial_prompt=True),
    "initial_prompt_no_condition": dict(initial_prompt="delta epsilon",
                                        condition_on_previous_text=False),
    "without_timestamps": dict(without_timestamps=True, sample_len=40),
    "beam": dict(beam_size=2, sample_len=24),
}


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_transcribe_options_match(decoders, case):
    kw = dict(temperature=0.0, language="en", sample_len=48)
    kw.update(OPTION_CASES[case])
    rj, rt = _both(decoders, _audio(36.0, seed=2), **kw)
    _assert_same(rj, rt)
    assert rt["segments"]


FALLBACK_CLIPS = {
    "speech": lambda: _audio(8.0, seed=3),
    "noise": lambda: (0.05 * np.random.default_rng(5).standard_normal(16000 * 6)).astype(np.float32),
    "silence": lambda: np.zeros(16000 * 5, np.float32),
    "tone": lambda: (0.3 * np.sin(2 * np.pi * 440 * np.arange(16000 * 7) / 16000)).astype(np.float32),
}


@pytest.fixture(scope="module")
def first_attempts(decoders):
    """Each clip is one window; every ``decode`` call of both packages is
    recorded. Returns {clip: (jax attempts, port attempts)} under a two-step
    ladder (temperature 0, then 0.6) with the default thresholds, and under a logprob threshold halfway
    between the second and third lowest first-attempt scores, so that some
    windows fall back and some do not."""
    jd, td = decoders
    calls = []

    def recording(decoder):
        real = decoder.decode

        def decode(mel, options, enc=None):
            res = real(mel, options, enc)
            calls.append((options.temperature, res[0]))
            return res
        return decode

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jd, "decode", recording(jd))
        mp.setattr(td, "decode", recording(td))
        for threshold in ("default", "between"):
            kw = dict(language="en", sample_len=16, temperature=(0.0, 0.6))
            if threshold == "between":
                firsts = sorted(j[0][1].avg_logprob for j, _ in out.values())
                kw["logprob_threshold"] = (firsts[1] + firsts[2]) / 2
            for name, clip in FALLBACK_CLIPS.items():
                audio = clip()
                attempts = []
                for mod, dec in ((JX, jd), (TX, td)):
                    calls.clear()
                    mod.transcribe(dec, audio, **kw)
                    attempts.append(list(calls))
                out[name if threshold == "default" else f"{name}/between"] = tuple(attempts)
    return out


@pytest.mark.parametrize("clip", [*FALLBACK_CLIPS, *(f"{c}/between" for c in FALLBACK_CLIPS)])
def test_fallback_decision_matches(first_attempts, clip):
    ja, ta = first_attempts[clip]
    (jt, j0), (tt, t0) = ja[0], ta[0]
    assert jt == tt == 0.0
    assert t0.tokens == j0.tokens and t0.compression_ratio == j0.compression_ratio
    for key in FLOAT_KEYS:
        assert abs(getattr(t0, key) - getattr(j0, key)) <= F32_TOL, key
    assert (len(ta) > 1) == (len(ja) > 1)  # fell back, or not, in both


def test_fallback_threshold_splits_the_clips(first_attempts):
    """The "between" threshold exercises both outcomes of the decision."""
    fell = [len(first_attempts[f"{c}/between"][1]) > 1 for c in FALLBACK_CLIPS]
    assert any(fell) and not all(fell), fell
