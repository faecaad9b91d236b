"""The port's TestHarness, TestState, WER and normalizers against the JAX
package's, on the CPU:

- the milestone: both packages' TestHarness stream one generated WAV
  through one dev-tiny checkpoint (written in ``tmp_path``, loaded by each
  package's own loader) and commit the same token ids and text;
- tests/test_harness_state.py's TestState cases and tests/test_normalizers.py's
  cases, run on both modules;
- WER on both modules (the host copies themselves are in
  tests/test_torch_hostcopies.py's table).
"""

import asyncio
import inspect
import json

import numpy as np
import pytest
import torch

from whisperlivekit_tpu.harness import harness as JH
from whisperlivekit_tpu.harness import normalizers as JN
from whisperlivekit_tpu.models.whisper.dims import MODEL_DIMS
from whisperlivekit_tpu_torch.harness import harness as TH
from whisperlivekit_tpu_torch.harness import normalizers as TN
from whisperlivekit_tpu_torch.harness.vocab import write_standin_vocab
from test_normalizers import CASES
from torch_ckpt import canonical_state_dict, write_openai, write_wav

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

PACKAGES = {"jax": "whisperlivekit_tpu", "torch": "whisperlivekit_tpu_torch"}


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The stand-in vocabulary and a small spelling list for both packages,
    a dev-tiny checkpoint and a 3 s WAV (the environment is restored
    afterwards, and both harnesses' engines are dropped)."""
    root = tmp_path_factory.mktemp("harness")
    vocab_dir = write_standin_vocab(root / "assets").parent
    (vocab_dir / "english.json").write_text(json.dumps({"colour": "color", "centre": "center"}))
    ckpt = write_openai(root / "tiny.pt", canonical_state_dict(MODEL_DIMS["dev-tiny"], seed=3),
                        MODEL_DIMS["dev-tiny"], np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WLK_TPU_ASSET_DIR", str(vocab_dir))
        yield dict(ckpt=str(ckpt), wav=str(write_wav(root / "speech.wav", 3.0, seed=1)))
    JH.reset_engine_cache()
    TH.reset_engine_cache()


def _stream(H, wav, **kwargs):
    async def main():
        async with H.TestHarness(**kwargs) as h:
            await h.feed(wav, speed=0)
            await h.drain(1.0)
            state = await h.finish(timeout=120)
            tokens = [list(c) for c in h._processor.transcription.model.committed_tokens]
            return state, tokens, h.history
    return asyncio.run(main())


def test_harness_milestone_both_packages_commit_the_same_tokens(assets):
    kw = dict(model_path=assets["ckpt"], lan="en", vac=False, param_dtype="float32", log_level="ERROR")
    jstate, jtokens, _ = _stream(JH, assets["wav"], **kw)
    tstate, ttokens, history = _stream(TH, assets["wav"], device="cpu", **kw)
    assert ttokens == jtokens and sum(map(len, ttokens)) > 0
    assert tstate.text == jstate.text and tstate.text
    assert [ln["text"] for ln in tstate.lines] == [ln["text"] for ln in jstate.lines]
    assert tstate.timing_valid and tstate.timing_monotonic
    assert history and history[-1] is tstate
    engine = next(iter(TH._engine_cache.values()))
    assert engine.device.type == "cpu" and engine.asr.dims.n_audio_state == 64


def test_harness_caches_engines_apart_from_jax(assets):
    """One engine per kwargs in each package's own cache; a new kwargs set
    resets only that package's singleton."""
    from whisperlivekit_tpu.engine.core import TranscriptionEngine as JE
    from whisperlivekit_tpu_torch.engine.core import TranscriptionEngine as TE

    kw = dict(model_path=assets["ckpt"], lan="en", vac=False, param_dtype="float32",
              log_level="ERROR", device="cpu")

    async def open_close(**extra):
        async with TH.TestHarness(**kw, **extra):
            pass

    asyncio.run(open_close())
    first = TE._instance
    asyncio.run(open_close())
    assert TE._instance is first  # cached
    asyncio.run(open_close(min_chunk_size=0.5))
    assert TE._instance is not first and len(TH._engine_cache) >= 2
    assert all(not isinstance(e, JE) for e in TH._engine_cache.values())
    assert all(not isinstance(e, TE) for e in JH._engine_cache.values())


def test_harness_without_a_device_needs_cuda(assets, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    async def main():
        async with TH.TestHarness(model_path=assets["ckpt"], lan="en", vac=False, log_level="ERROR"):
            pass

    with pytest.raises(RuntimeError, match='device="cpu"'):
        asyncio.run(main())


def test_engine_warmup_file_runs_one_inference(assets, caplog):
    """``warmup_file`` (the JAX engine's startup guard) runs on the port's
    audio/io.py: one inference over the file's first 5 s at engine start."""
    import logging

    from whisperlivekit_tpu_torch.engine.core import TranscriptionEngine

    TranscriptionEngine.reset()
    try:
        with caplog.at_level(logging.INFO, logger="whisperlivekit_tpu_torch.engine.core"):
            TranscriptionEngine(model_path=assets["ckpt"], lan="en", vac=False, param_dtype="float32",
                                warmup_file=assets["wav"], scheduler=False, device="cpu")
    finally:
        TranscriptionEngine.reset()
    assert "Warmup inference OK" in caplog.text


def test_load_audio_pcm_matches_jax(assets, tmp_path):
    assert TH.load_audio_pcm(assets["wav"]) == JH.load_audio_pcm(assets["wav"])
    import wave

    stereo = tmp_path / "stereo_8k.wav"
    rng = np.random.default_rng(4)
    with wave.open(str(stereo), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes(rng.integers(-20000, 20000, (8000, 2)).astype("<i2").tobytes())
    assert TH.load_audio_pcm(str(stereo)) == JH.load_audio_pcm(str(stereo))


# ---------------------------------------------------------------------------
# TestState: tests/test_harness_state.py's cases on both modules
# ---------------------------------------------------------------------------


def _state(pkg, lines=None, buffer="unstable tail"):
    import importlib

    H = TH if pkg == "torch" else JH
    timed = importlib.import_module(f"{PACKAGES[pkg]}.timed")
    if lines is None:
        lines = [timed.Segment(start=0.0, end=2.0, text=" hello there.", speaker=-1),
                 timed.SilentSegment(start=2.0, end=8.0),
                 timed.Segment(start=8.0, end=10.0, text=" welcome back.", speaker=2)]
    else:
        lines = [timed.Segment(start=s, end=e, text=t, speaker=-1) for s, e, t in lines]
    fd = timed.FrontData(status="active_transcription", lines=lines, buffer_transcription=buffer)
    return H.TestState.from_front_data(fd, audio_position=10.0)


def _text(st):
    return "hello there." in st.committed_text, st.text.endswith("unstable tail"), st.text


def _silence(st):
    return st.has_silence, st.silence_at(5.0), st.silence_at(1.0), len(st.silence_segments)


def _time_queries(st):
    return st.text_at(1.0), st.text_at(9.0), st.text_between(0, 3), st.lines_between(1.0, 9.0)


def _timing(st):
    return st.timing_valid, st.timing_monotonic, st.timing_errors, st.timestamps


def _wer(st):
    return (st.wer("hello there welcome back unstable tail"), st.wer("completely different words"),
            st.wer_detailed("Hello there, welcome BACK!", english=True))


def _speakers(st):
    return st.n_speakers, st.speaker_at(9.0), st.speakers_in(0, 10), st.n_speaker_changes, st.speaker_timeline


STATE_CASES = {"text": _text, "silence": _silence, "time_queries": _time_queries,
               "timing": _timing, "wer": _wer, "speakers": _speakers}


@pytest.mark.parametrize("case", sorted(STATE_CASES))
def test_test_state_matches_jax(case):
    jax_out, torch_out = (STATE_CASES[case](_state(p)) for p in ("jax", "torch"))
    assert torch_out == jax_out


def test_broken_timing_and_parse_time_match_jax():
    out = {}
    for p, H in (("jax", JH), ("torch", TH)):
        st = _state(p, lines=[(5.0, 3.0, "bad")], buffer="")
        out[p] = (st.timing_valid, st.timing_errors, H._parse_time("0:00:01.50"), H._parse_time("1:02:03.25"))
    assert out["torch"] == out["jax"]
    assert out["torch"][:1] == (False,) and out["torch"][2:] == (1.5, 3723.25)


# ---------------------------------------------------------------------------
# Normalizers and WER: tests/test_normalizers.py's cases on both modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["english", "number", "basic", "basic_diacritics", "basic_split"])
def test_normalizers_match_jax(kind, assets):
    def norm(m):
        return {"english": m.EnglishTextNormalizer, "number": m.EnglishNumberNormalizer,
                "basic": m.BasicTextNormalizer,
                "basic_diacritics": lambda: m.BasicTextNormalizer(remove_diacritics=True),
                "basic_split": lambda: m.BasicTextNormalizer(split_letters=True)}[kind]()

    jn, tn = norm(JN), norm(TN)
    cases = [c.lower() for c in CASES] if kind == "number" else CASES
    assert [tn(c) for c in cases] == [jn(c) for c in cases]


def test_spelling_asset_search_matches_jax(assets):
    """The same english.json is found first ($WLK_TPU_ASSET_DIR here)."""
    assert TN._find_spelling_asset() == JN._find_spelling_asset()
    assert TN.EnglishTextNormalizer()("the colour centre") == "the color center"


def test_wer_matches_jax():
    from whisperlivekit_tpu.harness import wer as JW
    from whisperlivekit_tpu_torch.harness import wer as TW

    pairs = [("the cat sat on the mat", "the cat sat on mat"), ("", "extra words"), ("", ""),
             ("Hello, World!", "hello world"), ("one two three", "four five six seven"),
             ("I'm twenty one", "i am 21")]
    for ref, hyp in pairs:
        for english in (False, True):
            assert TW.compute_wer(ref, hyp, english=english) == JW.compute_wer(ref, hyp, english=english)
    assert TW.normalize_text("  Ünïcode — TEXT!! ") == JW.normalize_text("  Ünïcode — TEXT!! ")


def test_harness_public_names_match_jax():
    public = [sorted(n for n, v in vars(m).items() if not n.startswith("_") and not inspect.ismodule(v))
              for m in (JH, TH)]
    assert public[1] == public[0]
