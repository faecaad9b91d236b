"""The port's LocalAgreement and windowed policies (streaming/local_agreement.py,
windowed.py, session_proxy.py, engine/core.py's ``LocalAgreementASR``) against
the JAX package's, on the CPU:

- tests/test_streaming_policies.py's ``HypothesisBuffer`` and
  ``OnlineASRProcessor`` cases and tests/test_windowed.py's cases, each run
  on both packages' classes with scripted batch backends;
- tests/test_engine_core.py's factory cases on the port's engine
  (``device="cpu"``, ``random:dev-tiny``);
- ``TestHarness(backend_policy="localagreement")`` and ``"windowed"`` of both
  packages over one dev-tiny checkpoint (written in ``tmp_path``, loaded by
  each package's own loader), the audio fed one 1 s chunk per
  re-transcription: the same committed words and timestamps, exactly. Both
  engines pin ``transcribe_kargs["temperature"] = 0.0``: with random weights
  every window falls back to sampling, where JAX draws from ``jax.random``
  and the port from a ``torch.Generator``. They also cap ``sample_len`` at
  32 tokens a window (random weights rarely sample end-of-text, so each
  window would otherwise decode 224), to keep the test short;
- concurrent ``transcribe`` calls on one shared backend (each session's
  worker thread) give the results of the same calls made one by one;
- one ``WS /asr`` stream, one REST post and one ``WS /v1/listen`` session
  through the port's ``create_app`` under ``localagreement``.
"""

import asyncio
import importlib
import sys
import threading
from typing import List

import numpy as np
import pytest
import torch

from whisperlivekit_tpu.models.whisper.dims import MODEL_DIMS
from whisperlivekit_tpu_torch.harness.vocab import write_standin_vocab
from torch_ckpt import canonical_state_dict, write_openai

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

PACKAGES = {"jax": "whisperlivekit_tpu", "torch": "whisperlivekit_tpu_torch"}
PINNED = dict(temperature=0.0, sample_len=32)  # the backends' transcribe_kargs in the e2e cases


def _mods(pkg):
    root = PACKAGES[pkg]
    return (importlib.import_module(f"{root}.streaming.local_agreement"),
            importlib.import_module(f"{root}.streaming.windowed"),
            importlib.import_module(f"{root}.timed"))


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return request.param


# ---------------------------------------------------------------------------
# HypothesisBuffer (tests/test_streaming_policies.py), on both packages
# ---------------------------------------------------------------------------


def _tok(pkg, start, end, text, p=None):
    return _mods(pkg)[2].ASRToken(start=start, end=end, text=text, probability=p)


def test_hb_commit_on_agreement(pkg):
    la, _, _ = _mods(pkg)
    hb = la.HypothesisBuffer()
    hb.insert([_tok(pkg, 0, 1, "hello"), _tok(pkg, 1, 2, "world")], 0)
    assert hb.flush() == []
    hb.insert([_tok(pkg, 0, 1, "hello"), _tok(pkg, 1, 2, "world"), _tok(pkg, 2, 3, "foo")], 0)
    committed = hb.flush()
    assert [t.text for t in committed] == ["hello", "world"]
    assert hb.last_committed_time == 2


def test_hb_disagreement_blocks_commit(pkg):
    la, _, _ = _mods(pkg)
    hb = la.HypothesisBuffer()
    hb.insert([_tok(pkg, 0, 1, "hello")], 0)
    hb.flush()
    hb.insert([_tok(pkg, 0, 1, "yellow")], 0)
    assert hb.flush() == []


def test_hb_ngram_dedup_against_committed_tail(pkg):
    la, _, _ = _mods(pkg)
    hb = la.HypothesisBuffer()
    hb.insert([_tok(pkg, 0, 1, "a"), _tok(pkg, 1, 2, "b")], 0)
    hb.flush()
    hb.insert([_tok(pkg, 0, 1, "a"), _tok(pkg, 1, 2, "b")], 0)
    assert [t.text for t in hb.flush()] == ["a", "b"]
    hb.insert([_tok(pkg, 1.95, 2.5, "b"), _tok(pkg, 2.5, 3, "c")], 0)
    assert [t.text for t in hb.new] == ["c"]


def test_hb_confidence_fast_path(pkg):
    la, _, _ = _mods(pkg)
    hb = la.HypothesisBuffer(confidence_validation=True)
    hb.insert([_tok(pkg, 0, 1, "sure", p=0.99)], 0)
    assert [t.text for t in hb.flush()] == ["sure"]


def test_hb_stale_tokens_dropped(pkg):
    la, _, _ = _mods(pkg)
    hb = la.HypothesisBuffer()
    hb.last_committed_time = 5.0
    hb.insert([_tok(pkg, 1, 2, "old"), _tok(pkg, 5.5, 6, "new")], 0)
    assert [t.text for t in hb.new] == ["new"]


def test_hb_pop_committed(pkg):
    la, _, _ = _mods(pkg)
    hb = la.HypothesisBuffer()
    hb.committed_in_buffer = [_tok(pkg, 0, 1, "a"), _tok(pkg, 1, 2, "b"), _tok(pkg, 2, 3, "c")]
    hb.pop_committed(2.0)
    assert [t.text for t in hb.committed_in_buffer] == ["c"]


# ---------------------------------------------------------------------------
# OnlineASRProcessor with a scripted batch backend, on both packages
# ---------------------------------------------------------------------------


class FakeBatchASR:
    """Scripted transcribe(): returns a fixed hypothesis per call."""

    sep = " "
    buffer_trimming = "segment"
    buffer_trimming_sec = 15.0
    confidence_validation = False
    tokenizer = None

    def __init__(self, pkg, scripts):
        self.pkg, self.scripts, self.calls = pkg, scripts, 0

    def transcribe(self, audio, init_prompt=""):
        words = self.scripts[min(self.calls, len(self.scripts) - 1)]
        self.calls += 1
        return {"segments": [{
            "end": words[-1].end if words else 0.0, "no_speech_prob": 0.0,
            "words": [{"start": w.start, "end": w.end, "word": w.text, "probability": None}
                      for w in words]}]}

    def ts_words(self, res):
        return [_tok(self.pkg, w["start"], w["end"], w["word"]) for w in res["segments"][0]["words"]]

    def segments_end_ts(self, res):
        return [s["end"] for s in res["segments"]]


def test_oasr_local_agreement_commits_prefix(pkg):
    la, _, _ = _mods(pkg)
    proc = la.OnlineASRProcessor(FakeBatchASR(pkg, [
        [_tok(pkg, 0, 1, "the"), _tok(pkg, 1, 2, "quick")],
        [_tok(pkg, 0, 1, "the"), _tok(pkg, 1, 2, "quick"), _tok(pkg, 2, 3, "fox")]]))
    proc.insert_audio_chunk(np.zeros(16000, np.float32))
    assert proc.process_iter()[0] == []
    proc.insert_audio_chunk(np.zeros(16000, np.float32))
    committed, upto = proc.process_iter()
    assert [t.text for t in committed] == ["the", "quick"]
    assert upto == pytest.approx(2.0)


def test_oasr_buffer_trimming_at_segment(pkg):
    la, _, _ = _mods(pkg)
    words = [_tok(pkg, i, i + 1, f"w{i}") for i in range(20)]
    asr = FakeBatchASR(pkg, [words, words])
    asr.buffer_trimming_sec = 10.0
    proc = la.OnlineASRProcessor(asr)
    proc.insert_audio_chunk(np.zeros(16000 * 20, np.float32))
    proc.process_iter()
    proc.process_iter()
    assert len(proc.audio_buffer) / 16000 < 20


def test_oasr_freeze_reset(pkg):
    la, _, _ = _mods(pkg)
    asr = FakeBatchASR(pkg, [[]])
    asr.buffer_trimming_sec = 2.0
    proc = la.OnlineASRProcessor(asr)
    proc.insert_audio_chunk(np.zeros(16000 * 5, np.float32))
    assert proc.process_iter()[0] == []
    assert proc.audio_buffer.size == 0
    assert proc.buffer_time_offset == pytest.approx(5.0)


def test_oasr_prompt_is_200_chars_of_committed_outside_buffer(pkg):
    la, _, _ = _mods(pkg)
    proc = la.OnlineASRProcessor(FakeBatchASR(pkg, [[]]))
    proc.committed = [_tok(pkg, i, i + 1, f"word{i}") for i in range(100)]
    proc.buffer_time_offset = 100.0
    prompt, _ = proc.prompt()
    assert len(prompt) <= 210 and prompt.endswith("word99")


def test_oasr_end_silence_short_inserts_gap(pkg):
    la, _, _ = _mods(pkg)
    proc = la.OnlineASRProcessor(FakeBatchASR(pkg, [[]]))
    proc.insert_audio_chunk(np.zeros(16000, np.float32))
    proc.end_silence(1.0, 0.0)
    assert proc.audio_buffer.size == 32000


def test_oasr_end_silence_long_resets(pkg):
    la, _, _ = _mods(pkg)
    proc = la.OnlineASRProcessor(FakeBatchASR(pkg, [[]]))
    proc.insert_audio_chunk(np.zeros(16000, np.float32))
    proc.end_silence(6.0, 1.0)
    assert proc.audio_buffer.size == 0
    assert proc.buffer_time_offset == pytest.approx(7.0)


# ---------------------------------------------------------------------------
# WindowedStreamingProcessor (tests/test_windowed.py), on both packages
# ---------------------------------------------------------------------------


class ScriptedASR:
    sep = " "
    buffer_trimming = "segment"
    buffer_trimming_sec = 15.0
    confidence_validation = False
    tokenizer = None

    def __init__(self, hypotheses=()):
        self.hypotheses, self.calls, self.prompts = list(hypotheses), 0, []

    def transcribe(self, audio, init_prompt=""):
        self.prompts.append(init_prompt)
        idx = min(self.calls, len(self.hypotheses) - 1)
        self.calls += 1
        return {"words": self.hypotheses[idx] if self.hypotheses else []}

    def ts_words(self, res):
        return list(res["words"])

    def segments_end_ts(self, res):
        return [res["words"][-1].end] if res["words"] else []


def _words(pkg, n, start=0.0, prefix="w"):
    return [_tok(pkg, start + i, start + i + 1, f"{prefix}{i}") for i in range(n)]


def _windowed(pkg, hyps, **kw):
    asr = ScriptedASR(hyps)
    return _mods(pkg)[1].WindowedStreamingProcessor(asr, **kw), asr


def test_win_holdback_delays_frontier_words(pkg):
    hyp = _words(pkg, 6)
    p, _ = _windowed(pkg, [hyp, hyp], window_sec=8.0, hold_back_words=2)
    p.insert_audio_chunk(np.zeros(16000 * 6, np.float32))
    p.process_iter()
    committed, _ = p.process_iter()
    assert [t.text for t in committed] == ["w0", "w1", "w2", "w3"]


def test_win_short_hypothesis_fully_held(pkg):
    hyp = _words(pkg, 2)
    p, _ = _windowed(pkg, [hyp, hyp], window_sec=8.0, hold_back_words=4)
    p.insert_audio_chunk(np.zeros(16000 * 2, np.float32))
    p.process_iter()
    assert p.process_iter()[0] == []


def test_win_window_bound_trims_audio(pkg):
    hyp = _words(pkg, 4)
    p, _ = _windowed(pkg, [hyp, hyp], window_sec=5.0, hold_back_words=2)
    p.insert_audio_chunk(np.zeros(16000 * 12, np.float32))
    p.process_iter()
    assert len(p.audio_buffer) / 16000 <= 12
    p.process_iter()
    assert len(p.audio_buffer) / 16000 <= 8


def test_win_sentence_reset_drops_window_behind_punctuation(pkg):
    hyp = [_tok(pkg, 0, 1, "done."), _tok(pkg, 1, 2, "next"), _tok(pkg, 2, 3, "words"),
           _tok(pkg, 3, 4, "x")]
    p, _ = _windowed(pkg, [hyp, hyp], window_sec=8.0, hold_back_words=1)
    p.insert_audio_chunk(np.zeros(16000 * 4, np.float32))
    p.process_iter()
    committed, _ = p.process_iter()
    assert any(t.text == "done." for t in committed)
    assert p.buffer_time_offset >= 1.0


def test_win_finish_flushes_without_holdback(pkg):
    hyp = _words(pkg, 3)
    p, _ = _windowed(pkg, [hyp, hyp, hyp], window_sec=8.0, hold_back_words=3)
    p.insert_audio_chunk(np.zeros(16000 * 3, np.float32))
    p.process_iter()
    assert p.process_iter()[0] == []
    remaining, _ = p.finish()
    texts = [t.text for t in p.committed + remaining]
    assert "w0" in texts and "w2" in texts


def test_win_chunk_sec_gates_retranscription(pkg):
    hyp = _words(pkg, 6)
    p, asr = _windowed(pkg, [hyp, hyp, hyp], hold_back_words=0, chunk_sec=2.0)
    p.insert_audio_chunk(np.zeros(16000, np.float32))
    out, _ = p.process_iter()
    assert asr.calls == 0 and out == []
    p.insert_audio_chunk(np.zeros(16000 * 2, np.float32))
    p.process_iter()
    assert asr.calls == 1
    p.process_iter()
    assert asr.calls == 1


def test_win_right_context_is_lookahead_only(pkg):
    hyp = _words(pkg, 6)
    p, _ = _windowed(pkg, [hyp, hyp], window_sec=8.0, hold_back_words=0)
    p.right_context_sec = 1.5
    p.insert_audio_chunk(np.zeros(16000 * 6, np.float32))
    p.process_iter()
    texts = [t.text for t in p.process_iter()[0]]
    assert "w3" in texts and "w4" not in texts and "w5" not in texts


def test_win_static_context_prepends_prompt(pkg):
    p, asr = _windowed(pkg, [_words(pkg, 4)], hold_back_words=0, context="medical dictation")
    p.insert_audio_chunk(np.zeros(16000 * 4, np.float32))
    p.process_iter()
    p.finish()
    assert len(asr.prompts) == 2 and all(c.startswith("medical dictation") for c in asr.prompts)


# ---------------------------------------------------------------------------
# The port's engine: factories (tests/test_engine_core.py), warmup
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WLK_TPU_ASSET_DIR", str(write_standin_vocab(tmp_path_factory.mktemp("vocab")).parent))
        yield


def _port_engine(**kw):
    from whisperlivekit_tpu_torch.config import WLKConfig
    from whisperlivekit_tpu_torch.engine.core import TranscriptionEngine

    TranscriptionEngine.reset()
    cfg = WLKConfig(model_size="random:dev-tiny", lan="en", vac=False, log_level="ERROR", **kw)
    try:
        return cfg, TranscriptionEngine(cfg, device="cpu")
    finally:
        TranscriptionEngine.reset()


def test_localagreement_factory_with_session_language(vocab):
    from whisperlivekit_tpu_torch.engine.core import LocalAgreementASR, online_factory
    from whisperlivekit_tpu_torch.streaming.local_agreement import OnlineASRProcessor, TorchWhisperASR
    from whisperlivekit_tpu_torch.streaming.session_proxy import SessionASRProxy

    cfg, eng = _port_engine(backend_policy="localagreement")
    assert isinstance(eng.asr, LocalAgreementASR) and isinstance(eng.asr.asr, TorchWhisperASR)
    assert eng.scheduler is None and eng.asr.decoder.model.device.type == "cpu"
    proc = online_factory(cfg, eng.asr, language="fr")
    assert type(proc) is OnlineASRProcessor
    assert isinstance(proc.asr, SessionASRProxy) and proc.asr._language == "fr"
    assert online_factory(cfg, eng.asr).asr is eng.asr.asr  # the server's language: no proxy


def test_windowed_factory(vocab):
    from whisperlivekit_tpu_torch.engine.core import online_factory
    from whisperlivekit_tpu_torch.streaming.windowed import WindowedStreamingProcessor

    cfg, eng = _port_engine(backend_policy="windowed", holdback_words=3)
    proc = online_factory(cfg, eng.asr)
    assert isinstance(proc, WindowedStreamingProcessor) and proc.hold_back_words == 3


def test_policy_number_2_and_beams_reach_the_backend(vocab):
    cfg, eng = _port_engine(backend_policy="2", beams=3, buffer_trimming_sec=9.0)
    assert cfg.backend_policy == "localagreement"
    assert eng.asr.asr.beam_size == 3 and eng.asr.asr.buffer_trimming_sec == 9.0


def test_localagreement_warmup_runs_one_transcription(vocab, caplog):
    import logging

    cfg, eng = _port_engine(backend_policy="localagreement")
    eng.asr.asr.transcribe_kargs.update(PINNED)
    calls = []
    real = eng.asr.asr.transcribe
    eng.asr.asr.transcribe = lambda audio, init_prompt="": calls.append(len(audio)) or real(audio, init_prompt)
    with caplog.at_level(logging.INFO, logger="whisperlivekit_tpu_torch.engine.core"):
        eng.warmup_synthetic()
    assert calls == [16000] and "Engine warmup complete" in caplog.text


def test_concurrent_transcribe_calls_match_serial(vocab):
    """Four sessions' worker threads transcribe at once on one backend, its
    ``_session_lock`` taken away and a short switch interval interleaving the
    threads finely: each result equals the same call made alone, so the
    decoder shares no state between calls (the lock is for speed)."""
    import contextlib

    from whisperlivekit_tpu_torch.harness.signals import speech_like

    _, eng = _port_engine(backend_policy="localagreement")
    asr = eng.asr.asr
    asr.transcribe_kargs.update(PINNED)
    asr._session_lock = contextlib.nullcontext()
    audios = [speech_like(8000 * (2 + i), seed=20 + i, f0=120.0 + 30 * i) for i in range(4)]
    prompts = ["", "one two", "", "three"]

    def words(res):
        return [(t.start, t.end, t.text, t.probability) for t in asr.ts_words(res)]

    serial = [words(asr.transcribe(a, init_prompt=p)) for a, p in zip(audios, prompts)]
    out: List = [None] * 4
    errors = []

    def run(i):
        try:
            out[i] = words(asr.transcribe(audios[i], init_prompt=prompts[i]))
        except Exception as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert out == serial and any(serial)


def test_transcribe_calls_run_one_at_a_time(vocab, monkeypatch):
    """``_session_lock``: a backend's concurrent ``transcribe`` calls (its
    sessions' worker threads, the server's REST requests) never overlap,
    the session proxy's language swap nests inside without deadlock, and a
    default-language call never runs while a proxy has swapped the
    language."""
    import time

    from whisperlivekit_tpu_torch.decoding import transcribe as X
    from whisperlivekit_tpu_torch.engine.core import online_factory

    cfg, eng = _port_engine(backend_policy="localagreement")
    inside, spans = [], []

    def fake(decoder, audio, language=None, **kw):
        inside.append(1)
        overlap = len(inside) > 1
        time.sleep(0.02)
        spans.append((overlap, language))
        inside.pop()
        return {"segments": []}

    monkeypatch.setattr(X, "transcribe", fake)
    backends = [online_factory(cfg, eng.asr).asr, online_factory(cfg, eng.asr, language="fr").asr] * 4
    threads = [threading.Thread(target=b.transcribe, args=(np.zeros(1600, np.float32),)) for b in backends]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(spans) == 8 and not any(o for o, _ in spans)
    assert sorted(lang for _, lang in spans) == ["en"] * 4 + ["fr"] * 4


# ---------------------------------------------------------------------------
# TestHarness of both packages over one checkpoint; WS /asr on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The stand-in vocabulary and a dev-tiny checkpoint (both harnesses'
    engines are dropped afterwards)."""
    from whisperlivekit_tpu.harness import harness as JH
    from whisperlivekit_tpu_torch.harness import harness as TH

    root = tmp_path_factory.mktemp("la")
    ckpt = write_openai(root / "tiny.pt", canonical_state_dict(MODEL_DIMS["dev-tiny"], seed=11),
                        MODEL_DIMS["dev-tiny"], np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WLK_TPU_ASSET_DIR", str(write_standin_vocab(root / "vocab").parent))
        yield dict(ckpt=str(ckpt), root=root)
    JH.reset_engine_cache()
    TH.reset_engine_cache()


def _speech(seconds: float, seed: int) -> np.ndarray:
    from whisperlivekit_tpu_torch.harness.signals import speech_like

    return speech_like(int(16000 * seconds), seed=seed, f0=130.0)


async def _stream_chunks(H, audio: np.ndarray, **kw):
    """Feed 1 s chunks, each after the previous one's re-transcription
    finished, so both packages transcribe the same buffers."""
    async with H.TestHarness(**kw) as h:
        h._processor.engine.asr.asr.transcribe_kargs.update(PINNED)
        for i in range(0, len(audio), 16000):
            await h.feed_audio(audio[i : i + 16000], speed=0, chunk_duration=1.0)
            want = i // 16000 + 1
            for _ in range(6000):
                if h.metrics.n_transcription_calls >= want:
                    break
                await asyncio.sleep(0.01)
            assert h.metrics.n_transcription_calls == want
        state = await h.finish(timeout=120)
        committed = [(t.start, t.end, t.text) for t in h._processor.transcription.committed]
        return state, committed, h.metrics.n_transcription_calls


@pytest.mark.parametrize("policy", ["localagreement", "windowed"])
def test_harness_commits_jax_words(assets, policy):
    from whisperlivekit_tpu.harness import harness as JH
    from whisperlivekit_tpu_torch.harness import harness as TH

    kw = dict(model_path=assets["ckpt"], lan="en", vac=False, param_dtype="float32",
              log_level="ERROR", backend_policy=policy)
    audio = _speech(4.0, seed=12)
    jstate, jwords, jcalls = asyncio.run(_stream_chunks(JH, audio, **kw))
    tstate, twords, tcalls = asyncio.run(_stream_chunks(TH, audio, device="cpu", **kw))
    assert tcalls == jcalls == 4
    assert twords == jwords
    assert tstate.text == jstate.text and tstate.text
    assert [(ln["start"], ln["end"], ln["text"]) for ln in tstate.lines] == [
        (ln["start"], ln["end"], ln["text"]) for ln in jstate.lines]
    assert tstate.timing_valid, tstate.timing_errors
    if policy == "localagreement":
        assert twords, "nothing was committed before the final flush"


def test_server_endpoints_under_localagreement(assets):
    """The port's server under ``localagreement``: one ``WS /asr`` stream,
    one ``POST /v1/audio/transcriptions`` and one ``WS /v1/listen``
    session, each answered with words."""
    import io
    import json

    from aiohttp.test_utils import TestClient, TestServer

    from whisperlivekit_tpu_torch.config import WLKConfig
    from whisperlivekit_tpu_torch.engine.core import TranscriptionEngine
    from whisperlivekit_tpu_torch.server.app import create_app
    from torch_ckpt import write_wav

    TranscriptionEngine.reset()
    config = WLKConfig(model_path=assets["ckpt"], lan="en", vac=False, pcm_input=True,
                       param_dtype="float32", log_level="ERROR", backend_policy="localagreement")
    engine = TranscriptionEngine(config, device="cpu")
    TranscriptionEngine.reset()
    engine.asr.asr.transcribe_kargs.update(PINNED)
    pcm = (np.clip(_speech(4.0, seed=13), -1, 1) * 32767).astype("<i2").tobytes()
    wav = write_wav(assets["root"] / "speech.wav", 3.0, seed=14).read_bytes()

    async def main():
        client = TestClient(TestServer(create_app(config, engine=engine)))
        await client.start_server()  # startup runs the engine's warmup transcription
        try:
            ws = await client.ws_connect("/asr")
            first = await ws.receive_json(timeout=60)
            for i in range(0, len(pcm), 32000):
                await ws.send_bytes(pcm[i : i + 32000])
            await ws.send_bytes(b"")
            msgs = []
            while True:
                msg = await ws.receive_json(timeout=120)
                if msg.get("type") == "ready_to_stop":
                    break
                msgs.append(msg)
            await ws.close()
            r = await client.post("/v1/audio/transcriptions",
                                  data={"file": io.BytesIO(wav), "response_format": "json"})
            rest = (r.status, await r.json())
            ws = await client.ws_connect("/v1/listen?language=en")
            listen = [await ws.receive_json(timeout=60)]
            await ws.send_bytes(pcm)
            await ws.send_str(json.dumps({"type": "Finalize"}))
            while not any(m.get("type") == "Results" and m["is_final"]
                          and m["channel"]["alternatives"][0]["transcript"] for m in listen):
                listen.append(await ws.receive_json(timeout=120))
            await ws.send_str(json.dumps({"type": "CloseStream"}))
            closed = (await ws.receive(timeout=60)).type.name
            return first, msgs, rest, listen, closed
        finally:
            await client.close()

    first, msgs, rest, listen, closed = asyncio.run(main())
    assert first["type"] == "config"
    texts = [ln["text"] for ln in msgs[-1]["lines"] if ln.get("text")]
    assert msgs and texts, msgs[-1]
    assert rest[0] == 200 and rest[1]["text"].strip(), rest
    assert listen[0]["type"] == "Metadata" and closed == "CLOSE"


@pytest.mark.parametrize("policy", ["localagreement", "windowed"])
def test_cli_transcribe_under_policy(assets, policy, capsys):
    """The CLI's ``transcribe --backend-policy`` (the TestHarness path) on
    the port: exit code 0 and the final text on stdout. Its engine is built
    ahead into the TestHarness cache, to pin ``PINNED``."""
    from whisperlivekit_tpu_torch import cli
    from whisperlivekit_tpu_torch.cli_args import parse_args
    from whisperlivekit_tpu_torch.engine.core import TranscriptionEngine
    from whisperlivekit_tpu_torch.harness import harness as TH
    from torch_ckpt import write_wav

    wav = write_wav(assets["root"] / f"cli_{policy}.wav", 1.5, seed=15)
    flags = ["--model-path", assets["ckpt"], "--lan", "en", "--no-vac", "--backend-policy", policy]
    kw = cli._harness_kwargs(parse_args(flags), "cpu")
    TH.reset_engine_cache()
    engine = TranscriptionEngine(**kw)
    TranscriptionEngine.reset()
    engine.asr.asr.transcribe_kargs.update(PINNED)
    TH._engine_cache[TH._cache_key(kw)] = engine
    try:
        rc = cli.main(["transcribe", str(wav), *flags], device="cpu")
        served = list(TH._engine_cache.values())
    finally:
        TH.reset_engine_cache()
    out = capsys.readouterr().out.strip()
    assert rc == 0 and out
    assert served == [engine] and engine.config.backend_policy == policy


def test_pipeline_with_vad_under_localagreement(assets):
    """tests/test_pipeline_e2e.py's LocalAgreement case on the port: voice
    activity detection on, speech-like audio, drain, finish; the timing
    holds together."""
    from whisperlivekit_tpu_torch.harness import harness as TH

    async def main():
        async with TH.TestHarness(model_path=assets["ckpt"], lan="en", vac=True, param_dtype="float32",
                                  log_level="ERROR", backend_policy="localagreement", device="cpu") as h:
            h._processor.engine.asr.asr.transcribe_kargs.update(PINNED)
            await h.feed_audio(_speech(2.5, seed=16), speed=0)
            await h.drain(2.0)
            final = await h.finish(timeout=60)
            assert final.timing_valid, final.timing_errors
            return final

    final = asyncio.run(main())
    TH.reset_engine_cache()
    assert final.status in ("active_transcription", "no_audio_detected")
