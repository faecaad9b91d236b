"""Diarization and translation through the port's pipeline on the CPU:

- the cases of tests/test_diarization.py, test_diart_backend.py (its
  injected pipeline factory), test_translation_sidecar.py (its FakeSidecar;
  they skip without ``websockets``, as the JAX module does) and
  test_translation_pipeline.py, on the port's modules;
- both packages' TestHarness on one dev-tiny checkpoint and one PCM with
  ``diarization=True`` (the energy backend, then Sortformer
  ``random:`` on the same weights) and ``target_language="fr"`` (echo,
  no NLLB weights on the machine): equal lines, speakers and translations;
- the engine: the factories build sessions, NLLB loads once for several
  sessions, a Sortformer checkpoint or an NLLB snapshot that fails to
  convert raises instead of falling back, and absent weights fall back.
"""

import asyncio
import io
import logging
import tarfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from whisperlivekit_tpu.diarization import sortformer_jax as JS
from whisperlivekit_tpu.harness import harness as JH
from whisperlivekit_tpu.models.whisper.dims import MODEL_DIMS
from whisperlivekit_tpu_torch.diarization import sortformer_model as TS
from whisperlivekit_tpu_torch.diarization.diart import DiartDiarization, DiartDiarizationOnline, _speaker_index
from whisperlivekit_tpu_torch.diarization.embedding import EmbeddingDiarization
from whisperlivekit_tpu_torch.engine import core as TC
from whisperlivekit_tpu_torch.harness import harness as TH
from whisperlivekit_tpu_torch.harness.vocab import StandinNLLBTokenizer, write_standin_vocab
from whisperlivekit_tpu_torch.session.alignment import TokensAlignment
from whisperlivekit_tpu_torch.timed import ASRToken, HypothesisTail, SpeakerSegment, State
from whisperlivekit_tpu_torch.translation import nllb as TL
from whisperlivekit_tpu_torch.translation import nllb_model as TN
from whisperlivekit_tpu_torch.translation.alignatt_client import AlignAttTranslationClient
from whisperlivekit_tpu_torch.translation.base import EchoTranslation
from test_diart_backend import FakePipeline
from test_diarization import voice
from test_sortformer_jax import synthetic_nemo_state_dict
from test_torch_nllb import hf_state_dict, _snapshot
from torch_ckpt import canonical_state_dict, write_openai

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

TINY = MODEL_DIMS["dev-tiny"]


def run(coro):
    return asyncio.run(coro)


async def _drain(d):
    segs = []
    while True:
        out = await d.diarize()
        if not out:
            return segs
        segs.extend(out)


# ---------------------------------------------------------------------------
# tests/test_diarization.py's cases
# ---------------------------------------------------------------------------


def test_embedding_distinguishes_two_synthetic_speakers():
    d = EmbeddingDiarization(max_speakers=4)

    async def main():
        segs = []
        for rep in range(2):
            d.insert_audio_chunk(voice(110, 3.0, seed=rep))
            segs += await _drain(d)
            d.insert_audio_chunk(voice(290, 3.0, seed=10 + rep))
            segs += await _drain(d)
        return segs

    segs = run(main())
    assert len(segs) == 12
    assert len({s.speaker for s in segs}) >= 2
    assert len({s.speaker for s in segs[:3]}) == 1


def test_embedding_silence_shifts_offset_and_zero_audio_yields_nothing():
    d = EmbeddingDiarization()

    async def main():
        d.insert_audio_chunk(voice(150, 1.0, 0))
        first = await d.diarize()
        d.insert_silence(5.0)
        d.insert_audio_chunk(voice(150, 1.0, 1))
        second = await d.diarize()
        d.insert_audio_chunk(np.zeros(16000, np.float32))
        return first, second, await d.diarize()

    first, second, silent = run(main())
    assert first[0].start == 0.0 and second[0].start == pytest.approx(6.0) and silent == []


def _alignment(tokens, segments):
    class Args:
        diarization = True

    ta = TokensAlignment(State(), Args(), sep=" ")
    ta.all_tokens = [ASRToken(start=s, end=e, text=t) for s, e, t in tokens]
    ta.all_diarization_segments = [SpeakerSegment(start=s, end=e, speaker=k) for s, e, k in segments]
    return ta.get_lines_diarization()


def test_speaker_attribution_cases():
    lines, _ = _alignment([(0.0, 1.0, "hello"), (1.0, 2.0, " world."), (2.2, 3.0, "hi"), (3.0, 4.0, " there.")],
                          [(0.0, 2.1, 0), (2.1, 4.5, 1)])
    assert [ln.speaker for ln in lines] == [1, 2]
    assert [ln.text for ln in lines] == ["hello world.", "hi there."]
    _, buffer = _alignment([(0.0, 1.0, "spoken."), (5.0, 6.0, "late.")], [(0.0, 2.0, 0)])
    assert "late." in buffer
    lines, _ = _alignment([(0.0, 1.0, "one."), (1.0, 2.0, " two.")], [(0.0, 2.5, 0)])
    assert [ln.text for ln in lines] == ["one. two."]


# ---------------------------------------------------------------------------
# tests/test_diart_backend.py's cases (diart is not installed: the factory
# is injected)
# ---------------------------------------------------------------------------


def test_diart_blocks_replace_semantics_and_silence():
    assert [_speaker_index(x) for x in ("speaker0", "SPEAKER_03", "unknown")] == [0, 3, 0]
    sess = DiartDiarizationOnline(FakePipeline())
    sess.insert_audio_chunk(np.zeros(16000, np.float32))
    segs = run(sess.diarize())
    assert len(segs) == 2 and all(s.speaker == 0 for s in segs) and segs[-1].end == 1.0
    sess.insert_audio_chunk(np.zeros(8000, np.float32))
    segs = run(sess.diarize())
    assert segs[-1].speaker == 1 and (segs[-1].start, segs[-1].end) == (0.0, 1.5)

    pipe = FakePipeline()
    sess = DiartDiarizationOnline(pipe)
    sess.insert_audio_chunk(np.zeros(4000, np.float32))
    assert run(sess.diarize()) == [] and pipe.calls == 0
    sess.insert_audio_chunk(np.zeros(4000, np.float32))
    assert len(run(sess.diarize())) == 1 and pipe.calls == 1

    sess = DiartDiarizationOnline(FakePipeline())
    sess.insert_silence(10.0)
    sess.insert_audio_chunk(np.zeros(8000, np.float32))
    assert run(sess.diarize())[0].start == 10.0


def test_diart_holder_injected_factory_and_missing_package():
    holder = DiartDiarization(pipeline_factory=FakePipeline)
    assert holder.new_session().pipeline is not holder.new_session().pipeline
    with pytest.raises(ImportError, match="diart"):
        DiartDiarization(config=None)
    from whisperlivekit_tpu_torch.diarization import load_diarization_model

    with pytest.raises(ImportError, match="diart"):  # through the engine's loader as well
        load_diarization_model(SimpleNamespace(diarization_backend="diart"))


# ---------------------------------------------------------------------------
# tests/test_translation_pipeline.py's cases
# ---------------------------------------------------------------------------


def _tok(start, end, text):
    return ASRToken(start=start, end=end, text=text)


def test_echo_translation_emits_on_punctuation_and_flushes():
    t = EchoTranslation("en", "fr")
    t.insert_tokens([_tok(0, 1, " hello")])
    out, buf = t.process()
    assert out is None and buf.text == " hello"
    t.insert_tokens([_tok(1, 2, " world.")])
    out, _ = t.process()
    assert (out.text, out.start, out.end) == (" hello world.", 0, 2)
    t.insert_tokens([_tok(2, 3, " unfinished")])
    assert t.validate_buffer_and_reset()[0].text == " unfinished"
    assert t.validate_buffer_and_reset()[0] is None


def _client(url="ws://localhost:1", latency="low"):
    cfg = SimpleNamespace(alignatt_url=url, alignatt_latency=latency, alignatt_context="")
    return AlignAttTranslationClient(cfg, "en", "fr")


def test_alignatt_client_collects_degrades_and_falls_back():
    c = _client()
    c.insert_tokens([_tok(0, 1, " word"), HypothesisTail(start=1, end=2, text="draft")])
    assert len(c._committed_words) == 1 and c._tail.text == "draft"
    c = _client()
    c.insert_tokens([_tok(0, 1, " word.")])
    out, _ = c.process()  # connection refused -> backoff, no crash
    assert out is None and c._down_until > 0
    c = _client()
    c.insert_tokens([_tok(0, 1, " fin.")])
    assert c.validate_buffer_and_reset()[0].text == " fin."


# ---------------------------------------------------------------------------
# tests/test_translation_sidecar.py's cases, against its FakeSidecar
# ---------------------------------------------------------------------------


@pytest.fixture
def sidecar():
    pytest.importorskip("websockets")
    from test_translation_sidecar import FakeSidecar

    return FakeSidecar


def _sidecar_client(url, latency="balanced"):
    c = _client(url, latency)
    c._min_interval = 0.0  # the cases drive pacing explicitly
    return c


def _wtok(i, text, punct=False):
    return ASRToken(start=float(i), end=float(i + 1), text=f" {text}" + ("." if punct else ""))


def test_sidecar_commit_monotonic_and_reconnect_resume(sidecar):
    async def main():
        side = sidecar()
        url = await side.start()
        c = _sidecar_client(url)
        targets = []
        for i in range(3):
            c.insert_tokens([_wtok(i, f"w{i}")])
            c.insert_tokens(HypothesisTail(text=f"h{i}"))
            _, buf = await c.process_async()
            targets.append(buf.text)
            c._last_call_at = 0.0
        side.drop_next = 1
        c.insert_tokens([_wtok(3, "beta")])
        _, dropped = await c.process_async()
        prefix_after_drop = c.accepted_target_prefix
        c._down_until = c._last_call_at = 0.0
        _, buf = await c.process_async()
        await side.stop()
        return targets, dropped, prefix_after_drop, buf, side, c

    targets, dropped, prefix_after_drop, buf, side, c = run(main())
    assert targets[0].startswith(" T(w0)") and "d(h2)" in targets[-1]
    for a, b in zip(targets, targets[1:]):
        assert b.startswith(a.split(" d(")[0])
    assert dropped.text == prefix_after_drop  # graceful degradation: the last good text
    resume = side.handshakes[-1]
    assert resume["accepted_target_prefix"] == prefix_after_drop
    assert [w["text"] for w in resume["committed_words"]] == [" w0", " w1", " w2", " beta"]
    assert "T(beta)" in c.accepted_target_prefix


def test_sidecar_preset_pacing_and_punctuation_final(sidecar):
    from whisperlivekit_tpu_torch.translation.alignatt_client import LATENCY_PRESETS

    async def main():
        side = sidecar()
        url = await side.start()
        c = _client(url, "low")
        c._min_interval = 10.0
        c.insert_tokens([_wtok(0, "a")])
        await c.process_async()
        c.insert_tokens([_wtok(1, "b")])
        await c.process_async()  # paced out
        n_updates = len(side.updates)
        f = _sidecar_client(url)
        f.insert_tokens([_wtok(0, "done", punct=True)])
        final, _ = await f.process_async()
        await side.stop()
        return side, n_updates, final

    side, n_updates, final = run(main())
    assert side.handshakes[0]["preset"] == LATENCY_PRESETS["low"] and n_updates == 1
    assert final is not None and "T(done.)" in final.text


def test_sidecar_backoff_grows_while_down():
    pytest.importorskip("websockets")

    async def main():
        c = _sidecar_client("ws://127.0.0.1:1")
        c.insert_tokens([_wtok(0, "a")])
        await c.process_async()
        b1 = c._backoff
        c._down_until = c._last_call_at = 0.0
        await c.process_async()
        return b1, c._backoff

    b1, b2 = run(main())
    assert b2 > b1 >= 2.0


# ---------------------------------------------------------------------------
# Both packages' TestHarness: diarization and translation end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The stand-in vocabulary, a dev-tiny checkpoint, two voices' PCM and
    an empty HOME (no NLLB snapshot: translation echoes)."""
    root = tmp_path_factory.mktemp("diar_tr")
    vocab_dir = write_standin_vocab(root / "assets").parent
    ckpt = write_openai(root / "tiny.pt", canonical_state_dict(TINY, seed=3), TINY, np.float32)
    audio = np.concatenate([voice(110, 3.0, seed=0), voice(290, 3.0, seed=1), voice(110, 2.0, seed=2)])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WLK_TPU_ASSET_DIR", str(vocab_dir))
        mp.setenv("HOME", str(root / "home"))
        yield dict(ckpt=str(ckpt), audio=audio, root=root)
    JH.reset_engine_cache()
    TH.reset_engine_cache()


def _harness(H, audio, **kwargs):
    async def main():
        async with H.TestHarness(**kwargs) as h:
            await h.feed_audio(audio, speed=0)
            await h.drain(1.0)
            state = await h.finish(timeout=120)
            proc = h._processor
            return state, type(proc.diarization).__name__, type(proc.translation).__name__
    try:
        return run(main())
    finally:
        H.reset_engine_cache()


def _lines(state):
    return [(ln.get("speaker"), ln.get("text"), ln.get("translation")) for ln in state.lines]


def _jax_sortformer_weights(dims, seed=0, dtype=torch.float32, device="cpu"):
    """What the JAX package's ``random:`` loads (PRNGKey(0)), bridged."""
    jp = JS.init_params(JS.DEV_TINY, jax.random.PRNGKey(seed))
    return TS.sortformer_params_from_jax(jax.tree.map(np.asarray, jp), dims).to(device)


@pytest.mark.parametrize("backend", ["energy", "sortformer"])
def test_harness_diarization_and_translation_match_jax(assets, backend, monkeypatch):
    kw = dict(model_path=assets["ckpt"], lan="en", vac=False, param_dtype="float32", log_level="ERROR",
              diarization=True, diarization_backend=backend, target_language="fr")
    if backend == "sortformer":
        kw["sortformer_model_path"] = "random:"
        monkeypatch.setattr(TS, "init_params", _jax_sortformer_weights)
    jstate, jdiar, jtr = _harness(JH, assets["audio"], **kw)
    tstate, tdiar, ttr = _harness(TH, assets["audio"], device="cpu", **kw)
    assert (tdiar, ttr) == (jdiar, jtr) == (
        {"energy": "EnergyDiarization", "sortformer": "SortformerDiarizationOnline"}[backend], "EchoTranslation")
    assert tstate.text == jstate.text and tstate.text
    assert _lines(tstate) == _lines(jstate)
    assert tstate.speakers == jstate.speakers and tstate.speakers
    assert any(tr for _, _, tr in _lines(tstate)), "an echo translation must reach the lines"


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


@pytest.fixture
def engine_env(tmp_path, monkeypatch):
    vocab_dir = write_standin_vocab(tmp_path / "assets").parent
    monkeypatch.setenv("WLK_TPU_ASSET_DIR", str(vocab_dir))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    TC.TranscriptionEngine.reset()
    yield tmp_path
    TC.TranscriptionEngine.reset()


def _engine(**kw):
    TC.TranscriptionEngine.reset()
    base = dict(model_size="random:dev-tiny", lan="en", vac=False, param_dtype="float32", scheduler=False,
                log_level="ERROR")
    return TC.TranscriptionEngine(device="cpu", **{**base, **kw})


def test_factories_build_sessions(engine_env):
    eng = _engine(diarization=True, diarization_backend="energy", target_language="fr")
    assert type(TC.online_diarization_factory(eng.config, eng.diarization_model)).__name__ == "EnergyDiarization"
    tr = TC.online_translation_factory(eng.config, eng.translation_model)
    de = TC.session_translation_factory(eng.config, eng.translation_model, "de")
    assert isinstance(tr, EchoTranslation) and (tr.src, tr.tgt, de.tgt) == ("en", "fr", "de")
    assert TC.online_diarization_factory(eng.config, None) is None
    assert TC.online_translation_factory(eng.config, None) is None
    assert TC.session_translation_factory(eng.config, None, "de") is None


def test_absent_weights_fall_back(engine_env, caplog):
    with caplog.at_level(logging.WARNING):
        eng = _engine(diarization=True, target_language="fr")  # no sortformer_model_path, no NLLB snapshot
        sess = eng.translation_model.new_session("en", "fr")
    assert type(eng.diarization_model).__name__ == "_Shared"  # the embedding backend
    assert isinstance(sess, EchoTranslation)
    assert "Sortformer unavailable" in caplog.text and "NLLB unavailable" in caplog.text


def _write_nemo(path, sd):
    buf = io.BytesIO()
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, buf)
    with tarfile.open(path, "w") as tar:
        info = tarfile.TarInfo("model_weights.ckpt")
        info.size = buf.getbuffer().nbytes
        buf.seek(0)
        tar.addfile(info, buf)
    return path


def test_sortformer_checkpoint_loads_and_a_bad_one_raises(engine_env):
    sd = synthetic_nemo_state_dict(JS.DEV_TINY, seed=1)
    good = _write_nemo(engine_env / "good.nemo", sd)
    eng = _engine(diarization=True, sortformer_model_path=str(good))
    shared = eng.diarization_model
    assert type(shared).__name__ == "SortformerDiarization" and shared.params.device.type == "cpu"
    want, _ = TS.convert_nemo_state_dict(sd)
    assert all(torch.equal(shared.params.state_dict()[k], v) for k, v in want.state_dict().items())
    sd["encoder.layers.0.mystery.weight"] = np.zeros(3, np.float32)
    bad = _write_nemo(engine_env / "bad.nemo", sd)
    with pytest.raises(ValueError, match="unmapped"):
        _engine(diarization=True, sortformer_model_path=str(bad))


def test_nllb_conversion_failure_raises_through_the_engine(engine_env):
    from whisperlivekit_tpu_torch.session.processor import AudioProcessor

    tdims = TN.NLLB_SIZES["dev-tiny"]
    sd = hf_state_dict(tdims, seed=2)
    del sd["model.decoder.layers.0.encoder_attn.k_proj.weight"]
    snap = _snapshot(engine_env / "home", sd, tdims)
    assert snap.exists()
    eng = _engine(target_language="fr")
    with pytest.raises(KeyError, match="encoder_attn.k_proj"):
        AudioProcessor(transcription_engine=eng)
    with pytest.raises(KeyError):
        TC.online_translation_factory(eng.config, eng.translation_model)
    assert eng.translation_model.nllb is None


def test_engine_loads_nllb_once_for_many_sessions(engine_env, monkeypatch):
    dims = TN.NLLB_SIZES["dev-tiny"]
    loads = []

    def fake_load(config, device=None):
        loads.append(device)
        return TL.NLLBModel(TN.init_params(dims, seed=0, device="cpu"), dims, StandinNLLBTokenizer())

    monkeypatch.setattr(TL, "load_nllb", fake_load)
    eng = _engine(target_language="fr")
    sessions = [TC.online_translation_factory(eng.config, eng.translation_model) for _ in range(3)]
    sessions.append(TC.session_translation_factory(eng.config, eng.translation_model, "de"))
    assert loads == [torch.device("cpu")]
    assert all(isinstance(s, TL.NLLBOnlineTranslation) and s.model is sessions[0].model for s in sessions)
    sessions[0].insert_tokens([_tok(0.0, 0.5, " bonjour.")])
    tr, _ = sessions[0].process()
    assert tr is not None and tr.text
    assert eng.translation_model.new_session("en", "fr").model is sessions[0].model


def test_sortformer_without_cuda_raises_not_falls_back(engine_env, monkeypatch):
    """The loader asks for the card when no device is given: without CUDA it
    raises, where the JAX package would have served the fallback."""
    from whisperlivekit_tpu_torch.diarization import load_diarization_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        load_diarization_model(SimpleNamespace(diarization_backend="sortformer", sortformer_model_path="random:"))
