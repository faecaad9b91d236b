"""Session-level tests of whisperlivekit_tpu_torch on the CPU, with the
stand-in vocabulary (harness/vocab.py) in place of the unvendored BPE ranks:

- both packages' AlignAttSessions, driven through run_tick_batch with an
  AudioPool and an EncPool, commit identical token ids tick by tick;
- the port's BatchScheduler + SimulStreamingOnlineProcessor return words for
  concurrent sessions;
- the port's server answers /health and streams one WS /asr session;
- the port and chip_smoke.py import without JAX.
"""

import asyncio
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperlivekit_tpu.models.whisper import model as JM
from whisperlivekit_tpu.models.whisper.dims import MODEL_DIMS
from whisperlivekit_tpu.models.whisper.tokenizer import get_tokenizer
from whisperlivekit_tpu.streaming import alignatt as JA
from whisperlivekit_tpu_torch.harness.vocab import write_standin_vocab
from whisperlivekit_tpu_torch.models.whisper import model as TM
from whisperlivekit_tpu_torch.streaming import alignatt as TA

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

REPO = Path(__file__).resolve().parent.parent
DIMS = MODEL_DIMS["dev-tiny"]


@pytest.fixture(scope="module")
def tok(tmp_path_factory):
    """The stand-in vocabulary, visible to the engines built in this module
    (the environment is restored afterwards)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WLK_TPU_ASSET_DIR", str(write_standin_vocab(tmp_path_factory.mktemp("vocab")).parent))
        yield get_tokenizer(True, language="en", task="transcribe")


def speechlike(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    sig = 0.3 * np.sin(2 * np.pi * (170 + 45 * seed) * t) * (1 + 0.4 * np.sin(2 * np.pi * 3.1 * t))
    return (sig + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)


def test_standin_vocab_gives_whisper_layout(tok):
    assert (tok.eot, tok.sot, tok.no_speech, tok.timestamp_begin) == (50257, 50258, 50362, 50364)
    assert tok.encode(" ") == [32]
    for text in ("hello world", " The quick brown fox, 42 times!"):
        assert tok.decode(tok.encode(text)) == text


def test_sessions_commit_identical_tokens(tok):
    """Two packed sessions per tick, ~6 s of audio in 0.75 s steps (an
    eviction and re-anchor at audio_max_len=4 s): the committed token ids of
    both packages are equal after every tick."""
    jp = JM.init_params(DIMS, jax.random.PRNGKey(0), jnp.float32)
    tm = TM.params_from_jax_numpy(jax.tree.map(np.asarray, jp), DIMS)
    cfg = dict(language="en", max_steps=4, audio_max_len=4.0,
               enc_tail_frames=128, enc_rewrite_margin=16)
    je = JA.AlignAttEngine(jp, DIMS, tok, JA.AlignAttConfig(**cfg))
    te = TA.AlignAttEngine(tm, DIMS, tok, TA.AlignAttConfig(**cfg))

    from whisperlivekit_tpu.streaming.dispatch import run_tick_batch as jax_run
    from whisperlivekit_tpu_torch.streaming.dispatch import run_tick_batch as torch_run
    from whisperlivekit_tpu.streaming.pools import AudioPool as JAudio, EncPool as JEnc
    from whisperlivekit_tpu_torch.streaming.pools import AudioPool as TAudio, EncPool as TEnc

    sides = []
    for mod, eng, run, pools in (
        (JA, je, jax_run, (JAudio(4), JEnc(4, DIMS, dtype=jnp.float32))),
        (TA, te, torch_run, (TAudio(4), TEnc(4, DIMS, dtype=torch.float32))),
    ):
        sessions = []
        for _ in range(2):
            s = mod.AlignAttSession(eng)
            s.pool, s.enc_pool = pools
            sessions.append(s)
        sides.append((eng, run, pools, sessions))

    audio = [speechlike(6.0, i) for i in range(2)]
    step = 12000
    modes = []
    for tick in range(8):
        committed = []
        for eng, run, (apool, epool), sessions in sides:
            tis = []
            for s, a in zip(sessions, audio):
                s.insert_audio(a[tick * step : (tick + 1) * step])
                tis.append(s.prepare_tick(is_last=tick == 7))
            outs = run(eng, tis, tok, pool=apool, enc_pool=epool)
            for s, ti, o in zip(sessions, tis, outs):
                s.finish_tick(ti, o)
            modes.append(tuple(ti.enc_mode for ti in tis))
            committed.append([[list(c) for c in s.committed_tokens] for s in sessions])
        assert committed[0] == committed[1], f"tick {tick}"
    assert any("inc" in m for m in modes) and modes.count(("anchor", "anchor")) >= 4
    assert any(sum(len(c) for c in s.committed_tokens) for s in sides[1][3])


def test_scheduler_returns_words_for_concurrent_sessions(tok):
    from whisperlivekit_tpu_torch.engine.scheduler import BatchScheduler
    from whisperlivekit_tpu_torch.streaming.simul_processor import SimulStreamingOnlineProcessor

    model = TM.init_params(DIMS, torch.Generator().manual_seed(0))
    engine = TA.AlignAttEngine(
        model, DIMS, tok, TA.AlignAttConfig(language="en", max_steps=8, enc_tail_frames=128)
    )

    async def main():
        sched = BatchScheduler(engine, max_lanes=4, window_s=0.05)
        procs = [SimulStreamingOnlineProcessor(engine, scheduler=sched) for _ in range(2)]
        words = [[], []]
        for sec in range(3):
            for i, p in enumerate(procs):
                p.insert_audio_chunk(speechlike(1.0, 10 + i) * (sec + 1) / 3, sec + 1.0)
            outs = await asyncio.gather(*(p.process_iter_async() for p in procs))
            for i, (tokens, upto) in enumerate(outs):
                assert upto == pytest.approx(sec + 1.0)
                words[i] += tokens
        for p in procs:
            p.close()
        return sched.stats(), words

    stats, words = asyncio.run(main())
    assert stats["n_lanes_served"] == 6
    assert stats["n_failed_ticks"] == 0
    assert stats["n_ticks"] <= 4  # the two sessions' ticks were packed
    assert set(stats["tick_phases"]) >= {"anchor", "inc"}
    for w in words:
        assert w and all(t.text for t in w)


def test_failed_tick_is_counted_and_fails_the_smoke(tok, monkeypatch):
    """A tick that raises returns no words to the session (the processor
    logs and carries on), so the scheduler counts it and chip_smoke.py's log
    watch turns the logged failure into a failed run."""
    import logging

    from whisperlivekit_tpu_torch.engine import scheduler as S
    from whisperlivekit_tpu_torch.streaming.simul_processor import SimulStreamingOnlineProcessor

    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))

    def broken_tick(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(S, "run_tick_batch", broken_tick)
    model = TM.init_params(DIMS, torch.Generator().manual_seed(0))
    engine = TA.AlignAttEngine(model, DIMS, tok, TA.AlignAttConfig(language="en", max_steps=4))
    watch = chip_smoke.LogWatch()
    logging.getLogger().addHandler(watch)
    try:
        async def main():
            sched = S.BatchScheduler(engine, max_lanes=4, window_s=0.01)
            proc = SimulStreamingOnlineProcessor(engine, scheduler=sched)
            proc.insert_audio_chunk(speechlike(1.0, 3), 1.0)
            out = await proc.process_iter_async()
            proc.close()
            return sched.stats(), out
        stats, (tokens, _) = asyncio.run(main())
        logging.getLogger("whisperlivekit_tpu_torch.engine.core").warning("Initializing RANDOM weights")
    finally:
        logging.getLogger().removeHandler(watch)
    assert tokens == [] and stats["n_failed_ticks"] == 1
    assert any("batch tick failed" in f for f in watch.failures)
    assert watch.expected == 1


@pytest.mark.parametrize("case, ws_lang, ws_lines, ws_ticked, ok", [
    ("ws detected, its lines hold only a pre-detection buffer", "yi", [("a b", None)], True, True),
    ("ws detected, its lines carry the language", "yi", [("a", "yi"), ("b", None)], True, True),
    ("ws never detected", None, [("a b", None)], True, False),
    ("ws lines carry another language", "yi", [("a", "en")], True, False),
    ("ws session never prepared a tick", None, [], False, False),
])
def test_smoke_reads_each_sessions_language_on_the_server(case, ws_lang, ws_lines, ws_ticked, ok):
    """The smoke's language check reads every session's detected language
    from its server-side session, the one behind ``WS /asr`` included: a
    session's lines carry a language only once words are committed after the
    detection, so they may hold none even when the session detected."""
    from types import SimpleNamespace

    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))

    own = [SimpleNamespace(detected_language="yi") for _ in range(2)]
    procs = [SimpleNamespace(transcription=SimpleNamespace(model=s)) for s in own]
    ticked = own + ([SimpleNamespace(detected_language=ws_lang)] if ws_ticked else [])
    ins = SimpleNamespace(sessions={id(s): s for s in ticked})
    texts = [[("a", "yi")], [("b", None)], ws_lines]
    langs, line_langs = chip_smoke._session_languages(ins, procs, texts)
    run = dict(detect_ms=[1.0] * sum(bool(s.detected_language) for s in ticked),
               langs=langs, line_langs=line_langs)
    if ok:
        chip_smoke._check_languages("front", run)
        assert langs == ["yi"] * 3
    else:
        with pytest.raises(AssertionError):
            chip_smoke._check_languages("front", run)


def test_server_health_and_asr_stream(tok):
    from aiohttp.test_utils import TestClient, TestServer

    from whisperlivekit_tpu_torch.config import WLKConfig
    from whisperlivekit_tpu_torch.engine.core import TranscriptionEngine
    from whisperlivekit_tpu_torch.server.app import WLKServer

    TranscriptionEngine.reset()
    config = WLKConfig(model_size="random:dev-tiny", lan="en", pcm_input=True, vac=False,
                       param_dtype="float32", log_level="ERROR")
    engine = TranscriptionEngine(config, device="cpu")
    pcm = (np.clip(speechlike(3.0, 3), -1, 1) * 32767).astype("<i2").tobytes()

    async def main():
        client = TestClient(TestServer(WLKServer(config, engine=engine).app))
        await client.start_server()
        try:
            health = await (await client.get("/health")).json()
            rest = await client.post("/v1/audio/transcriptions")
            ws = await client.ws_connect("/asr")
            msgs = [await ws.receive_json(timeout=60)]
            for i in range(0, len(pcm), 16000):
                await ws.send_bytes(pcm[i : i + 16000])
            await ws.send_bytes(b"")
            while msgs[-1].get("type") != "ready_to_stop":
                msgs.append(await ws.receive_json(timeout=120))
            await ws.close()
            return health, rest.status, msgs
        finally:
            await client.close()

    try:
        health, rest_status, msgs = asyncio.run(main())
    finally:
        TranscriptionEngine.reset()
    assert health["status"] == "ok" and health["backend"] == "torch" and health["ready"]
    assert "scheduler" in health
    assert rest_status == 400  # the REST endpoint is served: a post without a file is refused
    assert msgs[0]["type"] == "config"
    texts = [ln.get("text", "") for m in msgs for ln in m.get("lines", [])]
    assert any(t.strip() for t in texts), msgs[-3:]


def test_port_imports_without_jax():
    """A meta-path finder refuses jax, jaxlib and the JAX package itself;
    every module of the port (walked with pkgutil) and chip_smoke.py still
    import (import only, main() is not run). The smoke names no module of
    the JAX package."""
    smoke = (REPO / "chip_smoke.py").read_text()
    assert not re.search(r"\bwhisperlivekit_tpu\.", smoke)
    assert not re.search(r"\bfrom whisperlivekit_tpu import|\bimport whisperlivekit_tpu\b", smoke)
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        REFUSED = ("jax", "jaxlib", "whisperlivekit_tpu")
        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in REFUSED:
                    raise ImportError("refused in this process: " + name)
                return None
        sys.meta_path.insert(0, Refuse())
        import whisperlivekit_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        assert not any(m.split(".")[0] in REFUSED for m in sys.modules)
        print(" ".join(names))
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    imported = set(proc.stdout.split())
    for name in ("engine.core", "session.processor", "server.app", "streaming.dispatch",
                 "ops.mel_pallas", "decoding.task", "config", "native", "server.web"):
        assert f"whisperlivekit_tpu_torch.{name}" in imported, name


def test_engine_without_a_device_raises_without_cuda(monkeypatch):
    """The entry points serve on the card: without CUDA they raise, naming
    device="cpu", rather than fall back to the CPU unasked."""
    from whisperlivekit_tpu_torch.config import WLKConfig
    from whisperlivekit_tpu_torch.engine import core

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = WLKConfig(model_size="random:dev-tiny", lan="en", vac=False, param_dtype="float32")
    core.TranscriptionEngine.reset()
    try:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            core.TranscriptionEngine(config)
    finally:
        core.TranscriptionEngine.reset()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        core.load_whisper_params(config)
    model, dims, name = core.load_whisper_params(config, device="cpu")
    assert model.device.type == "cpu" and name == "dev-tiny"


# ---------------------------------------------------------------------------
# Language auto-detect
# ---------------------------------------------------------------------------


def _port_tokenizer(language="en"):
    from whisperlivekit_tpu_torch.models.whisper.tokenizer import get_tokenizer as port_get

    return port_get(True, language=language, task="transcribe")


def test_detect_language_matches_jax(tok):
    """One decoder step from [sot] over the same encoder features: the same
    codes, and every language's probability within 1e-5."""
    from whisperlivekit_tpu.decoding.task import WhisperDecoder as JD
    from whisperlivekit_tpu_torch.decoding.task import WhisperDecoder as TD

    jp = JM.init_params(DIMS, jax.random.PRNGKey(0), jnp.float32)
    tm = TM.params_from_jax_numpy(jax.tree.map(np.asarray, jp), DIMS)
    enc = np.random.default_rng(8).standard_normal(
        (3, DIMS.n_audio_ctx, DIMS.n_audio_state)).astype(np.float32)
    jcodes, jprobs = JD(jp, DIMS).detect_language(jnp.asarray(enc), tok)
    tcodes, tprobs = TD(tm, DIMS).detect_language(torch.from_numpy(enc), _port_tokenizer())
    assert tcodes == jcodes
    for t, j in zip(tprobs, jprobs):
        assert list(t) == list(j)
        np.testing.assert_allclose(list(t.values()), list(j.values()), rtol=0, atol=1e-5)
    with pytest.raises(NotImplementedError, match="7.2"):
        TD(tm, DIMS).decode(None)


def test_auto_language_sessions_match_jax(tok):
    """Two packed sessions per tick with language="auto", in 0.75 s steps:
    both packages detect the same language at the same tick (2 s past the
    first timestamp), swap the tokenizer and reset the context, and commit
    identical token ids after every tick."""
    jp = JM.init_params(DIMS, jax.random.PRNGKey(0), jnp.float32)
    tm = TM.params_from_jax_numpy(jax.tree.map(np.asarray, jp), DIMS)
    cfg = dict(language="auto", max_steps=4, audio_max_len=8.0,
               enc_tail_frames=128, enc_rewrite_margin=16)
    je = JA.AlignAttEngine(jp, DIMS, tok, JA.AlignAttConfig(**cfg))
    te = TA.AlignAttEngine(tm, DIMS, _port_tokenizer(), TA.AlignAttConfig(**cfg))

    from whisperlivekit_tpu.streaming.dispatch import run_tick_batch as jax_run
    from whisperlivekit_tpu.streaming.pools import AudioPool as JAudio, EncPool as JEnc
    from whisperlivekit_tpu_torch.streaming.dispatch import run_tick_batch as torch_run
    from whisperlivekit_tpu_torch.streaming.pools import AudioPool as TAudio, EncPool as TEnc

    sides = []
    for mod, eng, run, pools in (
        (JA, je, jax_run, (JAudio(4), JEnc(4, DIMS, dtype=jnp.float32))),
        (TA, te, torch_run, (TAudio(4), TEnc(4, DIMS, dtype=torch.float32))),
    ):
        sessions = []
        for _ in range(2):
            s = mod.AlignAttSession(eng)
            s.pool, s.enc_pool = pools
            sessions.append(s)
        sides.append((eng, run, pools, sessions))

    audio = [speechlike(9.0, 20 + i) for i in range(2)]
    step = 12000
    detected_at = [[None, None], [None, None]]
    for tick in range(12):
        state = []
        for side, (eng, run, (apool, epool), sessions) in enumerate(sides):
            tis = []
            for s, a in zip(sessions, audio):
                s.insert_audio(a[tick * step : (tick + 1) * step])
                tis.append(s.prepare_tick(is_last=tick == 11))
            outs = run(eng, tis, eng.tokenizer, pool=apool, enc_pool=epool)
            for i, (s, ti, o) in enumerate(zip(sessions, tis, outs)):
                if s.detected_language is not None and detected_at[side][i] is None:
                    detected_at[side][i] = tick
                s.finish_tick(ti, o)
            state.append([(s.detected_language, [list(c) for c in s.committed_tokens],
                           s.tokenizer.sot_sequence) for s in sessions])
        assert state[0] == state[1], f"tick {tick}"
    assert detected_at[0] == detected_at[1] and None not in detected_at[1], detected_at
    assert any(sum(len(c) for c in s.committed_tokens) for s in sides[1][3])
