"""The port's OpenAI REST and Deepgram endpoints against the JAX package's,
on the CPU. Both servers load one dev-tiny checkpoint written in
``tmp_path`` and answer the same requests:

- ``POST /v1/audio/transcriptions`` of one generated WAV in every
  ``response_format`` (json, verbose_json, text, srt, vtt): the port's body
  equals JAX's (tests/test_server.py's REST case); token auth; a 400 for a
  garbage upload and for a missing file;
- ``WS /v1/listen``: one session each, the same final transcripts;
- tests/test_deepgram_compat.py's adapter cases, on both modules.
"""

import asyncio
import io
import json

import numpy as np
import pytest
import torch

from whisperlivekit_tpu.models.whisper.dims import MODEL_DIMS
from whisperlivekit_tpu_torch.harness.vocab import write_standin_vocab
from torch_ckpt import canonical_state_dict, write_openai, write_wav

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

FORMATS = ("json", "verbose_json", "text", "srt", "vtt")
PACKAGES = {"jax": "whisperlivekit_tpu", "torch": "whisperlivekit_tpu_torch"}


def _engines(ckpt):
    from whisperlivekit_tpu.config import WLKConfig as JConfig
    from whisperlivekit_tpu.engine.core import TranscriptionEngine as JEngine
    from whisperlivekit_tpu_torch.config import WLKConfig as TConfig
    from whisperlivekit_tpu_torch.engine.core import TranscriptionEngine as TEngine

    kw = dict(model_path=ckpt, lan="en", pcm_input=True, vac=False, param_dtype="float32",
              log_level="ERROR")
    out = {}
    for name, Config, Engine, extra in (("jax", JConfig, JEngine, {}), ("torch", TConfig, TEngine,
                                                                        dict(device="cpu"))):
        Engine.reset()
        config = Config(**kw)
        out[name] = (config, Engine(config, **extra))
        Engine.reset()  # the next user of the singleton builds its own
    return out


def finals(msgs) -> list:
    return [m["channel"]["alternatives"][0]["transcript"] for m in msgs
            if m.get("type") == "Results" and m["is_final"]]


async def _exchange(server, config, wav: bytes, pcm: bytes) -> dict:
    """Every request of this module against one server, in turn."""
    from aiohttp.test_utils import TestClient, TestServer

    client = TestClient(TestServer(server.app))
    await client.start_server()
    res = {}
    try:
        for fmt in FORMATS:
            r = await client.post("/v1/audio/transcriptions",
                                  data={"file": io.BytesIO(wav), "response_format": fmt, "language": "en"})
            res[fmt] = (r.status, r.content_type, await r.text())
        r = await client.post("/v1/audio/transcriptions", data={"file": io.BytesIO(b"\x00garbage" * 64)})
        res["garbage"] = r.status
        r = await client.post("/v1/audio/transcriptions", data={"response_format": "json"})
        res["no_file"] = r.status

        config.api_token = "secret123"
        try:
            r = await client.post("/v1/audio/transcriptions", data={"file": io.BytesIO(wav)})
            res["no_token"] = r.status
            r = await client.post("/v1/audio/transcriptions", data={"file": io.BytesIO(wav)},
                                  headers={"Authorization": "Bearer wrong"})
            res["bad_token"] = r.status
            r = await client.post("/v1/audio/transcriptions", data={"file": io.BytesIO(wav)},
                                  headers={"Authorization": "Bearer secret123"})
            res["good_token"] = (r.status, await r.json())
        finally:
            config.api_token = None

        # Deepgram clients read results until they have what they need, then
        # CloseStream (which ends the session at once): read the finals until
        # they hold the REST transcript of the same audio
        want = " ".join(json.loads(res["json"][2])["text"].split())
        ws = await client.ws_connect("/v1/listen?language=en")
        msgs = [await ws.receive_json(timeout=60)]
        await ws.send_bytes(pcm)  # one message: the same chunking in both packages
        await ws.send_str(json.dumps({"type": "KeepAlive"}))
        await ws.send_str(json.dumps({"type": "Finalize"}))
        while " ".join(" ".join(finals(msgs)).split()) != want:
            msgs.append(await ws.receive_json(timeout=60))
        await ws.send_str(json.dumps({"type": "CloseStream"}))
        res["closed"] = (await ws.receive(timeout=60)).type.name
        res["listen"] = msgs
    finally:
        await client.close()
    return res


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("server")
    ckpt = write_openai(root / "tiny.pt", canonical_state_dict(MODEL_DIMS["dev-tiny"], seed=5),
                        MODEL_DIMS["dev-tiny"], np.float32)
    wav = write_wav(root / "speech.wav", 2.5, seed=7).read_bytes()
    pcm = wav[44:]  # the canonical 44-byte header written by the wave module
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WLK_TPU_ASSET_DIR", str(write_standin_vocab(root / "vocab").parent))
        engines = _engines(str(ckpt))
        out = {}
        for name, (config, engine) in engines.items():
            app = __import__(f"{PACKAGES[name]}.server.app", fromlist=["WLKServer"])
            out[name] = asyncio.run(_exchange(app.WLKServer(config, engine=engine), config, wav, pcm))
    return out


@pytest.mark.parametrize("fmt", FORMATS)
def test_rest_response_matches_jax(served, fmt):
    status, ctype, body = served["torch"][fmt]
    assert status == 200, body
    assert (status, ctype, body) == served["jax"][fmt]
    if fmt in ("json", "verbose_json"):
        data = json.loads(body)
        assert data["text"] == json.loads(served["torch"]["json"][2])["text"]
    if fmt == "verbose_json":
        assert data["task"] == "transcribe" and data["language"] == "en" and data["duration"] == 2.5
        assert data["segments"] and data["words"]


def test_rest_refuses_garbage_and_checks_the_token(served):
    t, j = served["torch"], served["jax"]
    assert t["garbage"] == t["no_file"] == 400
    assert t["no_token"] == t["bad_token"] == 401
    assert t["good_token"][0] == 200
    assert t["good_token"][1]["text"] == json.loads(t["json"][2])["text"]
    for key in ("garbage", "no_file", "no_token", "bad_token", "good_token"):
        assert t[key] == j[key], key


def test_deepgram_session_matches_jax(served):
    t, j = served["torch"]["listen"], served["jax"]["listen"]
    assert t[0]["type"] == "Metadata" and t[0]["channels"] == 1
    assert finals(t) == finals(j) and "".join(finals(t)).strip()
    assert served["torch"]["closed"] == served["jax"]["closed"] == "CLOSE"


# ---------------------------------------------------------------------------
# tests/test_deepgram_compat.py's adapter cases, on both modules
# ---------------------------------------------------------------------------


class FakeWS:
    def __init__(self):
        self.sent = []

    async def send_json(self, msg):
        self.sent.append(msg)


def line(start, end, text, speaker=1):
    def fmt(s):
        h, rem = divmod(int(s * 100), 360000)
        m, rem = divmod(rem, 6000)
        sec, cs = divmod(rem, 100)
        return f"{h}:{m:02d}:{sec:02d}.{cs:02d}"

    return {"speaker": speaker, "text": text, "start": fmt(start), "end": fmt(end)}


def _word_interpolation(m):
    words = m._line_to_words(line(0.0, 2.0, "hello brave new world"))
    assert len(words) == 4 and words[0]["start"] == 0.0 and words[-1]["end"] == 2.0
    assert words[1]["start"] == pytest.approx(0.5)
    return words


def _committed_lines_emit_final_results(m):
    a = m.DeepgramAdapter(FakeWS())
    asyncio.run(a.process_update({"lines": [line(0, 1, "hello there")], "buffer_transcription": ""}))
    asyncio.run(a.process_update({"lines": [line(0, 1, "hello there"), line(1, 2, "more words")],
                                  "buffer_transcription": ""}))
    finals = [x for x in a.ws.sent if x.get("type") == "Results" and x["is_final"]]
    assert [f["channel"]["alternatives"][0]["transcript"] for f in finals] == ["hello there", "more words"]
    return a.ws.sent


def _buffer_emits_interim(m):
    a = m.DeepgramAdapter(FakeWS())
    asyncio.run(a.process_update({"lines": [], "buffer_transcription": "partial tex"}))
    interim = a.ws.sent[-1]
    assert interim["type"] == "Results" and interim["is_final"] is False
    assert interim["channel"]["alternatives"][0]["transcript"] == "partial tex"
    return a.ws.sent


def _silence_after_speech_emits_utterance_end(m):
    a = m.DeepgramAdapter(FakeWS())
    asyncio.run(a.process_update({"lines": [line(0, 1, "said a thing")], "buffer_transcription": ""}))
    asyncio.run(a.process_update({"lines": [line(0, 1, "said a thing"), line(1.5, 7, "", speaker=-2)],
                                  "buffer_transcription": ""}))
    assert any(x.get("type") == "UtteranceEnd" for x in a.ws.sent)
    return a.ws.sent


def _speech_started_only_with_vad_events(m):
    a, b = m.DeepgramAdapter(FakeWS()), m.DeepgramAdapter(FakeWS())
    a._vad_events = True
    asyncio.run(a.process_update({"lines": [], "buffer_transcription": "hi"}))
    asyncio.run(b.process_update({"lines": [], "buffer_transcription": "hi"}))
    assert a.ws.sent[0]["type"] == "SpeechStarted"
    assert all(x.get("type") != "SpeechStarted" for x in b.ws.sent)
    return a.ws.sent, b.ws.sent


def _metadata_shape(m):
    class Cfg:
        backend = "jax-tpu"

    a = m.DeepgramAdapter(FakeWS())
    asyncio.run(a.send_metadata(Cfg()))
    md = a.ws.sent[0]
    assert md["type"] == "Metadata" and md["channels"] == 1 and md["request_id"]
    return {k: v for k, v in md.items() if k not in ("request_id", "created")}


DEEPGRAM_CASES = {f.__name__.lstrip("_"): f for f in (
    _word_interpolation, _committed_lines_emit_final_results, _buffer_emits_interim,
    _silence_after_speech_emits_utterance_end, _speech_started_only_with_vad_events, _metadata_shape)}


@pytest.mark.parametrize("case", sorted(DEEPGRAM_CASES))
def test_deepgram_adapter_case_on_both_modules(case):
    import importlib

    out = {p: DEEPGRAM_CASES[case](importlib.import_module(f"{mod}.server.deepgram_compat"))
           for p, mod in PACKAGES.items()}
    assert out["torch"] == out["jax"]
