"""The port's own copies of the JAX package's host-only modules (config,
CLI, tokenizer, session plane, VAD, web page, native PCM runtime, audio IO,
WER and normalizers, the Deepgram adapter, the WS test client) against
the modules they were copied from: the same public names, and one sample of
behaviour each that agrees on the same inputs."""

import dataclasses
import importlib
import inspect
import math

import numpy as np
import pytest

from whisperlivekit_tpu_torch.harness.vocab import write_standin_vocab

MODULES = (
    "config", "cli_args", "timed",
    "models.whisper.dims", "models.whisper.languages", "models.whisper.tokenizer",
    "audio.ffmpeg", "audio.vad",
    "session.alignment", "session.metrics", "session.diff",
    "server.web", "native", "audio.io", "harness.wer", "harness.normalizers",
    "server.deepgram_compat", "test_client",
)


def _pair(name):
    return (importlib.import_module(f"whisperlivekit_tpu.{name}"),
            importlib.import_module(f"whisperlivekit_tpu_torch.{name}"))


@pytest.fixture(scope="module", autouse=True)
def standin_vocab(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WLK_TPU_ASSET_DIR", str(write_standin_vocab(tmp_path_factory.mktemp("vocab")).parent))
        yield


def _config(m):
    return vars(m.WLKConfig()), m.parse_cors_origins("https://a.example, https://b.example")


def _cli_args(m):
    return vars(m.parse_args(["--model-size", "random:base", "--lan", "fr", "--no-vac"]))


def _timed(m):
    tok = m.ASRToken(start=1.0, end=2.0, text=" hi", speaker=1).with_offset(0.5)
    front = m.FrontData(status="active_transcription",
                        lines=[m.Segment(start=0.0, end=1.0, text="a", speaker=-1)])
    return dataclasses.asdict(tok), front.as_dict()


def _dims(m):
    return ({k: dataclasses.asdict(v) for k, v in m.MODEL_DIMS.items()},
            [tuple(p) for p in m.default_alignment_heads(m.MODEL_DIMS["base"], "base")])


def _languages(m):
    return m.LANGUAGES, m.TO_LANGUAGE_CODE, m.normalize_language("English")


def _tokenizer(m):
    t = m.get_tokenizer(True, language="fr", task="transcribe")
    ids = t.encode(" Hello world, 42 times!")
    return ids, t.decode(ids), t.sot_sequence, t.split_to_word_tokens(ids), t.all_language_codes


def _ffmpeg(m):
    return [s.value for s in m.FFmpegState]


def _vad(m):
    rng = np.random.default_rng(0)
    t = np.arange(512 * 40) / 16000
    sig = np.where(t > 0.5, 0.3 * np.sin(2 * np.pi * 220 * t), 0.0) + 0.001 * rng.standard_normal(t.shape)
    it = m.FixedVADIterator(m.EnergyVAD())
    return [it(sig[i : i + 512].astype(np.float32)) for i in range(0, sig.size, 512)]


def _alignment(m):
    timed = importlib.import_module(m.__name__.rsplit(".", 2)[0] + ".timed")

    class Args:
        diarization = False

    ta = m.TokensAlignment(timed.State(), Args(), sep=" ", retention_seconds=10.0)
    ta.all_tokens = [timed.ASRToken(start=i, end=i + 1, text=f" w{i}") for i in range(0, 40, 4)]
    ta._prune()
    ta.new_tokens = [timed.ASRToken(start=40 + i, end=41 + i, text=f" n{i}") for i in range(3)]
    lines, _, _ = ta.get_lines(audio_time=45.0)
    return ([(t.start, t.text) for t in ta.all_tokens], [(l.start, l.end, l.text) for l in lines],
            m.resolve_retention_seconds(None, "diff"), math.isinf(m.resolve_retention_seconds(0, "full")))


def _metrics(m):
    c = m.CallTimes()
    for s in (0.1, 0.3, 0.2, 0.5):
        c.append(s)
    return len(c), c.total_s, c.mean_ms, c.quantile_ms(0.5), sorted(m.SessionMetrics().to_dict())


def _diff(m):
    timed = importlib.import_module(m.__name__.rsplit(".", 2)[0] + ".timed")

    def fd(texts, start=0):
        return timed.FrontData(status="active_transcription", lines=[
            timed.Segment(start=float(start + i), end=float(start + i + 1), text=t, speaker=-1)
            for i, t in enumerate(texts)])

    d = m.DiffTracker()
    return [d.to_message(fd(["hello"])), d.to_message(fd(["hello", "world"])),
            d.to_message(fd(["world", "again"], start=1))]


def _web(m):
    return m.render_index()


def _native(m):
    pcm = (np.random.default_rng(1).integers(-32768, 32767, 4000)).astype("<i2")
    return m.s16le_to_f32(pcm.tobytes()).tolist(), m.f32_to_s16le(np.linspace(-1, 1, 101, dtype=np.float32))


def _io(m):
    import tempfile
    from pathlib import Path

    rng = np.random.default_rng(2)
    audio = (0.5 * rng.standard_normal(4000)).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        m.save_wav(Path(d) / "a.wav", audio, sr=8000)
        back = m.load_wav(Path(d) / "a.wav")
    return (m.float32_to_s16le(audio), m.s16le_to_float32(m.float32_to_s16le(audio)).tolist(),
            m.resample(audio, 8000).tolist(), back.tolist(), m.ffmpeg_available())


def _wer(m):
    return [m.compute_wer("the cat sat on the mat", "the cat sat on mat"), m.normalize_text(" Hé, THERE! ")]


def _normalizers(m):
    return [n(s) for n in (m.EnglishTextNormalizer(), m.BasicTextNormalizer(remove_diacritics=True))
            for s in ("Mr Brown paid $20.50 for twenty-one apples", "it's Ünïcode (um) [noise]")]


def _deepgram(m):
    lines = [{"speaker": 1, "text": "hello brave new world", "start": "0:00:01.00", "end": "0:00:03.00"},
             {"speaker": -2, "text": "", "start": "0:00:03.00", "end": "0:00:09.00"}]
    result = m._lines_to_result(lines, is_final=True, speech_final=True)
    return result, m._line_to_words(lines[0]), m._parse_time_str("1:02:03.5")


def _test_client(m):
    r = m.TranscriptionResult()
    for msg in ({"type": "config"}, {"type": "snapshot", "lines": [{"text": "a"}]},
                {"type": "diff", "n_lines": 2, "new_lines": [{"text": "b"}], "buffer_transcription": "c"},
                {"type": "ready_to_stop"}):
        m.reconstruct_state(r, msg)
    return r.lines, r.text, r.finished


SAMPLES = {
    "audio.io": _io, "harness.wer": _wer, "harness.normalizers": _normalizers,
    "server.deepgram_compat": _deepgram, "test_client": _test_client,
    "config": _config, "cli_args": _cli_args, "timed": _timed, "models.whisper.dims": _dims,
    "models.whisper.languages": _languages, "models.whisper.tokenizer": _tokenizer,
    "audio.ffmpeg": _ffmpeg, "audio.vad": _vad, "session.alignment": _alignment,
    "session.metrics": _metrics, "session.diff": _diff, "server.web": _web, "native": _native,
}


@pytest.mark.parametrize("name", MODULES)
def test_public_names_match_jax_module(name):
    jax_mod, port_mod = _pair(name)
    # the API, not the modules a copy imports to do its work
    public = lambda m: sorted(  # noqa: E731
        n for n, v in vars(m).items() if not n.startswith("_") and not inspect.ismodule(v))
    assert public(port_mod) == public(jax_mod)


@pytest.mark.parametrize("name", MODULES)
def test_behaviour_matches_jax_module(name):
    jax_mod, port_mod = _pair(name)
    assert SAMPLES[name](port_mod) == SAMPLES[name](jax_mod)
