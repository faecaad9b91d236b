"""The port's offline decoding (decoding/options.py, writers.py, task.py,
beam.py and ops/dtw.py) against the JAX package's, on the CPU, at dev-tiny
size: JAX's ``init_params`` weights bridged through
``params_from_jax_numpy``, inputs made from numpy seeds, the stand-in
vocabulary (harness/vocab.py).

Tolerances: tokens, masks, indices and DTW paths exact; f32 floats
(``avg_logprob``, ``no_speech_prob``) within 2e-5. The filters' masks and
the values they keep are compared exactly (the filter only adds 0 or -inf).

- the host copies: ``options``, ``writers`` (the same strings for every
  format) and ``dtw`` (the same paths on seeded cost matrices, ties
  included);
- the token helpers: ``get_suppress_tokens``, ``build_initial_tokens``,
  ``truncate_initial_tokens``;
- ``_apply_filters`` on seeded logits at steps 0, 1, 2 and later, with and
  without timestamps, including rows whose every text (or timestamp) logit
  is -inf;
- ``WhisperDecoder.decode`` at temperature 0: tokens, text, avg_logprob and
  no_speech_prob, with and without timestamps, prompt, prefix,
  ``max_initial_timestamp``, two windows at once, language detection;
- ``beam_decode`` at beams 2 and 5 and patience 1 and 2: tokens;
- at temperature > 0 (JAX draws from ``jax.random``, the port from a
  ``torch.Generator``), only the timestamp grammar, determinism per seed and
  the best-of ranking (on the same candidates in both packages).
"""

import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperlivekit_tpu.audio.mel import N_SAMPLES, log_mel_spectrogram, pad_or_trim
from whisperlivekit_tpu.decoding import options as JO
from whisperlivekit_tpu.decoding import task as JT
from whisperlivekit_tpu.decoding import writers as JW
from whisperlivekit_tpu.models.whisper import model as JM
from whisperlivekit_tpu.models.whisper.dims import MODEL_DIMS
from whisperlivekit_tpu.models.whisper.tokenizer import get_tokenizer
from whisperlivekit_tpu.ops import dtw as JDTW
from whisperlivekit_tpu_torch.decoding import options as TO
from whisperlivekit_tpu_torch.decoding import task as TT
from whisperlivekit_tpu_torch.decoding import writers as TW
from whisperlivekit_tpu_torch.harness.vocab import write_standin_vocab
from whisperlivekit_tpu_torch.models.whisper import model as TM
from whisperlivekit_tpu_torch.ops import dtw as TDTW

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

DIMS = MODEL_DIMS["dev-tiny"]
F32_TOL = 2e-5


@pytest.fixture(scope="module")
def tok(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WLK_TPU_ASSET_DIR", str(write_standin_vocab(tmp_path_factory.mktemp("vocab")).parent))
        yield get_tokenizer(True, language="en", task="transcribe")


@pytest.fixture(scope="module")
def decoders(tok):
    jp = JM.init_params(DIMS, jax.random.PRNGKey(0), jnp.float32)
    tm = TM.params_from_jax_numpy(jax.tree.map(np.asarray, jp), DIMS)
    return JT.WhisperDecoder(jp, DIMS), TT.WhisperDecoder(tm, DIMS)


def _mel(seed: int, seconds: float = 3.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    audio = (0.1 * rng.standard_normal(int(16000 * seconds))).astype(np.float32)
    m = log_mel_spectrogram(jnp.asarray(audio), padding=N_SAMPLES - len(audio))
    return np.array(pad_or_trim(m, 3000))


@pytest.fixture(scope="module")
def mel():
    return _mel(0)


def _decode_both(decoders, mel, **kw):
    jd, td = decoders
    rj = jd.decode(jnp.asarray(mel), JO.DecodingOptions(**kw))
    rt = td.decode(torch.from_numpy(mel), TO.DecodingOptions(**kw))
    return rj, rt


# ---------------------------------------------------------------------------
# Host copies
# ---------------------------------------------------------------------------

RESULT = {
    "text": "hello world\tagain",
    "segments": [
        {"start": 0.0, "end": 1.5, "text": " hello --> there"},
        {"start": 1.5, "end": 3725.2504, "text": " world\tagain"},
    ],
    "language": "en",
}


@pytest.mark.parametrize("fmt", sorted(JW.WRITERS))
def test_writers_write_the_same_strings(fmt):
    out = []
    for W in (JW, TW):
        buf = io.StringIO()
        W.get_writer(fmt)(RESULT, buf)
        out.append(buf.getvalue())
    assert out[0] == out[1] and out[0]
    for W in (JW, TW):
        with pytest.raises(ValueError):
            W.get_writer("nope")


def test_options_and_compression_ratio_match():
    kw = dict(temperature=0.4, best_of=3, prompt="p", without_timestamps=True)
    assert vars(TO.DecodingOptions(**kw).with_(language="fr")) == vars(
        JO.DecodingOptions(**kw).with_(language="fr"))
    assert vars(TO.DecodingResult()).keys() == vars(JO.DecodingResult()).keys()
    for text in ("", "abc", "spam " * 40, "Grüße, 世界"):
        assert TO.compression_ratio(text) == JO.compression_ratio(text)


@pytest.mark.parametrize("seed", range(6))
def test_dtw_paths_match(seed):
    """Seeded cost matrices; the odd seeds are quantized to a few levels so
    that the three moves tie often."""
    rng = np.random.default_rng(seed)
    n, m = 3 + seed, 20 + 7 * seed
    cost = rng.standard_normal((n, m))
    if seed % 2:
        cost = np.round(cost)
    if seed == 5:
        cost = np.zeros((n, m))  # every move ties everywhere
    jt, jf = JDTW.dtw(cost)
    tt, tf = TDTW.dtw(cost)
    assert np.array_equal(jt, tt) and np.array_equal(jf, tf)
    assert tt[0] == 0 and tf[0] == 0 and tt[-1] == n - 1 and tf[-1] == m - 1


# ---------------------------------------------------------------------------
# Token helpers
# ---------------------------------------------------------------------------

OPTION_CASES = [
    dict(),
    dict(suppress_tokens="", suppress_blank=False),
    dict(suppress_tokens="5,7,-1"),
    dict(suppress_tokens=[3, 9]),
    dict(without_timestamps=True),
    dict(prompt="one two three", prefix="and then"),
    dict(prompt=list(range(300, 800)), prefix=list(range(900, 1400)), sample_len=100),
    dict(prefix=" so", sample_len=224),
]


@pytest.mark.parametrize("case", range(len(OPTION_CASES)))
def test_token_helpers_match(tok, case):
    kw = OPTION_CASES[case]
    jopt, topt = JO.DecodingOptions(**kw), TO.DecodingOptions(**kw)
    assert TT.get_suppress_tokens(tok, topt) == JT.get_suppress_tokens(tok, jopt)
    ti = TT.build_initial_tokens(tok, topt, DIMS.n_text_ctx)
    assert ti == JT.build_initial_tokens(tok, jopt, DIMS.n_text_ctx)
    for width in (8, 40, 232, 1000):
        assert (TT.truncate_initial_tokens(ti, width, tok.sot_prev)
                == JT.truncate_initial_tokens(ti, width, tok.sot_prev))


# ---------------------------------------------------------------------------
# _apply_filters
# ---------------------------------------------------------------------------


def _filter_inputs(tok, seed: int):
    """Seeded [B, V] logits and filter state for 8 lanes: text and timestamp
    histories of every kind, a lane whose text logits are all -inf and one
    whose timestamp logits are all -inf."""
    rng = np.random.default_rng(seed)
    V, ts = DIMS.n_vocab, tok.timestamp_begin
    B = 8
    logits = (3 * rng.standard_normal((B, V))).astype(np.float32)
    logits[0, ts:] += 6.0  # timestamps probable on lane 0
    logits[6, : tok.eot] = -np.inf
    logits[7, ts:] = -np.inf
    text = lambda: int(rng.integers(0, tok.eot))  # noqa: E731
    stamp = lambda: int(rng.integers(ts, V))  # noqa: E731
    last = np.array([stamp(), text(), stamp(), text(), stamp(), -1, stamp(), text()], np.int32)
    penult = np.array([stamp(), stamp(), text(), text(), -1, -1, text(), stamp()], np.int32)
    last_ts = np.array([last[0], penult[1], last[2], ts, last[4], ts, last[6], penult[7]], np.int32)
    has_ts = last_ts > ts
    suppress = np.zeros(V, np.float32)
    suppress[list(JT.get_suppress_tokens(tok, JO.DecodingOptions()))] = -np.inf
    return logits, last, penult, last_ts, has_ts, suppress


@pytest.mark.parametrize("use_ts", [True, False], ids=["timestamps", "no_timestamps"])
@pytest.mark.parametrize("k", [0, 1, 2, 5])
def test_apply_filters_matches(tok, k, use_ts):
    logits, last, penult, last_ts, has_ts, suppress = _filter_inputs(tok, seed=10 + k)
    consts = dict(eot=tok.eot, ts_begin=tok.timestamp_begin, no_ts=tok.no_timestamps,
                  space_tok=tok.encode(" ")[0], prompt_width=232, n_ctx=DIMS.n_text_ctx,
                  use_timestamps=use_ts, suppress_blank=True)
    for max_init in (50, DIMS.n_vocab):
        want = np.asarray(JT._apply_filters(
            jnp.asarray(logits), jnp.int32(k), jnp.asarray(last), jnp.asarray(penult),
            jnp.asarray(last_ts), jnp.asarray(has_ts), jnp.asarray(suppress), jnp.int32(max_init),
            JT.RuleConsts(**consts)))
        got = TT._apply_filters(
            torch.from_numpy(logits), k, torch.from_numpy(last).long(), torch.from_numpy(penult).long(),
            torch.from_numpy(last_ts).long(), torch.from_numpy(has_ts), torch.from_numpy(suppress),
            max_init, TT.RuleConsts(**consts)).numpy()
        assert np.array_equal(np.isneginf(got), np.isneginf(want))
        assert np.array_equal(got, want)
        assert np.argmax(got, axis=-1).tolist() == np.argmax(want, axis=-1).tolist()


# ---------------------------------------------------------------------------
# WhisperDecoder.decode (temperature 0) and beam_decode
# ---------------------------------------------------------------------------

DECODE_CASES = {
    "timestamps": dict(language="en", sample_len=24),
    "no_timestamps": dict(language="en", sample_len=24, without_timestamps=True),
    "prompt": dict(language="en", sample_len=20, prompt="hello there general"),
    "prompt_prefix": dict(language="en", sample_len=20, prompt="hello there", prefix="so then"),
    "max_initial_none": dict(language="en", sample_len=16, max_initial_timestamp=None),
    "max_initial_0.1": dict(language="en", sample_len=16, max_initial_timestamp=0.1),
    "long_prompt": dict(language="en", sample_len=12, prompt=list(range(400, 700))),
    "detect_language": dict(sample_len=12),
}


def _assert_results_equal(rj, rt):
    assert len(rj) == len(rt)
    for j, t in zip(rj, rt):
        assert t.tokens == j.tokens and t.text == j.text and t.language == j.language
        assert abs(t.avg_logprob - j.avg_logprob) <= F32_TOL
        assert abs(t.no_speech_prob - j.no_speech_prob) <= F32_TOL
        assert t.compression_ratio == j.compression_ratio and t.temperature == j.temperature
        if j.language_probs is None:
            assert t.language_probs is None
        else:
            assert t.language_probs.keys() == j.language_probs.keys()
            assert max(abs(t.language_probs[c] - j.language_probs[c]) for c in j.language_probs) <= F32_TOL


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_at_temperature_0_matches(decoders, mel, case):
    rj, rt = _decode_both(decoders, mel, **DECODE_CASES[case])
    _assert_results_equal(rj, rt)
    assert rt[0].tokens


def test_decode_two_windows_at_once_matches(decoders):
    mels = np.stack([_mel(1), _mel(2, seconds=7.0)])
    rj, rt = _decode_both(decoders, mels, language="en", sample_len=16)
    _assert_results_equal(rj, rt)
    assert rt[0].tokens != rt[1].tokens


@pytest.mark.parametrize("beam,patience", [(2, None), (2, 2.0), (5, None), (5, 2.0)])
def test_beam_decode_matches(decoders, mel, beam, patience):
    rj, rt = _decode_both(decoders, mel, language="en", sample_len=10, beam_size=beam, patience=patience)
    _assert_results_equal(rj, rt)


def _grammar_ok(tokens, ts_begin):
    """The timestamp rules: a timestamp first; a timestamp after text is
    followed by a timestamp or the end; timestamps never decrease."""
    if not tokens or tokens[0] < ts_begin:
        return False
    for i in range(1, len(tokens) - 1):
        if tokens[i] >= ts_begin and tokens[i - 1] < ts_begin and tokens[i + 1] < ts_begin:
            return False
    stamps = [t for t in tokens if t >= ts_begin]
    return stamps == sorted(stamps)


@pytest.mark.parametrize("temperature,best_of", [(0.4, None), (0.8, 3)])
def test_sampling_keeps_grammar_and_is_deterministic(decoders, mel, tok, temperature, best_of):
    _, td = decoders
    opts = TO.DecodingOptions(language="en", sample_len=16, temperature=temperature, best_of=best_of)
    first = td.decode(torch.from_numpy(mel), opts)[0]
    again = td.decode(torch.from_numpy(mel), opts)[0]
    assert first.tokens == again.tokens and first.avg_logprob == again.avg_logprob
    assert first.temperature == temperature and np.isfinite(first.avg_logprob)
    assert _grammar_ok(first.tokens, tok.timestamp_begin), first.tokens
    other = td.decode(torch.from_numpy(mel), opts.with_(temperature=temperature + 0.1))[0]
    assert _grammar_ok(other.tokens, tok.timestamp_begin)


@pytest.mark.parametrize("length_penalty", [None, 1.0])
def test_best_of_ranking_matches(decoders, mel, tok, monkeypatch, length_penalty):
    """Both decoders rank the same sampled candidates (the sampling loop
    replaced by one that returns them) and keep the same one."""
    G, eot = 4, tok.eot
    rng = np.random.default_rng(7)
    lengths = [3, 9, 5, 14]
    sums = np.array([-2.0, -6.3, -3.9, -8.1], np.float32)

    def candidates(prompt, sample_begin):
        toks = np.full((G, DIMS.n_text_ctx), eot, np.int64)
        toks[:, : prompt.shape[1]] = prompt
        for g, n in enumerate(lengths):
            toks[g, sample_begin : sample_begin + n] = rng.integers(100, 1000, n)
        return toks

    drawn = {}

    def fake(as_array):
        def loop(model, xkv, cache, prompt, sample_begin, *rest, **kw):
            if "toks" not in drawn:
                drawn["toks"] = candidates(np.asarray(prompt), int(sample_begin))
            out = (drawn["toks"], np.zeros(G, np.int64), sums, np.full(G, 0.25, np.float32), None)
            return tuple(None if o is None else as_array(o) for o in out)
        return loop

    monkeypatch.setattr(JT, "greedy_loop", fake(jnp.asarray))
    monkeypatch.setattr(TT, "greedy_loop", fake(torch.from_numpy))
    rj, rt = _decode_both(decoders, mel, language="en", temperature=0.5, best_of=G,
                          length_penalty=length_penalty)
    assert rt[0].tokens == rj[0].tokens and len(rt[0].tokens) in lengths
    assert abs(rt[0].avg_logprob - rj[0].avg_logprob) <= F32_TOL
    assert rt[0].no_speech_prob == rj[0].no_speech_prob == 0.25
