"""Port parity for the streaming beam tick (streaming/alignatt_beam.py) of
whisperlivekit_tpu_torch against the JAX package, at dev-tiny size with JAX
weights bridged through numpy, inputs made from numpy seeds and the
stand-in vocabulary (harness/vocab.py):

- ``alignatt_tick_beam`` with beam 1 equals the greedy ``alignatt_tick`` in
  both packages (integer outputs), and beams 2 and 4 give JAX's integer
  outputs exactly, ``no_speech_p`` within 1e-5;
- the selection breaks ties as ``jax.lax.top_k`` does (the lower index
  first), on constructed scores with equal finite values and -inf;
- a beam session (``decoder_type="beam"``) commits JAX's token ids on every
  tick, through ``AlignAttSession.infer``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperlivekit_tpu.models.whisper import model as JM
from whisperlivekit_tpu.models.whisper.dims import MODEL_DIMS
from whisperlivekit_tpu.models.whisper.tokenizer import get_tokenizer
from whisperlivekit_tpu.streaming import alignatt as JA
from whisperlivekit_tpu.streaming import alignatt_beam as JB
from whisperlivekit_tpu_torch.harness.vocab import write_standin_vocab
from whisperlivekit_tpu_torch.models.whisper import model as TM
from whisperlivekit_tpu_torch.streaming import alignatt as TA
from whisperlivekit_tpu_torch.streaming import alignatt_beam as TB

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

DIMS = MODEL_DIMS["dev-tiny"]
N = 480000
MAX_STEPS = 4


@pytest.fixture(scope="module")
def weights():
    jp = JM.init_params(DIMS, jax.random.PRNGKey(0), jnp.float32)
    return jp, TM.params_from_jax_numpy(jax.tree.map(np.asarray, jp), DIMS)


@pytest.fixture(scope="module")
def tok(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WLK_TPU_ASSET_DIR", str(write_standin_vocab(tmp_path_factory.mktemp("vocab")).parent))
        yield get_tokenizer(True, language="en", task="transcribe")


def _engines(weights, tok, **kw):
    jp, tm = weights
    cfg = dict(language="en", max_steps=MAX_STEPS, audio_max_len=4.0, **kw)
    return (JA.AlignAttEngine(jp, DIMS, tok, JA.AlignAttConfig(**cfg)),
            TA.AlignAttEngine(tm, DIMS, tok, TA.AlignAttConfig(**cfg)))


def _inputs(tok):
    """Three lanes of speech-like audio (lane 2 inactive), two of them with
    a committed context after the sot sequence."""
    rng = np.random.default_rng(3)
    B, p_max = 3, 32
    t = np.arange(3 * 16000) / 16000
    audio = np.zeros((B, N), np.int16)
    for i in range(B):
        sig = 0.3 * np.sin(2 * np.pi * (180 + 60 * i) * t) * (1 + 0.4 * np.sin(2 * np.pi * 3.1 * t))
        sig += 0.05 * rng.standard_normal(t.shape)
        audio[i, : t.size] = (np.clip(sig, -1, 1 - 1 / 32768) * 32768).astype(np.int16)
    sot = list(tok.sot_sequence_including_notimestamps)
    prefixes = [sot, sot + [400, 401, 402], sot + [900]]
    arr = dict(prefix=np.full((B, p_max), tok.eot, np.int32),
               prefix_len=np.array([len(p) for p in prefixes], np.int32),
               sot_index=np.zeros(B, np.int32), content_frames=np.array([150, 150, 150], np.int32),
               last_attend=np.full(B, -200, np.int32), is_last=np.array([False, True, False]),
               max_new=np.full(B, 50, np.int32), active=np.array([True, True, False]))
    for i, p in enumerate(prefixes):
        arr["prefix"][i, : len(p)] = p
    return audio, arr, p_max


NAMES = ("prefix", "prefix_len", "sot_index", "content_frames", "last_attend", "is_last", "max_new")


def _beam_tick(side, eng, tok, audio, arr, p_max, beam):
    statics = dict(dims=DIMS, p_max=p_max, max_steps=MAX_STEPS, beam=beam, eot=tok.eot,
                   ts_begin=tok.timestamp_begin, no_speech_tok=tok.no_speech,
                   space_tok=tok.encode(" ")[0])
    if side == "jax":
        outs = JB.alignatt_tick_beam(
            eng.params, jnp.asarray(audio), *(jnp.asarray(arr[n]) for n in NAMES),
            eng.suppress_mask, eng.align_layers, eng.align_heads, jnp.int32(25), jnp.int32(200),
            jnp.float32(0.5), jnp.asarray(arr["active"]), **statics)
    else:
        outs = TB.alignatt_tick_beam(
            eng.model, torch.from_numpy(audio), *(torch.from_numpy(arr[n]) for n in NAMES),
            eng.suppress_mask, eng.align_layers, eng.align_heads, 25, 200, 0.5,
            torch.from_numpy(arr["active"]), **statics)
    return [np.asarray(o) for o in outs]


def _greedy_tick(side, eng, tok, audio, arr, p_max):
    statics = dict(dims=DIMS, p_max=p_max, max_steps=MAX_STEPS, eot=tok.eot,
                   ts_begin=tok.timestamp_begin, no_speech_tok=tok.no_speech,
                   space_tok=tok.encode(" ")[0])
    if side == "jax":
        packed = JA.alignatt_tick(
            eng.params, jnp.asarray(audio), *(jnp.asarray(arr[n]) for n in NAMES),
            eng.suppress_mask, eng.align_layers, eng.align_heads, jnp.int32(25), jnp.int32(200),
            jnp.float32(0.5), jnp.asarray(arr["active"]), eng.cif_w, eng.cif_b, **statics)
    else:
        packed = TA.alignatt_tick(
            eng.model, torch.from_numpy(audio), *(torch.from_numpy(arr[n]) for n in NAMES),
            eng.suppress_mask, eng.align_layers, eng.align_heads, 25, 200, 0.5,
            torch.from_numpy(arr["active"]), eng.cif_w, eng.cif_b, **statics)
    return np.asarray(packed)


def _assert_ints_equal(got, want, what):
    """(new_tokens, n_keep, frames, reason, no_speech_p, last_attend, fire)."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i)
        if i == 4:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=what)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: output {i}")


def test_beam_one_equals_the_greedy_tick(weights, tok):
    """One beam is greedy decoding: tokens, n_keep, frames, reason and
    last_attend equal the packed greedy tick's, in the port and in JAX."""
    je, te = _engines(weights, tok)
    audio, arr, p_max = _inputs(tok)
    for side, eng in (("jax", je), ("torch", te)):
        tokens, n_keep, frames, reason, _, last_attend, fire = _beam_tick(
            side, eng, tok, audio, arr, p_max, beam=1)
        packed = _greedy_tick(side, eng, tok, audio, arr, p_max)
        m = MAX_STEPS
        np.testing.assert_array_equal(tokens, packed[:, :m], err_msg=side)
        np.testing.assert_array_equal(frames, packed[:, m: 2 * m], err_msg=side)
        np.testing.assert_array_equal(np.stack([n_keep, reason, last_attend], 1),
                                      packed[:, [2 * m, 2 * m + 1, 2 * m + 2]], err_msg=side)
        assert fire.all()
    assert n_keep.any()  # the active lanes kept tokens


@pytest.mark.parametrize("beam", [2, 4])
def test_beam_tick_matches_jax(weights, tok, beam):
    je, te = _engines(weights, tok)
    audio, arr, p_max = _inputs(tok)
    want = _beam_tick("jax", je, tok, audio, arr, p_max, beam)
    got = _beam_tick("torch", te, tok, audio, arr, p_max, beam)
    _assert_ints_equal(got, want, f"beam {beam}")
    assert got[1][:2].any()


def test_beam_selection_breaks_ties_like_lax_top_k():
    """Equal scores go to the lower flat index, -inf ties as well: frozen
    beams continuing with EOT at zero added score, suppressed tokens."""
    rng = np.random.default_rng(0)
    B, beam, V = 3, 4, 11
    scores = np.full((B, beam, V), -np.inf, np.float32)
    scores[0, :, 5] = -1.25                      # four frozen beams: one EOT score each
    scores[1, 0, [2, 7, 9]] = -0.5               # a three-way tie inside one beam
    scores[1, 2, 3] = -0.5                       # ... and across beams
    scores[2] = rng.integers(-3, 0, (beam, V)).astype(np.float32)  # many ties
    flat = scores.reshape(B, beam * V)
    jv, ji = jax.lax.top_k(jnp.asarray(flat), beam)
    tv, ti = TB._top_beam(torch.from_numpy(flat), beam)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti[0].tolist() == [5, 16, 27, 38] and ti[1].tolist() == [2, 7, 9, 25]


def test_beam_session_commits_jax_tokens(weights, tok, monkeypatch):
    """``decoder_type="beam"``, 4 beams: both packages' sessions, fed ~5 s in
    0.75 s steps (an eviction at audio_max_len=4 s), commit the same token
    ids after every ``infer``, which runs the beam tick."""
    calls = []
    real = TB.run_tick_batch_beam
    monkeypatch.setattr(TB, "run_tick_batch_beam", lambda *a, **k: calls.append(a[3]) or real(*a, **k))
    je, te = _engines(weights, tok, decoder_type="beam", beam_size=4)
    sessions = [JA.AlignAttSession(je), TA.AlignAttSession(te)]
    rng = np.random.default_rng(7)
    t = np.arange(int(16000 * 5.25)) / 16000
    audio = (0.3 * np.sin(2 * np.pi * 210 * t) * (1 + 0.4 * np.sin(2 * np.pi * 3.1 * t))
             + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
    step = 12000
    for tick in range(7):
        committed = []
        for s in sessions:
            s.insert_audio(audio[tick * step: (tick + 1) * step])
            s.infer(is_last=tick == 6)
            committed.append([list(c) for c in s.committed_tokens])
        assert committed[0] == committed[1], f"tick {tick}"
    assert sum(len(c) for c in committed[1]) > 0
    assert calls and set(calls) == {4}
