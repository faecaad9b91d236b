"""Port parity: the tick programs and device pools of whisperlivekit_tpu_torch
against the JAX package, at dev-tiny size with JAX weights bridged through
numpy.

Index arithmetic and copies (DRY penalty, audio-tail gather, audio-pool
update) must match exactly. The slice — one ``alignatt_tick_anchor`` then
three ``alignatt_tick_inc`` over the same audio-pool and encoder-pool rows —
must give exactly equal integer outputs (tokens, frames, n_keep, reason,
last_attend, fire); ``no_speech_p`` within 1e-5 and the cached encoder rows
within 1e-4, the f32 summation-order bars of tests/test_torch_model.py.
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
from whisperlivekit_tpu.streaming import pools as JP
from whisperlivekit_tpu_torch.harness.vocab import write_standin_vocab
from whisperlivekit_tpu_torch.models.whisper import model as TM
from whisperlivekit_tpu_torch.streaming import alignatt as TA
from whisperlivekit_tpu_torch.streaming import pools as TP

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

DIMS = MODEL_DIMS["dev-tiny"]
N = 480000


def test_dry_penalty_matches_jax():
    """Exact: integer match lengths, power-of-two penalties."""
    rng = np.random.default_rng(0)
    B, L, V, eot = 4, 64, 50300, 50257
    pattern = rng.integers(100, 110, 7)
    tokens = np.full((B, L), eot, np.int32)
    for b in range(B):
        seq = np.concatenate([pattern] * 6)[: 30 + 5 * b]
        seq[5] = 50258 if b == 3 else seq[5]  # a special token breaks a match
        tokens[b, : len(seq)] = seq
    cur_len = np.array([30, 35, 4, 45], np.int32)
    logits = rng.standard_normal((B, V)).astype(np.float32)
    want = np.asarray(JA.dry_penalty(jnp.asarray(logits), jnp.asarray(tokens),
                                     jnp.asarray(cur_len), eot))
    got = TA.dry_penalty(torch.from_numpy(logits), torch.from_numpy(tokens),
                         torch.from_numpy(cur_len), eot).numpy()
    assert (got != logits).any()  # the penalty fired somewhere
    np.testing.assert_array_equal(got, want)


def test_slice_audio_tails_matches_jax():
    rows = np.random.default_rng(1).integers(-32768, 32767, (3, N)).astype(np.int16)
    tail_start = np.array([0, 1116, 1498], np.int32)  # even; the last runs past N
    want = np.asarray(JA._slice_audio_tails(jnp.asarray(rows), jnp.asarray(tail_start), 128))
    got = TA._slice_audio_tails(torch.from_numpy(rows), torch.from_numpy(tail_start), 128)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pool_update_matches_jax():
    """Exact: eviction shifts and aligned chunk writes into chosen rows."""
    rng = np.random.default_rng(2)
    pool = rng.integers(-32768, 32767, (4, N)).astype(np.int16)
    lanes = np.array([2, 0, 3], np.int32)
    shifts = np.array([0, 16000, 3200], np.int32)
    starts = np.array([15872, 0, 128 * 700], np.int32)
    lens = np.array([16128, 32000, 20000], np.int32)
    chunks = rng.integers(-32768, 32767, (3, 32000)).astype(np.int16)
    want = np.asarray(JP._pool_update(
        jnp.asarray(pool), *(jnp.asarray(x) for x in (lanes, shifts, starts, lens, chunks))))
    tpool = torch.from_numpy(pool.copy())
    got = TP._pool_update(tpool, *(torch.from_numpy(x) for x in (lanes, shifts, starts, lens, chunks)))
    assert got is tpool  # updated in place
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# The slice: anchor -> inc -> inc -> inc
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    path = write_standin_vocab(tmp_path_factory.mktemp("vocab"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WLK_TPU_ASSET_DIR", str(path.parent))
        tok = get_tokenizer(True, language="en", task="transcribe")
    jp = JM.init_params(DIMS, jax.random.PRNGKey(0), jnp.float32)
    tm = TM.params_from_jax_numpy(jax.tree.map(np.asarray, jp), DIMS)
    cfg = dict(language="en", max_steps=4, audio_max_len=4.0,
               enc_tail_frames=128, enc_rewrite_margin=16)
    return (JA.AlignAttEngine(jp, DIMS, tok, JA.AlignAttConfig(**cfg)),
            TA.AlignAttEngine(tm, DIMS, tok, TA.AlignAttConfig(**cfg)), tok)


def _speechlike(B, seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    sig = np.stack([
        0.3 * np.sin(2 * np.pi * (180 + 60 * i) * t) * (1 + 0.4 * np.sin(2 * np.pi * 3.1 * t))
        + 0.05 * rng.standard_normal(t.shape)
        for i in range(B)
    ])
    return (np.clip(sig, -1, 1 - 1 / 32768) * 32768).astype(np.int16)


def _core_args(arr, eng, conv, scalar):
    return (
        conv(arr["prefix"]), conv(arr["prefix_len"]), conv(arr["sot_index"]),
        conv(arr["content_frames"]), conv(arr["last_attend"]), conv(arr["is_last"]),
        conv(arr["max_new"]), eng.suppress_mask, eng.align_layers, eng.align_heads,
        scalar(25, "i"), scalar(200, "i"), scalar(0.5, "f"), conv(arr["active"]),
        eng.cif_w, eng.cif_b,
    )


def test_tick_slice_anchor_then_inc_matches_jax(engines):
    je, te, tok = engines
    B, p_max, max_steps, tail = 2, 32, 4, 128
    pcm = _speechlike(B, 4.0, 3)
    lanes = np.array([1, 2], np.int32)
    jpool, tpool = jnp.zeros((3, N), jnp.int16), torch.zeros((3, N), dtype=torch.int16)
    shape = (3, DIMS.n_audio_ctx, DIMS.n_audio_state)
    jenc, tenc = jnp.zeros(shape, jnp.float32), torch.zeros(shape)
    jscalar = lambda v, k: jnp.int32(v) if k == "i" else jnp.float32(v)  # noqa: E731
    statics = dict(dims=DIMS, p_max=p_max, max_steps=max_steps, eot=tok.eot,
                   ts_begin=tok.timestamp_begin, no_speech_tok=tok.no_speech,
                   space_tok=tok.encode(" ")[0])
    prefixes = [list(tok.sot_sequence_including_notimestamps) for _ in range(B)]
    last_attend = np.full(B, -200, np.int32)
    synced = 0
    for tick in range(4):
        # the session host's incremental pool update: new samples from a
        # 128-aligned start (the overlap is resent)
        have = 16000 * (tick + 1)
        start = (synced // 128) * 128
        chunk = np.zeros((B, 32000), np.int16)
        chunk[:, : have - start] = pcm[:, start:have]
        upd = (lanes, np.zeros(B, np.int32), np.full(B, start, np.int32),
               np.full(B, have - start, np.int32), chunk)
        jpool = JP._pool_update(jpool, *(jnp.asarray(x) for x in upd))
        TP._pool_update(tpool, *(torch.from_numpy(x) for x in upd))
        win = have // 320
        arr = dict(
            prefix=np.full((B, p_max), tok.eot, np.int32),
            prefix_len=np.array([len(p) for p in prefixes], np.int32),
            sot_index=np.zeros(B, np.int32), content_frames=np.full(B, win, np.int32),
            last_attend=last_attend.copy(), is_last=np.array([False, tick == 3]),
            max_new=np.full(B, 50, np.int32), active=np.ones(B, bool),
        )
        for i, p in enumerate(prefixes):
            arr["prefix"][i, : len(p)] = p
        jargs = _core_args(arr, je, jnp.asarray, jscalar)
        targs = _core_args(arr, te, torch.from_numpy, lambda v, k: v)
        if tick == 0:
            jo, jenc = JA.alignatt_tick_anchor(
                je.params, jpool[lanes], jenc, jnp.asarray(lanes), *jargs, **statics)
            to, tenc = TA.alignatt_tick_anchor(
                te.model, tpool[torch.from_numpy(lanes).long()], tenc,
                torch.from_numpy(lanes), *targs, **statics)
        else:
            plan = (lanes, lanes, np.full(B, max(0, win - tail), np.int32),
                    np.full(B, win, np.int32),
                    np.full(B, max(0, synced // 320 - 16), np.int32))
            jo, jenc = JA.alignatt_tick_inc(
                je.params, jpool, jenc, *(jnp.asarray(x) for x in plan), *jargs,
                **statics, tail_frames=tail)
            to, tenc = TA.alignatt_tick_inc(
                te.model, tpool, tenc, *(torch.from_numpy(x) for x in plan), *targs,
                **statics, tail_frames=tail)
        jo, to = np.asarray(jo), to.numpy()
        assert to.dtype == np.int32 and to.shape == jo.shape == (B, 2 * max_steps + 5)
        np.testing.assert_array_equal(to[:, :-1], jo[:, :-1], err_msg=f"tick {tick}")
        np.testing.assert_allclose(to[:, -1].view(np.float32), jo[:, -1].view(np.float32),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(tenc.numpy()[1:], np.asarray(jenc)[1:], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
        # grow the prefixes with the kept tokens, as the session host does
        for i in range(B):
            prefixes[i] += [int(x) for x in jo[i, : jo[i, 2 * max_steps]]]
        last_attend = jo[:, 2 * max_steps + 2].astype(np.int32)
        synced = have


def test_legacy_tick_matches_jax(engines):
    """The plan-less full-window program (alignatt_tick), with CIF off and on.

    With CIF on, the fire flag is not compared: the integrator rescales the
    alphas so the cumulative sum ends at round(total), and the flag then
    tests ``cumsum - floor(cumsum[-1] / 0.999) >= 0`` at the last content
    frames, where the value is 0 up to f32 rounding — a summation-order
    coin flip in any two implementations."""
    je, te, tok = engines
    B, p_max, max_steps = 2, 32, 4
    audio = _speechlike(B, 2.0, 4)
    full = np.zeros((B, N), np.int16)
    full[:, : audio.shape[1]] = audio
    sot = list(tok.sot_sequence_including_notimestamps)
    arr = dict(
        prefix=np.full((B, p_max), tok.eot, np.int32), prefix_len=np.full(B, len(sot), np.int32),
        sot_index=np.zeros(B, np.int32), content_frames=np.full(B, 100, np.int32),
        last_attend=np.full(B, -200, np.int32), is_last=np.array([False, True]),
        max_new=np.full(B, 50, np.int32), active=np.array([True, False]),
    )
    arr["prefix"][:, : len(sot)] = sot
    statics = dict(dims=DIMS, p_max=p_max, max_steps=max_steps, eot=tok.eot,
                   ts_begin=tok.timestamp_begin, no_speech_tok=tok.no_speech,
                   space_tok=tok.encode(" ")[0])
    cif_w = np.random.default_rng(5).standard_normal(DIMS.n_audio_state).astype(np.float32)
    for use_cif in (False, True):
        jargs = list(_core_args(arr, je, jnp.asarray, lambda v, k: v))
        targs = list(_core_args(arr, te, torch.from_numpy, lambda v, k: v))
        if use_cif:
            jargs[-2:] = [jnp.asarray(cif_w), jnp.float32(0.3)]
            targs[-2:] = [torch.from_numpy(cif_w), 0.3]
        jo = np.asarray(JA.alignatt_tick(je.params, jnp.asarray(full), *jargs, **statics,
                                         use_cif=use_cif))
        to = TA.alignatt_tick(te.model, torch.from_numpy(full), *targs, **statics,
                              use_cif=use_cif).numpy()
        cols = slice(0, -2) if use_cif else slice(0, -1)  # -2: fire, -1: no_speech_p
        np.testing.assert_array_equal(to[:, cols], jo[:, cols], err_msg=f"use_cif={use_cif}")
        np.testing.assert_allclose(to[:, -1].view(np.float32), jo[:, -1].view(np.float32),
                                   rtol=0, atol=1e-5)


def test_anchor_with_mel_pallas_matches_jax(engines, monkeypatch):
    """The base anchor with the fused mel (K3): on the JAX side the Pallas
    kernel in interpret mode (``_tick_front`` imports it at call time), on
    the port's its plain version. Integer outputs exact, ``no_speech_p``
    within 1e-5, the cached encoder rows within 1e-4."""
    import functools

    from whisperlivekit_tpu.ops import mel_pallas as JMP

    monkeypatch.setattr(JMP, "log_mel_pallas", functools.partial(JMP.log_mel_pallas, interpret=True))
    je, te, tok = engines
    B, p_max, max_steps = 2, 32, 4
    audio = np.zeros((B, N), np.int16)
    audio[:, : 3 * 16000] = _speechlike(B, 3.0, 6)
    audio[1, 2 * 16000 :] = 0  # a lane that falls silent: the floor clamps there
    lanes = np.array([2, 0], np.int32)
    shape = (3, DIMS.n_audio_ctx, DIMS.n_audio_state)
    jenc, tenc = jnp.zeros(shape, jnp.float32), torch.zeros(shape)
    sot = list(tok.sot_sequence_including_notimestamps)
    arr = dict(
        prefix=np.full((B, p_max), tok.eot, np.int32), prefix_len=np.full(B, len(sot), np.int32),
        sot_index=np.zeros(B, np.int32), content_frames=np.full(B, 150, np.int32),
        last_attend=np.full(B, -200, np.int32), is_last=np.zeros(B, bool),
        max_new=np.full(B, 50, np.int32), active=np.ones(B, bool),
    )
    arr["prefix"][:, : len(sot)] = sot
    statics = dict(dims=DIMS, p_max=p_max, max_steps=max_steps, eot=tok.eot,
                   ts_begin=tok.timestamp_begin, no_speech_tok=tok.no_speech,
                   space_tok=tok.encode(" ")[0], mel_pallas=True)
    jo, jenc = JA.alignatt_tick_anchor(
        je.params, jnp.asarray(audio), jenc, jnp.asarray(lanes),
        *_core_args(arr, je, jnp.asarray, lambda v, k: v), **statics)
    to, tenc = TA.alignatt_tick_anchor(
        te.model, torch.from_numpy(audio), tenc, torch.from_numpy(lanes),
        *_core_args(arr, te, torch.from_numpy, lambda v, k: v), **statics)
    jo, to = np.asarray(jo), to.numpy()
    np.testing.assert_array_equal(to[:, :-1], jo[:, :-1])
    np.testing.assert_allclose(to[:, -1].view(np.float32), jo[:, -1].view(np.float32),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), rtol=0, atol=1e-4)
    assert np.abs(tenc.numpy()[lanes]).sum() > 0  # the rows were written


def test_engine_refuses_what_is_not_ported(engines):
    """Nothing the AlignAtt engine is configured with is refused any more:
    f8 storage and beam decoding, the last two it raised for, build now, as
    language auto-detect and the fused mel (K3) do. A beam session routes
    its ticks to ``run_tick_batch_beam`` (tests/test_torch_beam.py)."""
    _, te, tok = engines
    for kw in (dict(language="en", xkv_cache_dtype="f8"), dict(language="en", xkv_f8=True),
               dict(language="en", decoder_type="beam", beam_size=4)):
        eng = TA.AlignAttEngine(te.model, DIMS, tok, TA.AlignAttConfig(**kw))
        assert all(getattr(eng.cfg, k) == v for k, v in kw.items())
    eng = TA.AlignAttEngine(te.model, DIMS, tok, TA.AlignAttConfig(language="auto", mel_pallas=True))
    assert eng.cfg.language == "auto" and eng.cfg.mel_pallas
