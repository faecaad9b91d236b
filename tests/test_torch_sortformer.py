"""The port's Sortformer (diarization/sortformer_model.py, sortformer.py)
against the JAX package's (sortformer_jax.py, sortformer.py) on the CPU, on
the same weights (the JAX pytree bridged through
``sortformer_params_from_jax``) and the same numpy-seeded inputs, at
DEV_TINY and the layout spec's geometry:

- ``nemo_log_mel``, ``subsample`` at T 37/40/48/199, the rel-pos attention
  and ``forward`` within 2e-5 (f32);
- the port's NeMo converter against the JAX converter bridged, on
  tests/test_sortformer_jax.py's synthetic state dict: equal bit for bit;
  unmapped keys raise;
- ``streaming_step`` over 24 chunks (the FIFO overflows and the cache
  compresses many times): probabilities within 2e-5, ``spkcache_len``,
  ``fifo_len`` and the kept rows exact;
- ``_compress_into_cache`` on planted ties at the quota boundary (the
  port's stable sort keeps ``lax.top_k``'s lower-index-first order);
- an online session's SpeakerSegments equal JAX's, across an
  ``insert_silence``.
"""

import asyncio
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperlivekit_tpu.diarization import sortformer as JSS
from whisperlivekit_tpu.diarization import sortformer_jax as JS
from whisperlivekit_tpu_torch.diarization import sortformer as TSS
from whisperlivekit_tpu_torch.diarization import sortformer_model as TS
from test_sortformer_jax import synthetic_nemo_state_dict

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

DIMS = JS.DEV_TINY
TOL = dict(rtol=2e-5, atol=2e-5)


def _bridge(params, dims=DIMS):
    dims = TS.SortformerDims(**dataclasses.asdict(dims))
    return TS.sortformer_params_from_jax(jax.tree.map(np.asarray, params), dims)


@pytest.fixture(scope="module")
def random_pair():
    jp = JS.init_params(DIMS, jax.random.PRNGKey(0))
    return jp, _bridge(jp)


@pytest.fixture(scope="module")
def converted_pair():
    """The layout spec's geometry: the synthetic NeMo checkpoint (seed 3)
    through the JAX converter, bridged."""
    sd = synthetic_nemo_state_dict(DIMS, seed=3)
    jp, dims = JS.convert_nemo_state_dict(sd, dims=DIMS)
    return jp, _bridge(jp, dims), dims


def _speech(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    sig = 0.3 * np.sin(2 * np.pi * (180 + 40 * seed) * t) * (1 + 0.4 * np.sin(2 * np.pi * 3.1 * t))
    return (sig + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)


@pytest.mark.parametrize("n_mels", [64, 128])
def test_nemo_log_mel_matches_jax(n_mels):
    audio = np.stack([_speech(1.0, 0), _speech(1.0, 1)])
    want = np.asarray(JSS.nemo_log_mel(jnp.asarray(audio), n_mels))
    got = TSS.nemo_log_mel(torch.from_numpy(audio), n_mels).numpy()
    assert got.shape == want.shape == (2, 101, n_mels)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("T", [37, 40, 48, 199])
def test_subsample_matches_jax(converted_pair, T):
    jp, tm, dims = converted_pair
    mel = np.random.default_rng(T).standard_normal((2, T, dims.n_mels)).astype(np.float32)
    want = np.asarray(JS.subsample(jp, jnp.asarray(mel), dims))
    got = TS.subsample(tm, torch.from_numpy(mel), dims).numpy()
    assert got.shape == want.shape == (2, -(-T // 8), dims.d_encoder)
    np.testing.assert_allclose(got, want, **TOL)


def test_relpos_pieces_match_jax(converted_pair):
    jp, tm, dims = converted_pair
    T, d, H = 6, dims.d_encoder, dims.encoder_heads
    np.testing.assert_array_equal(TS._relpos_table(T, d), JS._relpos_table(T, d))
    bd = np.random.default_rng(0).standard_normal((1, 2, T, 2 * T - 1)).astype(np.float32)
    np.testing.assert_array_equal(TS._rel_shift(torch.from_numpy(bd)).numpy(),
                                  np.asarray(JS._rel_shift(jnp.asarray(bd))))
    x = np.random.default_rng(1).standard_normal((2, T, d)).astype(np.float32)
    pe = JS._relpos_table(T, d)
    attn = jax.tree.map(lambda a: a[0], jp["conformer"])["attn"]
    want = np.asarray(JS._relpos_attend(jnp.asarray(x), attn, jnp.asarray(pe), H))
    got = TS._relpos_attend(torch.from_numpy(x), tm.conformer[0].attn, torch.from_numpy(pe), H).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("which", ["random", "converted"])
def test_forward_matches_jax(random_pair, converted_pair, which):
    jp, tm = random_pair if which == "random" else converted_pair[:2]
    mel = np.random.default_rng(4).standard_normal((2, 64, DIMS.n_mels)).astype(np.float32)
    want = np.asarray(JS.forward(jp, jnp.asarray(mel), DIMS))
    got = TS.forward(tm, torch.from_numpy(mel), DIMS).numpy()
    assert got.shape == (2, 8, DIMS.max_speakers)
    np.testing.assert_allclose(got, want, **TOL)


def test_converter_equals_jax_converter_bridged():
    sd = synthetic_nemo_state_dict(DIMS)
    jp, jdims = JS.convert_nemo_state_dict(sd)
    tm, tdims = TS.convert_nemo_state_dict(sd)
    assert dataclasses.asdict(tdims) == dataclasses.asdict(jdims)
    want, got = _bridge(jp, jdims).state_dict(), tm.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # torch tensors (read_nemo_state_dict's output) convert the same
    tm2, _ = TS.convert_nemo_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    assert all(torch.equal(tm2.state_dict()[k], got[k]) for k in got)


def test_converter_rejects_unmapped_keys():
    sd = synthetic_nemo_state_dict(DIMS)
    sd["encoder.layers.0.mystery.weight"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unmapped"):
        TS.convert_nemo_state_dict(sd)
    with pytest.raises(ValueError, match="unmapped"):
        JS.convert_nemo_state_dict(sd)


def test_read_nemo_state_dict_from_tar(tmp_path):
    """A .nemo tar holding model_weights.ckpt (NeMo's layout) reads into the
    same tensors JAX's reader gives (as f32 numpy)."""
    import io
    import tarfile

    sd = synthetic_nemo_state_dict(DIMS, seed=5)
    buf = io.BytesIO()
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, buf)
    path = tmp_path / "tiny.nemo"
    with tarfile.open(path, "w") as tar:
        info = tarfile.TarInfo("./model_weights.ckpt")
        info.size = buf.getbuffer().nbytes
        buf.seek(0)
        tar.addfile(info, buf)
    got, want = TS.read_nemo_state_dict(str(path)), JS.read_nemo_state_dict(str(path))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_streaming_step_matches_jax_over_many_chunks(random_pair, monkeypatch):
    """24 chunks: the FIFO (12 rows) overflows on the third and the cache
    (16 rows) recompresses on every chunk from there."""
    jp, tm = random_pair
    calls = []
    real = TS._compress_into_cache
    monkeypatch.setattr(TS, "_compress_into_cache", lambda *a: calls.append(1) or real(*a))
    rng = np.random.default_rng(7)
    T = DIMS.left_ctx_mel_frames + DIMS.chunk_mel_frames
    js, ts = JS.init_state(DIMS, 2), TS.init_state(DIMS, 2)
    for step in range(24):
        mel = rng.standard_normal((2, T, DIMS.n_mels)).astype(np.float32)
        jprobs, js = JS.streaming_step(jp, js, jnp.asarray(mel), DIMS, ctx_frames=DIMS.left_ctx_mel_frames)
        tprobs, ts = TS.streaming_step(tm, ts, torch.from_numpy(mel), DIMS, ctx_frames=DIMS.left_ctx_mel_frames)
        np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), **TOL)
        np.testing.assert_array_equal(ts.spkcache_len.numpy(), np.asarray(js.spkcache_len))
        np.testing.assert_array_equal(ts.fifo_len.numpy(), np.asarray(js.fifo_len))
        np.testing.assert_array_equal(ts.n_sil_frames.numpy(), np.asarray(js.n_sil_frames))
        for name in ("spkcache", "spkcache_preds", "fifo", "mean_sil_emb"):
            np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), **TOL)
    assert int(ts.fifo_len.min()) == DIMS.fifo_len and int(ts.spkcache_len.min()) > 0
    assert len(calls) == 22


def _planted_state(B=3, Lp=6):
    """Cache/popped predictions whose speaker-0 scores tie at the quota
    boundary: quota = 16 // 4 = 4, and five candidates share the 4th score,
    so which of them is kept is decided by the tie order alone."""
    Lc, S, D = DIMS.spkcache_len, DIMS.max_speakers, DIMS.d_model
    rng = np.random.default_rng(11)
    cache = rng.standard_normal((B, Lc, D)).astype(np.float32)
    popped = rng.standard_normal((B, Lp, D)).astype(np.float32)
    preds = rng.uniform(0.0, 0.04, (B, Lc + Lp, S)).astype(np.float32)  # under the 0.05 floor
    preds[:, [1, 4], 0] = 0.9
    preds[:, [0, 3, 7, 12, 19], 0] = 0.75                                 # the tie across the boundary
    preds[:, [2, 9], 1] = 0.6
    preds[:, [5, 6, 8, 13, 17, 20], 2] = 0.55                             # a tie past the quota too
    preds[:, [10, 21], 3] = np.float32(0.3)
    cache_len = np.array([Lc, 10, 16], np.int32)
    popped_valid = np.ones((B, Lp), bool)
    popped_valid[1, 4:] = False
    return cache, preds[:, :Lc], cache_len, popped, preds[:, Lc:], popped_valid


def test_compress_into_cache_keeps_jax_tie_order():
    cache, cache_preds, cache_len, popped, popped_preds, popped_valid = _planted_state()
    B, D = cache.shape[0], DIMS.d_model
    mean_sil = np.random.default_rng(12).standard_normal((B, D)).astype(np.float32)
    n_sil = np.array([0, 3, 1], np.int32)
    jst = JS.init_state(DIMS, B)._replace(
        spkcache=jnp.asarray(cache), spkcache_preds=jnp.asarray(cache_preds),
        spkcache_len=jnp.asarray(cache_len), mean_sil_emb=jnp.asarray(mean_sil),
        n_sil_frames=jnp.asarray(n_sil))
    tst = TS.init_state(DIMS, B)._replace(
        spkcache=torch.from_numpy(cache), spkcache_preds=torch.from_numpy(cache_preds),
        spkcache_len=torch.from_numpy(cache_len), mean_sil_emb=torch.from_numpy(mean_sil),
        n_sil_frames=torch.from_numpy(n_sil))
    want = JS._compress_into_cache(jst, jnp.asarray(popped), jnp.asarray(popped_preds),
                                   jnp.asarray(popped_valid), DIMS)
    got = TS._compress_into_cache(tst, torch.from_numpy(popped), torch.from_numpy(popped_preds),
                                  torch.from_numpy(popped_valid), DIMS)
    np.testing.assert_array_equal(got.spkcache_len.numpy(), np.asarray(want.spkcache_len))
    np.testing.assert_array_equal(got.n_sil_frames.numpy(), np.asarray(want.n_sil_frames))
    np.testing.assert_array_equal(got.spkcache.numpy(), np.asarray(want.spkcache))  # kept rows, bit for bit
    np.testing.assert_array_equal(got.spkcache_preds.numpy(), np.asarray(want.spkcache_preds))
    np.testing.assert_allclose(got.mean_sil_emb.numpy(), np.asarray(want.mean_sil_emb), **TOL)
    # the ties bound: speaker 0 keeps the two lowest-index 0.75s (0 and 3,
    # not 7, 12 or 19), speaker 2 the four lowest 0.55s (not 17 or 20)
    kept = {0: [0, 1, 2, 3, 4, 5, 6, 8, 9, 10, 13, 21], 1: [0, 1, 2, 3, 4, 5, 6, 8, 9, 17]}
    assert got.spkcache_len.tolist() == [12, 10, 12]
    for b, rows in kept.items():
        cand = np.concatenate([cache[b], popped[b]])
        np.testing.assert_array_equal(got.spkcache[b, : len(rows)].numpy(), cand[rows])


def test_top_quota_breaks_ties_by_index():
    score = torch.tensor([[0.5, 0.7, 0.5, 0.7, 0.5, -math.inf]])
    assert TS._top_quota(score, 3).tolist() == [[1, 3, 0]]
    _, idx = jax.lax.top_k(jnp.asarray(score.numpy()), 3)
    assert np.asarray(idx).tolist() == [[1, 3, 0]]


def _segments(sess, audio_parts, silence_after=None):
    async def run():
        out = []
        for i, part in enumerate(audio_parts):
            sess.insert_audio_chunk(part)
            while True:
                segs = await sess.diarize()
                if not segs:
                    break
                out.extend((s.speaker, s.start, s.end) for s in segs)
            if silence_after is not None and i == silence_after:
                sess.insert_silence(3.0)
        return out
    return asyncio.run(run())


def test_online_session_segments_match_jax(random_pair):
    jp, tm = random_pair
    parts = [_speech(1.3, 2), _speech(0.9, 3), _speech(2.0, 4)]
    want = _segments(JSS.SortformerDiarization(jp, DIMS).new_session(), parts, silence_after=1)
    sess = TSS.SortformerDiarization(tm, DIMS).new_session()
    got = _segments(sess, parts, silence_after=1)
    assert got == want and len({s for s, _, _ in got}) >= 1
    assert got[0][1] == 0.0 and max(e for _, _, e in got) > 3.0  # the silence moved the clock
    assert sess.chunk_index == (len(np.concatenate(parts)) // sess.chunk_samples)


def test_load_sortformer_random_and_missing(monkeypatch):
    from types import SimpleNamespace

    shared = TSS.load_sortformer(SimpleNamespace(sortformer_model_path="random:"), device="cpu")
    assert shared.dims == TS.DEV_TINY and shared.params.device.type == "cpu"
    with pytest.raises(FileNotFoundError):
        TSS.load_sortformer(SimpleNamespace(sortformer_model_path=None), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TSS.load_sortformer(SimpleNamespace(sortformer_model_path="random:"))
