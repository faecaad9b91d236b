"""Port parity: models/whisper/model.py of whisperlivekit_tpu_torch against the
JAX module on the same weights (JAX ``init_params`` -> numpy ->
``params_from_jax_numpy``) and the same numpy inputs, at dev-tiny size.

Tolerance 1e-4 abs (f32): both sides compute f32 matmuls on the CPU and
differ only in summation order, which several layers amplify to ~1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperlivekit_tpu.models.whisper import model as JM
from whisperlivekit_tpu.models.whisper.dims import MODEL_DIMS
from whisperlivekit_tpu_torch.models.whisper import model as TM

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

TOL = 1e-4
DIMS = MODEL_DIMS["dev-tiny"]
ALIGN_PAIRS = [(1, 0), (1, 2), (0, 3)]


@pytest.fixture(scope="module")
def weights():
    jp = JM.init_params(DIMS, jax.random.PRNGKey(0), jnp.float32)
    tm = TM.params_from_jax_numpy(jax.tree.map(np.asarray, jp), DIMS)
    return jp, tm


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


def test_init_params_matches_jax_layout(weights):
    """The port's seeded init has the bridged module's shapes, dtype and the
    JAX init's scales (std of normal*d_in**-0.5 is d_in**-0.5)."""
    _, bridged = weights
    own = TM.init_params(DIMS, torch.Generator().manual_seed(0))
    shapes = lambda m: {n: tuple(p.shape) for n, p in m.named_parameters()}  # noqa: E731
    assert shapes(own) == shapes(bridged)
    fc1 = own.decoder.blocks[0].fc1.weight
    assert abs(fc1.std().item() - DIMS.n_text_state ** -0.5) < 0.02
    assert not any(p.requires_grad for p in own.parameters())


@pytest.mark.parametrize("with_pos_start", [False, True])
def test_encode_matches_jax(weights, with_pos_start):
    jp, tm = weights
    mel = _rand((2, DIMS.n_mels, 400), 0)
    ps = np.array([0, 700], np.int32) if with_pos_start else None
    want = JM.encode(jp, jnp.asarray(mel), DIMS,
                     pos_start=None if ps is None else jnp.asarray(ps))
    got = TM.encode(tm, torch.from_numpy(mel), DIMS,
                    pos_start=None if ps is None else torch.from_numpy(ps))
    assert tuple(got.shape) == (2, 200, DIMS.n_audio_state)
    _close(got.numpy(), want)


@pytest.mark.parametrize("transposed", [False, True])
def test_cross_kv_matches_jax(weights, transposed):
    jp, tm = weights
    enc = _rand((2, 160, DIMS.n_audio_state), 1)
    want = JM.cross_kv(jp, jnp.asarray(enc), DIMS, transposed=transposed)
    got = TM.cross_kv(tm, torch.from_numpy(enc), DIMS, transposed=transposed)
    assert tuple(got.k.shape) == want.k.shape
    _close(got.k.numpy(), want.k)
    _close(got.v.numpy(), want.v)


def _xkv_both(jp, tm, T=256):
    enc = _rand((2, T, DIMS.n_audio_state), 2)
    return (JM.cross_kv(jp, jnp.asarray(enc), DIMS, transposed=True),
            TM.cross_kv(tm, torch.from_numpy(enc), DIMS, transposed=True))


def test_decode_prefill_align_reduce_matches_jax(weights):
    """Prefill with in-loop alignment reductions over a padded cross-KV
    (columns >= t_valid masked), as the tick's prefill runs it."""
    jp, tm = weights
    jx, tx = _xkv_both(jp, tm)
    B, P, W, t_valid = 2, 16, 24, 200
    tokens = np.random.default_rng(3).integers(0, 50000, (B, P)).astype(np.int32)
    plen = np.array([10, 16])
    row_mask = (np.arange(P)[None] < plen[:, None]).astype(np.float32)
    last = (np.arange(P)[None] == (plen - 1)[:, None]).astype(np.float32)
    jal = JM.AlignSpec.from_pairs(ALIGN_PAIRS)
    tal = TM.AlignSpec.from_pairs(ALIGN_PAIRS)
    jcache = JM.init_cache(DIMS, B, width=W)
    tcache = TM.init_cache(DIMS, B, width=W)
    jl, jstats, jc = JM.decode(
        jp, jnp.asarray(tokens), jnp.zeros(B, jnp.int32), jx, jcache, DIMS,
        align=jal, align_reduce=(jnp.asarray(row_mask), jnp.asarray(last)),
        xkv_transposed=True, t_valid=t_valid,
    )
    tl, tstats, tc = TM.decode(
        tm, torch.from_numpy(tokens), torch.zeros(B, dtype=torch.int32), tx, tcache, DIMS,
        align=tal, align_reduce=(torch.from_numpy(row_mask), torch.from_numpy(last)),
        xkv_transposed=True, t_valid=t_valid,
    )
    _close(tl.numpy(), jl)
    for a, b in zip(tstats, jstats):
        assert tuple(a.shape) == b.shape == (B, len(ALIGN_PAIRS), t_valid)
        _close(a.numpy(), b)
    _close(tc.k.numpy(), jc.k)
    _close(tc.v.numpy(), jc.v)


def test_decode_steps_with_align_matches_jax(weights):
    """S=1 steps at per-lane positions, returning the alignment heads'
    probability rows, over a cache filled by a prefill."""
    jp, tm = weights
    jx, tx = _xkv_both(jp, tm, T=192)
    B, P, W = 2, 8, 16
    rng = np.random.default_rng(4)
    prefix = rng.integers(0, 50000, (B, P)).astype(np.int32)
    jal = JM.AlignSpec.from_pairs(ALIGN_PAIRS)
    tal = TM.AlignSpec.from_pairs(ALIGN_PAIRS)
    _, _, jc = JM.decode(jp, jnp.asarray(prefix), jnp.zeros(B, jnp.int32), jx,
                         JM.init_cache(DIMS, B, width=W), DIMS, xkv_transposed=True)
    _, _, tc = TM.decode(tm, torch.from_numpy(prefix), torch.zeros(B, dtype=torch.int32), tx,
                         TM.init_cache(DIMS, B, width=W), DIMS, xkv_transposed=True)
    pos = np.array([5, 8], np.int32)
    for step in range(3):
        tok = rng.integers(0, 50000, (B, 1)).astype(np.int32)
        jl, jprobs, jc = JM.decode(jp, jnp.asarray(tok), jnp.asarray(pos + step), jx, jc, DIMS,
                                   align=jal, xkv_transposed=True)
        tl, tprobs, tc = TM.decode(tm, torch.from_numpy(tok), torch.from_numpy(pos + step), tx,
                                   tc, DIMS, align=tal, xkv_transposed=True)
        _close(tl.numpy(), jl)
        assert tuple(tprobs.shape) == jprobs.shape == (len(ALIGN_PAIRS), B, 1, 192)
        _close(tprobs.numpy(), jprobs)
    _close(tc.k.numpy(), jc.k)
    _close(tc.v.numpy(), jc.v)


def test_decode_positions_override_matches_jax(weights):
    """Non-contiguous rows (positions_override) with padding rows parked on
    the scratch slot W-1, over the [B,T,H,Dh] cross-KV layout."""
    jp, tm = weights
    enc = _rand((2, 128, DIMS.n_audio_state), 5)
    jx = JM.cross_kv(jp, jnp.asarray(enc), DIMS)
    tx = TM.cross_kv(tm, torch.from_numpy(enc), DIMS)
    W = 12
    tokens = np.random.default_rng(6).integers(0, 50000, (2, 4)).astype(np.int32)
    rows = np.array([[0, 3, 4, W - 1], [0, 1, 2, 5]], np.int32)
    jl, _, jc = JM.decode(jp, jnp.asarray(tokens), jnp.zeros(2, jnp.int32), jx,
                          JM.init_cache(DIMS, 2, width=W), DIMS,
                          positions_override=jnp.asarray(rows))
    tl, _, tc = TM.decode(tm, torch.from_numpy(tokens), torch.zeros(2, dtype=torch.int32), tx,
                          TM.init_cache(DIMS, 2, width=W), DIMS,
                          positions_override=torch.from_numpy(rows))
    # the padding row (scratch slot) is garbage by contract; compare the rest
    _close(tl.numpy()[0, :3], np.asarray(jl)[0, :3])
    _close(tl.numpy()[1], np.asarray(jl)[1])
    _close(tc.k.numpy()[:, :, : W - 1], np.asarray(jc.k)[:, :, : W - 1])


# bf16, the dtype the server runs. Both sides hold the same bf16 weights
# (the f32 JAX init rounded once to bf16 on each side).
BF16_ULP = 2.0 ** -7  # relative spacing of bf16 values


@pytest.fixture(scope="module")
def weights_bf16(weights):
    jp, _ = weights
    jp16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tm16 = TM.params_from_jax_numpy(jax.tree.map(np.asarray, jp), DIMS, dtype=torch.bfloat16)
    return jp16, tm16


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x).astype(np.float32)


def _assert_one_rounding(got, want):
    """Both sides sum in f32 in different orders, so a result may land on
    the other side of a rounding boundary: at most one bf16 step apart
    (near zero, where a step is tiny, the f32 sums' own error, < 1e-5 at
    these sizes, is covered by 1e-4), and rarely."""
    diff = np.abs(_f32(got) - want)
    assert (diff <= np.abs(want) * BF16_ULP + 1e-4).all(), diff.max()
    assert (diff > 0).mean() < 1e-3, (diff > 0).mean()


def test_dense_bf16_rounds_once_like_jax():
    """``dense`` keeps the bf16 product in f32, adds the bias and rounds
    once, as JAX's ``preferred_element_type=f32`` dot does (rounding the
    product before the bias add puts ~30% of the elements a step off)."""
    rng = np.random.default_rng(12)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((4, 50, 256), (256, 384), (384,)))
    w /= 16
    want = _f32(JM.dense(jnp.asarray(x, jnp.bfloat16),
                         {"w": jnp.asarray(w, jnp.bfloat16), "b": jnp.asarray(b, jnp.bfloat16)}))
    d = TM.Dense(256, 384).requires_grad_(False)
    d.weight.data = torch.from_numpy(w.T.copy()).to(torch.bfloat16)
    d.bias.data = torch.from_numpy(b).to(torch.bfloat16)
    got = TM.dense(torch.from_numpy(x).to(torch.bfloat16), d)
    assert got.dtype == torch.bfloat16
    _assert_one_rounding(got, want)


@pytest.mark.cuda
def test_dense_bf16_on_gpu_matches_cpu():
    """On CUDA, ``dense`` hands the bf16 operands to cuBLAS with an f32
    output; the result equals the CPU path's (widened operands) up to the
    summation order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((8, 40, 512)).astype(np.float32)).to(torch.bfloat16)
    d = TM.Dense(512, 2048).requires_grad_(False)
    d.weight.data = torch.from_numpy(rng.standard_normal((2048, 512)).astype(np.float32) / 22).to(torch.bfloat16)
    d.bias.data = torch.from_numpy(rng.standard_normal(2048).astype(np.float32)).to(torch.bfloat16)
    want = _f32(TM.dense(x, d))
    got = TM.dense(x.cuda(), d.cuda())
    assert got.is_cuda and got.dtype == torch.bfloat16
    _assert_one_rounding(got.cpu(), want)


def test_bf16_encode_and_prefill_match_jax(weights_bf16):
    """The bf16 encoder and the bf16 prefill (align_reduce, t_valid) against
    JAX in bf16. The JAX CPU reference rounds ``gelu`` on bf16 through a
    lower-precision path (40% of its bf16 gelu outputs are one step off
    the f32-then-round value the port computes), so the encoder features
    (post-LayerNorm, |x| < 4) are held to 4 bf16 steps at |x| in [2, 4),
    0.0625; the logits (f32, |x| < 1) to the kernel suite's bf16 bar 2e-2,
    and every position's argmax token must agree. The alignment statistics
    (f32) share the 2e-2 bar; the bf16 K/V cache rows the 0.0625 one."""
    jp, tm = weights_bf16
    mel = _rand((2, DIMS.n_mels, 400), 0)
    want = JM.encode(jp, jnp.asarray(mel), DIMS)
    got = TM.encode(tm, torch.from_numpy(mel), DIMS)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    _close(_f32(got), _f32(want), tol=0.0625)

    enc = _rand((2, 256, DIMS.n_audio_state), 2)
    jx = JM.cross_kv(jp, jnp.asarray(enc, jnp.bfloat16), DIMS, transposed=True)
    tx = TM.cross_kv(tm, torch.from_numpy(enc).to(torch.bfloat16), DIMS, transposed=True)
    _close(_f32(tx.k), _f32(jx.k), tol=0.0625)
    B, P, W, t_valid = 2, 16, 24, 200
    tokens = np.random.default_rng(3).integers(0, 50000, (B, P)).astype(np.int32)
    plen = np.array([10, 16])
    row_mask = (np.arange(P)[None] < plen[:, None]).astype(np.float32)
    last = (np.arange(P)[None] == (plen - 1)[:, None]).astype(np.float32)
    jl, jstats, jc = JM.decode(
        jp, jnp.asarray(tokens), jnp.zeros(B, jnp.int32), jx,
        JM.init_cache(DIMS, B, dtype=jnp.bfloat16, width=W), DIMS,
        align=JM.AlignSpec.from_pairs(ALIGN_PAIRS),
        align_reduce=(jnp.asarray(row_mask), jnp.asarray(last)),
        xkv_transposed=True, t_valid=t_valid,
    )
    tl, tstats, tc = TM.decode(
        tm, torch.from_numpy(tokens), torch.zeros(B, dtype=torch.int32), tx,
        TM.init_cache(DIMS, B, dtype=torch.bfloat16, width=W), DIMS,
        align=TM.AlignSpec.from_pairs(ALIGN_PAIRS),
        align_reduce=(torch.from_numpy(row_mask), torch.from_numpy(last)),
        xkv_transposed=True, t_valid=t_valid,
    )
    assert tl.dtype == torch.float32
    _close(tl.numpy(), _f32(jl), tol=2e-2)
    np.testing.assert_array_equal(tl.numpy().argmax(-1), np.asarray(jl).argmax(-1))
    for a, b in zip(tstats, jstats):  # f32 softmax sums over bf16 q, k
        _close(a.numpy(), _f32(b), tol=2e-2)
    _close(_f32(tc.k), _f32(jc.k), tol=0.0625)
    _close(_f32(tc.v), _f32(jc.v), tol=0.0625)
