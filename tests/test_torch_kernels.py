"""Port parity: the kernel modules of whisperlivekit_tpu_torch against the JAX
package — the flash-attention plain version (and, on a GPU, the CUDA
kernels), the routing of flash attention to its kernel bodies, the log-mel
front-end and the median filter.

Inputs are made with numpy from a seed and fed to both packages. On the CPU
the JAX Pallas kernel runs in interpret mode, as tests/test_flash_encoder.py
runs it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisperlivekit_tpu.audio import mel as JMEL
from whisperlivekit_tpu.ops.flash_encoder import (
    flash_encoder_attn as jax_flash,
    flash_encoder_attn_reference as jax_flash_ref,
)
from whisperlivekit_tpu.ops.median import median_filter as jax_median
from whisperlivekit_tpu_torch.audio import mel as TMEL
from whisperlivekit_tpu_torch.ops.flash_encoder import (
    _strides_bhtd,
    flash_encoder_attn,
    flash_encoder_attn_plain,
    k1_plan,
    k1_splits,
)
from whisperlivekit_tpu_torch.ops.median import median_filter

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

# f32: the JAX suite's bar (tests/test_flash_encoder.py) — sums taken in a
# different order; bf16: one bf16 rounding of P and of the output
F32_TOL = 2e-5
BF16_TOL = 2e-2


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _as_bf16_np(x):
    """numpy f32 values exactly representable in bf16 (same bits both sides)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


FLASH_CASES = [
    # (B, H, S, T, t_valid, v_transposed)
    (2, 4, 128, 128, 128, False),
    (1, 8, 256, 256, 250, False),
    (2, 4, 64, 384, 384, True),
]


@pytest.mark.parametrize("B,H,S,T,t_valid,vt", FLASH_CASES)
def test_flash_plain_matches_jax(B, H, S, T, t_valid, vt):
    Dh = 64
    q = _rand((B, H, S, Dh), 0)
    k = _rand((B, H, Dh, T), 1)
    v = _rand((B, H, Dh, T) if vt else (B, H, T, Dh), 2)
    ours = flash_encoder_attn_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), t_valid, vt
    ).numpy()
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                t_valid=t_valid, v_transposed=vt, interpret=True))
    v_std = np.swapaxes(v, -1, -2) if vt else v
    ref = np.asarray(jax_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v_std), t_valid))
    rows = slice(0, min(S, t_valid))
    np.testing.assert_allclose(ours[:, :, rows], want[:, :, rows], rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(ours[:, :, rows], ref[:, :, rows], rtol=F32_TOL, atol=F32_TOL)


def test_flash_plain_bf16_padded_cols():
    """bf16 inputs; padded key columns poisoned with 1e4 have no effect."""
    B, H, T, TV, Dh = 1, 2, 256, 200, 64
    q = _as_bf16_np(_rand((B, H, T, Dh), 6))
    k = _as_bf16_np(_rand((B, H, Dh, T), 7))
    v = _as_bf16_np(_rand((B, H, T, Dh), 8))
    k[:, :, :, TV:] = 1e4
    v[:, :, TV:, :] = -1e4
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    ours = flash_encoder_attn_plain(tq, tk, tv, TV).float().numpy()
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax_flash(jq, jk, jv, t_valid=TV, interpret=True)).astype(np.float32)
    ref = np.asarray(jax_flash_ref(jq, jk, jv, t_valid=TV)).astype(np.float32)
    assert np.isfinite(ours[:, :, :TV]).all()
    np.testing.assert_allclose(ours[:, :, :TV], want[:, :, :TV], rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(ours[:, :, :TV], ref[:, :, :TV], rtol=BF16_TOL, atol=BF16_TOL)


def test_flash_wrapper_takes_plain_version_on_cpu():
    """CPU tensors go to the plain version and launch nothing."""
    q = torch.from_numpy(_rand((1, 2, 16, 64), 9))
    k = torch.from_numpy(_rand((1, 2, 64, 24), 10))
    v = torch.from_numpy(_rand((1, 2, 24, 64), 11))
    before = flash_encoder_attn.launches
    bodies = sum(flash_encoder_attn.bodies.values())
    out = flash_encoder_attn(q, k, v, t_valid=20)
    assert flash_encoder_attn.launches == before
    assert sum(flash_encoder_attn.bodies.values()) == bodies
    torch.testing.assert_close(out, flash_encoder_attn_plain(q, k, v, 20), rtol=0, atol=0)


# -- routing: which kernel body a call takes, from shapes and strides alone --

def _layout(kind, B, H, S, T, Dh=64, dtype=torch.bfloat16, Tp=None):
    """(q, k, v, v_transposed) as the main path hands them over, as meta
    tensors (strides, no memory): "enc" = the encoder's strided views of the
    [B,T,H,Dh] projections; "dense" = the [B,H,Dh,T] cross-KV that
    ``cross_kv(transposed=True)`` builds; "pool" = one layer of the
    [L,G,H,Dh,Tp] cross-KV pool; q is a view of [B,S,H,Dh] at the cross
    sites."""
    meta = dict(dtype=dtype, device="meta")
    if kind == "enc":
        x = torch.empty(B, T, H, Dh, **meta)
        return x.transpose(1, 2)[:, :, :S], x.permute(0, 2, 3, 1), x.transpose(1, 2), False
    q = torch.empty(B, S, H, Dh, **meta).transpose(1, 2)
    if kind == "dense":
        return q, torch.empty(B, H, Dh, T, **meta), torch.empty(B, H, Dh, T, **meta), True
    pool = torch.empty(4, B, H, Dh, Tp, **meta)
    return q, pool[1], pool[2], True


def _plan(q, k, v, vt, t_valid):
    return k1_plan(q.dtype, q.shape, k.shape[-1], t_valid, q.stride(),
                   _strides_bhtd(k, True), _strides_bhtd(v, vt))


@pytest.mark.parametrize("B,H,S", [(8, 8, 1500), (8, 20, 1500), (8, 20, 160), (1, 20, 1500), (2, 8, 384)])
def test_k1_routes_encoder_views_to_tma(B, H, S):
    """The encoder's strided views (Dh contiguous, rows D*2 bytes apart)
    take the wgmma body with TMA, K and V both read Dh-major."""
    plan = _plan(*_layout("enc", B, H, S, S), S)
    assert plan.body == "wgmma_tma"
    assert (plan.k_t_unit, plan.v_t_unit) == (False, False)
    assert plan.n_consumers == 2


@pytest.mark.parametrize("S", [8, 32, 96, 256, 384])
def test_k1_routes_pool_to_tma(S):
    """The cross-KV pool ([G,H,Dh,1536]: rows of 3072 bytes) takes TMA,
    with the tensor map's T extent at t_valid = 1500."""
    plan = _plan(*_layout("pool", 8, 20, S, 1536, Tp=1536), 1500)
    assert plan.body == "wgmma_tma"
    assert (plan.k_t_unit, plan.v_t_unit) == (True, True)


@pytest.mark.parametrize("B,H,S", [(8, 8, 64), (8, 20, 96), (8, 20, 384), (1, 8, 8)])
def test_k1_routes_dense_cross_kv_to_cpasync(B, H, S):
    """The dense [B,H,Dh,1500] bf16 cross-KV has rows of 3000 bytes, which
    no tensor map can describe: the wgmma body loads it with cp.async."""
    plan = _plan(*_layout("dense", B, H, S, 1500), 1500)
    assert plan.body == "wgmma_cpasync"
    assert (plan.k_t_unit, plan.v_t_unit) == (True, True)


@pytest.mark.parametrize("kind", ["enc", "dense", "pool"])
def test_k1_routes_f32_to_cuda_cores(kind):
    """f32 stays on the CUDA-core body at every layout: TF32 tensor cores
    would miss the 2e-5 the reference phases hold the card to."""
    q, k, v, vt = _layout(kind, 8, 8, 64, 1500, dtype=torch.float32, Tp=1536)
    plan = _plan(q, k, v, vt, 1500)
    assert (plan.body, plan.n_split) == ("cuda_cores_f32", 1)


def test_k1_splits_small_s_and_not_the_full_window():
    """S=8 over T=1536 at B8xH20 is 160 blocks on 132 SMs: T is split. The
    full window (1920 blocks) and the 160-frame tail are not."""
    refresh = _plan(*_layout("pool", 8, 20, 8, 1536, Tp=1536), 1500)
    assert refresh.n_split > 1 and refresh.n_consumers == 1
    assert _plan(*_layout("enc", 8, 20, 1500, 1500), 1500).n_split == 1
    assert _plan(*_layout("enc", 8, 20, 160, 160), 160).n_split == 1


@pytest.mark.parametrize("B,H,S,t_valid", [(8, 20, 8, 1500), (1, 8, 8, 1500), (8, 8, 64, 1500),
                                           (2, 8, 1500, 1500), (3, 2, 77, 999), (1, 1, 8, 512),
                                           (8, 20, 8, 129)])
def test_k1_splits_leave_no_split_empty(B, H, S, t_valid):
    """Every split gets at least two key tiles of 128 and none is empty
    (the kernel refuses an empty one)."""
    nc = 1 if S <= 64 else 2
    n = k1_splits(B, H, S, t_valid, nc)
    tiles = -(-t_valid // 128)
    per = -(-tiles // n)
    assert 1 <= n <= tiles and (n - 1) * per < tiles
    assert n == 1 or per >= 2


@pytest.mark.parametrize("case", ["head dim", "q Dh stride", "kv unit stride", "odd rows", "dtype"])
def test_k1_plan_raises_on_what_no_body_takes(case):
    q, k, v, vt = _layout("dense", 2, 4, 16, 512)
    if case == "head dim":
        q, k, v, vt = _layout("dense", 2, 4, 16, 512, Dh=80)
    elif case == "q Dh stride":
        q = torch.empty(2, 4, 64, 16, dtype=torch.bfloat16, device="meta").transpose(-1, -2)
    elif case == "kv unit stride":
        k = torch.empty(2, 4, 64, 512, 2, dtype=torch.bfloat16, device="meta")[..., 0]
    elif case == "odd rows":  # T = 511: rows of 1022 bytes, not 8-byte steps
        q, k, v, vt = _layout("dense", 2, 4, 16, 511)
    else:
        q, k, v, vt = _layout("dense", 2, 4, 16, 512, dtype=torch.float16)
    with pytest.raises(ValueError):
        _plan(q, k, v, vt, k.shape[-1])


# (S, T, t_valid, layout, Dh, poison of the columns >= t_valid)
GPU_CASES = [
    (1500, 1500, 1500, "enc", 64, None),
    (160, 160, 160, "enc", 64, None),
    (384, 384, 384, "enc", 64, None),
    (1500, 1500, 1400, "enc", 64, float("nan")),
    (64, 1500, 1500, "dense", 64, None),
    (8, 1500, 1500, "dense", 64, None),
    (96, 1500, 1500, "dense", 64, None),
    (8, 1536, 1500, "pool", 64, 1e4),
    (96, 1536, 1500, "pool", 64, float("inf")),
    (160, 1536, 1500, "pool", 64, float("nan")),
    (160, 384, 300, "enc", 128, float("inf")),
    (96, 1500, 1400, "dense", 128, 1e4),
]


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,t_valid,layout,Dh,poison", GPU_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_on_gpu(S, T, t_valid, layout, Dh, poison, dtype):
    """The CUDA kernels against the plain version at the main path's shapes
    and layouts, with the padding columns poisoned; each call takes the body
    the routing names (bf16: wgmma, TMA except over the dense cross-KV;
    f32: CUDA cores), and S=8 over T=1500 splits T."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dt = getattr(torch, dtype)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(S + T + Dh)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dt)  # noqa: E731
    B, H = 2, 4
    q = rnd(B, S, H, Dh).transpose(1, 2)
    if layout == "enc":
        k, v, vt = rnd(B, T, H, Dh).permute(0, 2, 3, 1), rnd(B, T, H, Dh).transpose(1, 2), False
    else:
        k, v, vt = rnd(B, H, Dh, T), rnd(B, H, Dh, T), True
    if poison is not None:  # the kernel must read nothing past t_valid
        k[..., t_valid:] = poison
        (v[..., t_valid:] if vt else v[..., t_valid:, :]).fill_(poison)
    want_body = ("cuda_cores_f32" if dt == torch.float32
                 else "wgmma_cpasync" if layout == "dense" else "wgmma_tma")
    plan = _plan(q, k, v, vt, t_valid)
    assert plan.body == want_body
    before, bodies, splits = (flash_encoder_attn.launches, flash_encoder_attn.bodies[want_body],
                              flash_encoder_attn.splits[plan.n_split])
    got = flash_encoder_attn(q, k, v, t_valid=t_valid, v_transposed=vt)
    torch.cuda.synchronize()
    assert flash_encoder_attn.launches == before + 1
    assert flash_encoder_attn.bodies[want_body] == bodies + 1
    if dt == torch.bfloat16:
        assert flash_encoder_attn.splits[plan.n_split] == splits + 1
        if (S, T) == (8, 1500):
            assert plan.n_split > 1
    kv = k[..., :t_valid], (v[..., :t_valid] if vt else v[..., :t_valid, :])
    want = flash_encoder_attn_plain(q, *kv, t_valid, vt)
    tol = F32_TOL if dt == torch.float32 else BF16_TOL
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _speechlike(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    sig = 0.3 * np.sin(2 * np.pi * (190 + 30 * seed) * t) * (1 + 0.4 * np.sin(2 * np.pi * 3.1 * t))
    return (sig + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)


@pytest.mark.parametrize("seconds,padding", [(1.25, 0), (2.0, 16000)])
def test_log_mel_matches_jax(seconds, padding):
    """The repo's f32 bar (2e-5 abs) on the (x+4)/4-scaled log-mel: both
    compute f32 frames x DFT-basis products but sum them in different
    orders, and on one CPU one element of 48000 differed by 1.06e-5, so
    half the bar depends on the host's BLAS."""
    audio = np.stack([_speechlike(seconds, 0), _speechlike(seconds, 1)])
    want = np.asarray(JMEL.log_mel_spectrogram(jnp.asarray(audio), padding=padding))
    got = TMEL.log_mel_spectrogram(torch.from_numpy(audio), padding=padding).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    want_p = np.asarray(JMEL.pad_or_trim(jnp.asarray(want), 300))
    np.testing.assert_array_equal(TMEL.pad_or_trim(torch.tensor(want), 300).numpy(), want_p)


def test_mel_constants_match_jax():
    np.testing.assert_array_equal(TMEL.mel_filterbank(80), JMEL.mel_filterbank(80))
    np.testing.assert_array_equal(TMEL._dft_kernel(), JMEL._dft_kernel())
    assert (TMEL.N_SAMPLES, TMEL.N_FRAMES, TMEL.TOKENS_PER_SECOND) == (
        JMEL.N_SAMPLES, JMEL.N_FRAMES, JMEL.TOKENS_PER_SECOND)


@pytest.mark.parametrize("T", [3, 40, 1500])
def test_median_filter_matches_jax(T):
    """A median selects one of its inputs: the results are equal exactly."""
    x = _rand((2, 3, T), T)
    got = median_filter(torch.from_numpy(x), 7).numpy()
    want = np.asarray(jax_median(jnp.asarray(x), 7))
    np.testing.assert_array_equal(got, want)
