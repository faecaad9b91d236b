"""Port parity: the kernel modules of whisperlivekit_tpu_torch against the JAX
package — the flash-attention plain version (and, on a GPU, the CUDA
kernel), the log-mel front-end and the median filter.

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
    flash_encoder_attn,
    flash_encoder_attn_plain,
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
    out = flash_encoder_attn(q, k, v, t_valid=20)
    assert flash_encoder_attn.launches == before
    torch.testing.assert_close(out, flash_encoder_attn_plain(q, k, v, 20), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,vt", [(1500, 1500, False), (384, 384, False), (64, 1500, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_on_gpu(S, T, vt, dtype):
    """The CUDA kernel against its plain version at the main path's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dt = getattr(torch, dtype)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(S + T)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dt)  # noqa: E731
    q = rnd(2, S, 8, 64).transpose(1, 2)
    if vt:
        k, v = rnd(2, 8, 64, T), rnd(2, 8, 64, T)
    else:
        k, v = rnd(2, T, 8, 64).permute(0, 2, 3, 1), rnd(2, T, 8, 64).transpose(1, 2)
    before = flash_encoder_attn.launches
    got = flash_encoder_attn(q, k, v, t_valid=T, v_transposed=vt)
    assert flash_encoder_attn.launches == before + 1
    want = flash_encoder_attn_plain(q, k, v, T, vt)
    tol = F32_TOL if dt == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _speechlike(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    sig = 0.3 * np.sin(2 * np.pi * (190 + 30 * seed) * t) * (1 + 0.4 * np.sin(2 * np.pi * 3.1 * t))
    return (sig + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)


@pytest.mark.parametrize("seconds,padding", [(1.25, 0), (2.0, 16000)])
def test_log_mel_matches_jax(seconds, padding):
    """1e-5 abs on the (x+4)/4-scaled log-mel: both compute f32 frames x
    DFT-basis products; only the summation order differs."""
    audio = np.stack([_speechlike(seconds, 0), _speechlike(seconds, 1)])
    want = np.asarray(JMEL.log_mel_spectrogram(jnp.asarray(audio), padding=padding))
    got = TMEL.log_mel_spectrogram(torch.from_numpy(audio), padding=padding).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
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
