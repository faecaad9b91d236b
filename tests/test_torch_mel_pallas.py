"""Port parity for kernel K3 (the fused log-mel front end): the plain
version in whisperlivekit_tpu_torch/ops/mel_pallas.py against the JAX
package's Pallas kernel in interpret mode, on the same numpy audio.

The bar is the JAX suite's (tests/test_mel_pallas.py): rtol 1e-4, atol 2e-4,
set for f32 sums taken in another order. The padded bases are the same
constants, so they must be equal bit for bit. The CUDA kernel itself runs
only on the card (the ``cuda``-marked test, and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisperlivekit_tpu.ops import mel_pallas as JMP
from whisperlivekit_tpu_torch.audio.mel import N_SAMPLES, mel_filterbank
from whisperlivekit_tpu_torch.ops import mel_pallas as TMP

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6


def _noise(B, n, seed):
    return (0.2 * np.random.default_rng(seed).standard_normal((B, n))).astype(np.float32)


@pytest.mark.parametrize("seconds,B,n_mels", [
    (2.0, 2, 80),
    (30.0, 2, 80),
    (3.0, 1, 128),
    (0.01, 1, 80),   # one frame: the padding reflects more than once
    (0.02, 1, 128),  # two frames
])
def test_plain_matches_jax_kernel(seconds, B, n_mels):
    audio = _noise(B, int(16000 * seconds), seed=int(seconds * 100) + n_mels)
    want = np.asarray(JMP.log_mel_pallas(jnp.asarray(audio), n_mels=n_mels, interpret=True))
    got = TMP.log_mel_pallas_plain(torch.from_numpy(audio), n_mels).numpy()
    assert got.shape == want.shape == (B, n_mels, audio.shape[1] // 160)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_padded_bases_equal_jax(n_mels):
    for got, want in zip(TMP._padded_bases(n_mels), JMP._padded_bases(n_mels)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_ranges_hold_every_nonzero_weight(n_mels):
    """The kernel sums each filter over its [lo, hi) bins only: every weight
    outside is an exact zero, so the skipped terms change no sum."""
    fb = mel_filterbank(n_mels)
    ranges = TMP._mel_ranges(n_mels)
    for m, (lo, hi) in enumerate(ranges):
        outside = np.concatenate([fb[m, :lo], fb[m, hi:]])
        assert not outside.any(), m
        assert hi == lo == 0 or fb[m, lo] != 0 and fb[m, hi - 1] != 0


def test_full_window_shape():
    out = TMP.log_mel_pallas_plain(torch.zeros((1, N_SAMPLES)))
    assert out.shape == (1, 80, 3000)
    # silence: log10 of the 1e-10 clamp everywhere, (-10 + 4) / 4
    assert torch.equal(out, torch.full_like(out, -1.5))


def test_wrapper_on_cpu_is_the_plain_version():
    audio = torch.from_numpy(_noise(2, 32000, seed=4))
    before = TMP.log_mel_pallas.launches
    got = TMP.log_mel_pallas(audio, 80)
    assert TMP.log_mel_pallas.launches == before  # no kernel on the CPU
    assert torch.equal(got, TMP.log_mel_pallas_plain(audio, 80))
    assert torch.equal(TMP.log_mel_pallas(audio[0], 80), got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_kernel_matches_plain_on_gpu(n_mels):
    """The CUDA kernel against its plain version at the full window and a
    ragged length, with a silent lane and a lane silent past 5 s (where the
    floor clamps)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain side stays f32
    for n in (N_SAMPLES, 32000 + 77):
        audio = torch.from_numpy(_noise(4, n, seed=n_mels)).cuda()
        audio[1] = 0
        audio[2, 80000:] = 0
        before = TMP.log_mel_pallas.launches
        got = TMP.log_mel_pallas(audio, n_mels)
        want = TMP.log_mel_pallas_plain(audio, n_mels)
        torch.cuda.synchronize()
        assert TMP.log_mel_pallas.launches == before + 1
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=2e-4)
