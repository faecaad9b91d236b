"""Port parity for kernel K3 (the fused log-mel front end): the plain
version in whisperlivekit_tpu_torch/ops/mel_pallas.py against the JAX
package's Pallas kernel in interpret mode, on the same numpy audio.

The bar is the JAX suite's (tests/test_mel_pallas.py): rtol 1e-4, atol 2e-4,
set for f32 sums taken in another order. The padded bases are the same
constants, so they must be equal bit for bit. The CUDA kernel itself runs
only on the card (the ``cuda``-marked test, and chip_smoke.py); here a numpy
model of its FFT factorization runs on the very tables the wrapper hands it,
and ``k3_plan`` (its tiles and load routes) is checked at the shapes served.
Speech-like input (a harmonic series with 60 dB of roll-off over an -80 dB
noise floor) keeps quiet mel bins above the log-mel's floor, where white
noise does not: a TF32 DFT passes on noise and fails on it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisperlivekit_tpu.ops import mel_pallas as JMP
from whisperlivekit_tpu_torch.audio.mel import N_SAMPLES, _dft_kernel, mel_filterbank
from whisperlivekit_tpu_torch.harness.signals import speech_like
from whisperlivekit_tpu_torch.ops import mel_pallas as TMP

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6


def _noise(B, n, seed):
    return (0.2 * np.random.default_rng(seed).standard_normal((B, n))).astype(np.float32)


def _speech(B, n, seed):
    """Speech-like lanes; the second is silent past a third of its length."""
    audio = np.stack([speech_like(n, seed + i, f0=130.0 + 20 * i) for i in range(B)])
    if B >= 2:
        audio[1, n // 3:] = 0
    return audio


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
def test_plain_matches_jax_kernel_on_speech(n_mels):
    audio = _speech(2, 3 * 16000 + 77, seed=n_mels)
    want = np.asarray(JMP.log_mel_pallas(jnp.asarray(audio), n_mels=n_mels, interpret=True))
    got = TMP.log_mel_pallas_plain(torch.from_numpy(audio), n_mels).numpy()
    assert got.shape == want.shape == (2, n_mels, audio.shape[1] // 160)
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


# --- a numpy model of csrc/log_mel.cu's arithmetic, on the wrapper's tables ---

F32 = np.float32


def _radix4(a, b, c, d):
    t0, t1 = (a[0] + c[0], a[1] + c[1]), (a[0] - c[0], a[1] - c[1])
    t2, t3 = (b[0] + d[0], b[1] + d[1]), (b[0] - d[0], b[1] - d[1])
    return [(t0[0] + t2[0], t0[1] + t2[1]), (t1[0] + t3[1], t1[1] - t3[0]),
            (t0[0] - t2[0], t0[1] - t2[1]), (t1[0] - t3[1], t1[1] + t3[0])]


def _radix5(x, c1, s1, c2, s2):
    (x0r, x0i), (x1r, x1i), (x2r, x2i), (x3r, x3i), (x4r, x4i) = x
    t1r, t1i, t2r, t2i = x1r + x4r, x1i + x4i, x2r + x3r, x2i + x3i
    t3r, t3i, t4r, t4i = x1r - x4r, x1i - x4i, x2r - x3r, x2i - x3i
    a1r, a1i = x0r + c1 * t1r + c2 * t2r, x0i + c1 * t1i + c2 * t2i
    a2r, a2i = x0r + c2 * t1r + c1 * t2r, x0i + c2 * t1i + c1 * t2i
    b1r, b1i = s1 * t3r + s2 * t4r, s1 * t3i + s2 * t4i
    b2r, b2i = s2 * t3r - s1 * t4r, s2 * t3i - s1 * t4i
    return [(x0r + t1r + t2r, x0i + t1i + t2i), (a1r + b1i, a1i - b1r), (a2r + b2i, a2i - b2r),
            (a2r - b2i, a2i + b2r), (a1r - b1i, a1i + b1r)]


def _cmul(z, w):
    return z[0] * w[0] - z[1] * w[1], z[0] * w[1] + z[1] * w[0]


def _dft20(x, r5):
    """The kernel's 20-point DFT, prime-factor 4 x 5: radix-4 over n1 of
    x[(5 n1 + 4 n2) mod 20], radix-5 over n2, out to y[(5 k1 + 16 k2) mod 20]."""
    a = [_radix4(*(x[(5 * n1 + 4 * n2) % 20] for n1 in range(4))) for n2 in range(5)]
    y = [None] * 20
    for k1 in range(4):
        for k2, v in enumerate(_radix5([a[n2][k1] for n2 in range(5)], *r5)):
            y[(5 * k1 + 16 * k2) % 20] = v
    return y


def _model_frames(row: np.ndarray, T: int) -> np.ndarray:
    """[T, 400] f32: frame i = samples 160 i - 200 + j, reflected."""
    i = 160 * np.arange(T)[:, None] - 200 + np.arange(400)
    per = 2 * (len(row) - 1)
    i = i % per
    return row[np.where(i < len(row), i, per - i)]


def _model_power(row: np.ndarray) -> np.ndarray:
    """[T, 201] f32 power, as the kernel computes it: frames (2p, 2p + 1) as
    z = x_a + i x_b (windowed; an odd last frame gets a zero partner);
    stage 1 over n1 of z[20 n1 + n2] (each 20-point DFT prime-factor 4 x 5),
    the W400^(n2 k1) twiddles, stage 2 over
    n2 giving Z[k1 + 20 k2]; X_a, X_b = (Z[k] +- conj Z[-k]) / (2 or 2i)."""
    tab = TMP._fft_table()
    win = tab[TMP.TAB_WIN : TMP.TAB_WIN + 400]
    tw = tab[TMP.TAB_TW : TMP.TAB_R5].reshape(20, 20, 2)  # [k1][n2]
    r5 = [F32(v) for v in tab[TMP.TAB_R5 : TMP.TAB_LEN]]
    T = len(row) // 160
    fr = _model_frames(row, T)
    if T % 2:
        fr = np.concatenate([fr, np.zeros((1, 400), F32)])
    P = len(fr) // 2
    zr, zi = (fr[0::2] * win).reshape(P, 20, 20), (fr[1::2] * win).reshape(P, 20, 20)  # [p, n1, n2]
    y = _dft20([(zr[:, n1], zi[:, n1]) for n1 in range(20)], r5)  # [k1] -> [p, n2]
    y = [_cmul(y[k1], (tw[k1, :, 0], tw[k1, :, 1])) for k1 in range(20)]
    er, ei = np.stack([v[0] for v in y], 1), np.stack([v[1] for v in y], 1)  # [p, k1, n2]
    x = _dft20([(er[:, :, n2], ei[:, :, n2]) for n2 in range(20)], r5)  # [k2] -> [p, k1]
    Zr, Zi = (np.stack([v[c] for v in x], 1).reshape(P, 400) for c in (0, 1))  # k = 20 k2 + k1
    k = np.arange(201)
    zr, zi, wr, wi = Zr[:, k], Zi[:, k], Zr[:, (400 - k) % 400], Zi[:, (400 - k) % 400]
    h = F32(0.5)
    ar, ai, br, bi = h * (zr + wr), h * (zi - wi), h * (zi + wi), h * (wr - zr)
    power = np.empty((2 * P, 201), F32)
    power[0::2], power[1::2] = ar * ar + ai * ai, br * br + bi * bi
    return power[:T]


def _model_log10_mel(power: np.ndarray, n_mels: int) -> np.ndarray:
    """[n_mels, T]: each filter over its nonzero bins, from the compacted
    weights, then log10 of the 1e-10 clamp."""
    w, idx = TMP._mel_compact(n_mels)
    mel = np.zeros((n_mels, power.shape[0]), F32)
    for m, (lo, hi, off, _) in enumerate(idx):
        for k in range(lo, hi):
            mel[m] += power[:, k] * w[off + k - lo]
    return np.log10(np.maximum(mel, F32(1e-10)))


@pytest.mark.parametrize("n_mels,n", [
    (80, 32000),          # 200 frames: every frame has a partner
    (80, 16160 + 77),     # 101 frames: the last pairs with a zero frame
    (128, 32000),
    (128, 16160 + 77),
])
def test_fft_model_matches_dft_and_plain(n_mels, n):
    """The kernel's factorization, run in f32 on exactly the wrapper's
    tables, gives the power of the window-fused DFT basis (_dft_kernel,
    products in float64) to 1e-5 of each frame's largest bin wherever the
    two frames packed together are within 40 dB of each other, and to 1e-5
    of the louder frame's largest bin everywhere (they share one complex
    FFT, so a frame 65 dB under its partner, where the second lane falls
    silent, carries its partner's rounding); and the plain log-mel within
    the JAX suite's bar, on speech-like lanes."""
    audio = _speech(2, n, seed=n_mels + n)
    basis = _dft_kernel()[:, 0, :].astype(np.float64)  # [402, 400]
    logs = []
    for row in audio:
        power = _model_power(row)
        spec = _model_frames(row, len(row) // 160).astype(np.float64) @ basis.T
        want = spec[:, :201] ** 2 + spec[:, 201:] ** 2
        assert power.dtype == np.float32 and power.shape == want.shape
        err = np.abs(power - want)
        peak = want.max(1)
        partner = np.append(peak, 0)[np.arange(len(peak)) ^ 1]
        assert (err <= 1e-5 * np.maximum(peak, partner)[:, None]).all()
        close = partner <= 1e4 * peak  # the partner at most 40 dB louder
        assert close.sum() > len(peak) // 4
        assert (err[close] <= 1e-5 * peak[close, None]).all()
        logs.append(_model_log10_mel(power, n_mels))
    got = TMP._floor_and_scale(torch.from_numpy(np.stack(logs))).numpy()
    want = TMP.log_mel_pallas_plain(torch.from_numpy(audio), n_mels).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4)


def _tf32(a: np.ndarray) -> np.ndarray:
    """Round f32 to TF32 (10 mantissa bits), to nearest."""
    bits = np.ascontiguousarray(a, F32).view(np.uint32)
    return ((bits + 0x1000) & 0xFFFFE000).view(F32)


def _over_bar(method: str, row: np.ndarray, n_mels: int = 80) -> int:
    """How many outputs of ``method``'s log-mel miss the plain version by
    more than the bar. Each method gives every frame's power, then the same
    filterbank product, log10, floor and scaling in float64: ``tf32`` the DFT
    by product with both operands rounded to TF32, as a tensor-core product
    takes them; ``3xtf32`` the same product split into big and small TF32
    parts, three products summed; ``rfft_f32`` numpy's single-precision real
    FFT of the windowed frames."""
    fr = _model_frames(row, len(row) // 160)
    f64 = lambda a: a.astype(np.float64)  # noqa: E731
    if method == "rfft_f32":
        z = np.fft.rfft(fr * TMP._fft_table()[TMP.TAB_WIN : TMP.TAB_WIN + 400], axis=-1)
        assert z.dtype == np.complex64
        power = np.abs(z.astype(np.complex128)) ** 2
    else:
        basis = _dft_kernel()[:, 0, :]  # [402, 400] f32, the window folded in
        fb, bb = _tf32(fr), _tf32(basis)
        spec = f64(fb) @ f64(bb).T
        if method == "3xtf32":
            spec += f64(fb) @ f64(_tf32(basis - bb)).T + f64(_tf32(fr - fb)) @ f64(bb).T
        power = spec[:, :201] ** 2 + spec[:, 201:] ** 2
    mel = power @ f64(mel_filterbank(n_mels).T)
    got = TMP._floor_and_scale(torch.from_numpy(np.log10(np.maximum(mel, 1e-10)).T[None])).float().numpy()
    want = TMP.log_mel_pallas_plain(torch.from_numpy(row[None]), n_mels).numpy()
    return int((np.abs(got - want) > 2e-4 + 1e-4 * np.abs(want)).sum())


_LANES_4S = {  # one 4 s lane each
    "speech": lambda: speech_like(4 * 16000, seed=1),
    "noise": lambda: (0.2 * np.random.default_rng(0).standard_normal(4 * 16000)).astype(F32),
}


def test_tf32_dft_fails_the_bar_on_speech_not_on_noise():
    """Why K3 stays off the tensor cores: with TF32 operands, the DFT by
    product misses the bar on over 5 % of a speech-like lane's 32,000
    outputs (quiet bins inside the 80 dB floor), and white noise, whose
    bins all sit near its peak, shows a tenth as many at most."""
    speech, noise = (_over_bar("tf32", _LANES_4S[s]()) for s in ("speech", "noise"))
    assert speech > 1600 and noise < speech / 10, (speech, noise)


@pytest.mark.parametrize("signal", ["speech", "noise"])
@pytest.mark.parametrize("method", ["3xtf32", "rfft_f32"])
def test_f32_accurate_power_meets_the_bar(method, signal):
    """3xTF32 and an f32 real FFT put no output over the bar."""
    assert _over_bar(method, _LANES_4S[signal]()) == 0


def test_fft_table_is_float64_rounded_once():
    tab = TMP._fft_table()
    n = np.arange(400)
    assert tab.dtype == np.float32 and tab.shape == (TMP.TAB_LEN,)
    np.testing.assert_array_equal(tab[:400], (0.5 * (1 - np.cos(2 * np.pi * n / 400))).astype(np.float32))
    tw = tab[TMP.TAB_TW : TMP.TAB_R5].reshape(20, 20, 2)
    np.testing.assert_array_equal(tw[3, 7], np.float32([np.cos(2 * np.pi * 21 / 400), -np.sin(2 * np.pi * 21 / 400)]))
    np.testing.assert_array_equal(tab[TMP.TAB_R5 : TMP.TAB_LEN], np.float32(
        [np.cos(2 * np.pi / 5), np.sin(2 * np.pi / 5), np.cos(4 * np.pi / 5), np.sin(4 * np.pi / 5)]))


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_compact_holds_the_filterbank(n_mels):
    """The compacted weights rebuild the dense filterbank exactly."""
    w, idx = TMP._mel_compact(n_mels)
    dense = np.zeros((n_mels, 201), np.float32)
    for m, (lo, hi, off, _) in enumerate(idx):
        dense[m, lo:hi] = w[off : off + hi - lo]
    np.testing.assert_array_equal(dense, mel_filterbank(n_mels))
    assert w.size <= 512 and idx.dtype == np.int32  # csrc/log_mel.cu W_MAX


@pytest.mark.parametrize("N", [160, 32077, 480000])
@pytest.mark.parametrize("B", range(1, 9))
def test_k3_plan_covers_every_frame_once(B, N):
    """Tiles cover frames [0, T) once; the bulk tiles are whole, inside the
    lane and 16-byte aligned, and every other tile is an edge (reflected or
    partial) or the lane is unaligned; one 30 s lane fills the 132 SMs."""
    plan = TMP.k3_plan(B, N, 80)
    T = N // 160
    assert plan.grid == (plan.tiles, B)
    assert plan.frames == TMP.K3_FRAMES
    seen = np.zeros(T, int)
    for t in range(plan.tiles):
        seen[t * plan.frames : (t + 1) * plan.frames] += 1
    assert (seen == 1).all() and plan.tiles * plan.frames < T + plan.frames
    lo, hi = plan.bulk_tiles
    assert plan.route == ("bulk" if hi > lo else "gather")
    assert plan.route == "gather" if N % 4 else N < 3200 or plan.route == "bulk"
    for t in range(plan.tiles):
        first = t * plan.frames * 160 - 200
        last = first + (plan.frames - 1) * 160 + 400
        whole_inside = first >= 0 and last <= N and (t + 1) * plan.frames <= T
        assert (lo <= t < hi) == (whole_inside and N % 4 == 0)
        if lo <= t < hi:
            assert (4 * first) % 16 == 0 and (4 * (last - first)) % 16 == 0
    if N == 480000:
        assert plan.tiles * B >= 132  # the H100's SMs


def test_k3_plan_takes_unaligned_rows_by_gather():
    assert TMP.k3_plan(2, 480000, 80, ptr=0x1000).route == "bulk"
    assert TMP.k3_plan(2, 480000, 80, ptr=0x1004).route == "gather"
    with pytest.raises(ValueError):
        TMP.k3_plan(1, 159, 80)
    with pytest.raises(ValueError):
        TMP.k3_plan(1, 480000, 129)


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
    ragged (unaligned) length, at 1, 3 and 4 lanes: a speech-like lane, a
    silent lane, a speech-like lane silent past 5 s (where the floor clamps)
    and a white-noise lane; and at the full window from a row that is not
    16-byte aligned (the gather route)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain side stays f32
    for n in (N_SAMPLES, 32000 + 77):
        lanes = _speech(4, n, seed=n_mels)
        lanes[1] = 0
        lanes[2] = speech_like(n, seed=n_mels + 9)
        lanes[2, 80000:] = 0
        lanes[3] = _noise(1, n, seed=n_mels)[0]
        for B in (1, 3, 4):
            audio = torch.from_numpy(lanes[:B].copy()).cuda()
            before = TMP.log_mel_pallas.launches
            got = TMP.log_mel_pallas(audio, n_mels)
            want = TMP.log_mel_pallas_plain(audio, n_mels)
            torch.cuda.synchronize()
            assert TMP.log_mel_pallas.launches == before + 1
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=2e-4)
    flat = torch.zeros(2 * N_SAMPLES + 1, device="cuda")
    audio = flat[1:].view(2, N_SAMPLES)  # contiguous, 4 bytes past an aligned address
    audio.copy_(torch.from_numpy(_speech(2, N_SAMPLES, seed=5)))
    assert TMP.k3_plan(2, N_SAMPLES, n_mels, audio.data_ptr()).route == "gather"
    before = dict(TMP.log_mel_pallas.routes)
    got = TMP.log_mel_pallas(audio, n_mels)
    want = TMP.log_mel_pallas_plain(audio, n_mels)
    torch.cuda.synchronize()
    assert sum(TMP.log_mel_pallas.routes.values()) == sum(before.values()) + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=2e-4)
