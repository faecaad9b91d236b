"""Fused log-mel front end (kernel K3).

Counterpart of ``whisperlivekit_tpu/ops/mel_pallas.py``. Audio ``[B, N]``
f32 becomes the whisper-scaled log-mel ``[B, n_mels, N // 160]``:

    frames[i, j] = audio[160 i + j - 200]   (reflect-padded, 400 taps)
    power        = (frames @ cos)^2 + (frames @ sin)^2      (201 bins)
    log_spec     = log10(max(power @ filters, 1e-10))
    out          = (max(log_spec, max(log_spec) - 8) + 4) / 4

``log_mel_pallas`` launches the kernel ``csrc/log_mel.cu`` (CUDA C++ for
sm_90a, bound through ctypes) for CUDA tensors and raises ``KernelError`` on
a failed build or launch; for CPU tensors it takes ``log_mel_pallas_plain``,
the plain PyTorch version of the TPU kernel's formulation (three shifted
160-sample row views against the zero-padded cos|sin basis). The kernel
writes log10 of the mel power in the encoder's ``[B, n_mels, T]`` layout;
the dynamic floor needs a maximum over a whole lane, so it and the scaling
stay plain torch ops after the kernel, as the JAX package keeps them outside
its Pallas kernel.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import numpy as np
import torch

from ..audio.mel import HOP_LENGTH, N_FFT, _dft_kernel, mel_filterbank
from .cuda_build import KernelError, load

TAPS_PAD = 512
BINS = N_FFT // 2 + 1    # 201
BINS_PAD = 256
MELS_PAD = 128


@functools.lru_cache(maxsize=None)
def _padded_bases(n_mels: int):
    """(dft [3, 160, 512], mel [256, 128]) zero-padded bases, the JAX
    module's constants: the 400-tap window splits into three 160-tap groups
    (q = j // 160); dft columns 0..255 are the cos bins, 256..511 the sin
    bins."""
    kern = _dft_kernel()[:, 0, :]  # [402, 400]
    cos_b, sin_b = kern[:BINS].T, kern[BINS:].T  # [400, 201]
    full = np.zeros((3 * HOP_LENGTH, 2 * BINS_PAD), np.float32)
    full[:N_FFT, :BINS] = cos_b
    full[:N_FFT, BINS_PAD : BINS_PAD + BINS] = sin_b
    dft = full.reshape(3, HOP_LENGTH, 2 * BINS_PAD)
    mel = np.zeros((BINS_PAD, MELS_PAD), np.float32)
    mel[:BINS, :n_mels] = mel_filterbank(n_mels).T
    return dft, mel


@functools.lru_cache(maxsize=None)
def _mel_ranges(n_mels: int) -> np.ndarray:
    """[n_mels, 2] int32: the [first, last + 1) bins where each triangular
    filter is nonzero (an empty filter gives [0, 0)). The kernel sums only
    these bins; the terms it skips are exact zeros."""
    nz = mel_filterbank(n_mels) != 0  # [n_mels, 201]
    out = np.zeros((n_mels, 2), np.int32)
    for m in range(n_mels):
        idx = np.flatnonzero(nz[m])
        if idx.size:
            out[m] = (idx[0], idx[-1] + 1)
    return out


def _reflect_index(n_total: int, n: int, device) -> torch.Tensor:
    """Sample index of padded positions [-200, n_total - 200) under
    repeated reflection (numpy's ``mode="reflect"``, period 2(n-1))."""
    i = torch.arange(n_total, device=device) - N_FFT // 2
    if n == 1:
        return torch.zeros_like(i)
    per = 2 * (n - 1)
    i = i % per
    return torch.where(i < n, i, per - i)


def _floor_and_scale(log_spec: torch.Tensor) -> torch.Tensor:
    """Whisper's dynamic floor (8 below each lane's max) and (x + 4) / 4."""
    floor = log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0
    return (torch.maximum(log_spec, floor) + 4.0) / 4.0


@functools.lru_cache(maxsize=None)
def _tables(n_mels: int, device: torch.device):
    """Device copies of the kernel's constant tables: (dft [480, 512],
    mel [256, 128], bin ranges [n_mels, 2])."""
    dft, mel_f = _padded_bases(n_mels)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (dft.reshape(3 * HOP_LENGTH, TAPS_PAD), mel_f, _mel_ranges(n_mels))
    )


def _log10_mel_plain(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """log10(max(mel power, 1e-10)) [B, n_mels, N // 160], as the TPU kernel
    computes it: frames from three shifted 160-sample row views against the
    padded basis, power, the padded filterbank."""
    B, N = audio.shape
    T = N // HOP_LENGTH
    rows = T + 2  # frame i reads rows i, i + 1, i + 2
    x = audio.float()[:, _reflect_index(rows * HOP_LENGTH, N, audio.device)]
    x2 = x.reshape(B, rows, HOP_LENGTH)
    dft, mel_f, _ = _tables(n_mels, audio.device)  # dft [3 * 160, 512]
    spect = sum(  # [B, T, 512]
        torch.matmul(x2[:, q : q + T], dft[q * HOP_LENGTH : (q + 1) * HOP_LENGTH]) for q in range(3)
    )
    real, imag = spect[..., :BINS_PAD], spect[..., BINS_PAD:]
    power = real * real + imag * imag
    mel = torch.matmul(power, mel_f)  # [B, T, 128]
    return torch.log10(torch.clamp(mel, min=1e-10))[..., :n_mels].transpose(1, 2)


def log_mel_pallas_plain(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """audio [B, N] (or [N]) f32 -> whisper-scaled log-mel [B, n_mels, N // 160]."""
    if audio.dim() == 1:
        return log_mel_pallas_plain(audio[None], n_mels)[0]
    return _floor_and_scale(_log10_mel_plain(audio, n_mels))


def _lib():
    lib = load("log_mel")
    if not getattr(lib, "_wlk_bound", False):
        lib.wlk_log_mel.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.wlk_log_mel.restype = ctypes.c_int
        lib.wlk_log_mel_error_string.argtypes = [ctypes.c_int]
        lib.wlk_log_mel_error_string.restype = ctypes.c_char_p
        lib._wlk_bound = True
    return lib


def _log10_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """The kernel launch: CUDA audio [B, N] f32 -> log10 mel [B, n_mels, N // 160]."""
    if audio.dim() != 2 or audio.dtype != torch.float32:
        raise TypeError(f"audio must be [B, N] float32, got {tuple(audio.shape)} {audio.dtype}")
    if n_mels < 1 or n_mels > MELS_PAD:
        raise ValueError(f"n_mels={n_mels} outside [1, {MELS_PAD}]")
    B, N = audio.shape
    if N < HOP_LENGTH:
        raise ValueError(f"{N} samples make no frame (hop {HOP_LENGTH})")
    audio = audio.contiguous()
    dft, mel_f, ranges = _tables(n_mels, audio.device)
    out = torch.empty((B, n_mels, N // HOP_LENGTH), dtype=torch.float32, device=audio.device)
    lib = _lib()
    rc = lib.wlk_log_mel(
        audio.data_ptr(), dft.data_ptr(), mel_f.data_ptr(), ranges.data_ptr(),
        out.data_ptr(), B, N, n_mels, torch.cuda.current_stream(audio.device).cuda_stream,
    )
    if rc != 0:
        why = "unsupported arguments" if rc < 0 else lib.wlk_log_mel_error_string(rc).decode()
        raise KernelError(f"log_mel launch failed ({rc}): {why}")
    log_mel_pallas.launches += 1
    log_mel_pallas.shapes[(B, N, n_mels)] += 1
    return out


def log_mel_pallas(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """audio [B, N] (or [N]) f32 -> whisper-scaled log-mel [B, n_mels, N // 160].

    CUDA tensors launch the hand-written kernel (or raise); CPU tensors take
    the plain version. ``log_mel_pallas.launches`` counts kernel launches and
    ``log_mel_pallas.shapes`` counts them per (B, N, n_mels)."""
    if audio.dim() == 1:
        return log_mel_pallas(audio[None], n_mels)[0]
    if not audio.is_cuda:
        return log_mel_pallas_plain(audio, n_mels)
    return _floor_and_scale(_log10_mel(audio, n_mels))


log_mel_pallas.launches = 0
log_mel_pallas.shapes = Counter()
