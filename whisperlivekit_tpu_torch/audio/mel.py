"""Log-mel spectrogram front-end (port of whisperlivekit_tpu/audio/mel.py).

Same formulation as the JAX module: reflect-padded frames gathered with hop
160, one f32 matmul against the window-fused real DFT basis, power with the
trailing frame dropped, Slaney mel filterbank, log10 with a 1e-10 clamp,
max-8 dynamic floor and (x+4)/4 scaling (reference whisper/audio.py:110-157).

The matmuls stay plain f32 ``torch.matmul``: keep
``torch.backends.cuda.matmul.allow_tf32`` False (PyTorch's default) where f32
results are compared. The numpy basis builders are copies of the JAX
module's, which cannot be imported without importing JAX.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE          # 480000 samples in a 30 s window
N_FRAMES = N_SAMPLES // HOP_LENGTH              # 3000 mel frames in a 30 s window

N_SAMPLES_PER_TOKEN = 2 * HOP_LENGTH            # each decoder step attends 20 ms
FRAMES_PER_SECOND = SAMPLE_RATE // HOP_LENGTH   # 100 mel frames / s
TOKENS_PER_SECOND = SAMPLE_RATE // N_SAMPLES_PER_TOKEN  # 50 attention frames / s


@functools.lru_cache(maxsize=None)
def mel_filterbank(n_mels: int = 80, sr: int = SAMPLE_RATE, n_fft: int = N_FFT) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape [n_mels, n_fft//2+1].

    Matches librosa.filters.mel(sr, n_fft, n_mels, htk=False, norm="slaney"),
    which is what the reference's mel_filters.npz contains.
    """
    fmin, fmax = 0.0, sr / 2.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        # Slaney: linear below 1 kHz, log above.
        f_sp = 200.0 / 3
        mels = f / f_sp
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        safe = np.maximum(f, 1e-10)
        return np.where(
            f >= min_log_hz, min_log_mel + np.log(safe / min_log_hz) / logstep, mels
        )

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        f_sp = 200.0 / 3
        freqs = f_sp * m
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)

    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sr / 2, n_bins)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))

    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney area normalization
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft_kernel() -> np.ndarray:
    """Window-fused real DFT basis as conv kernels, shape [2*(n_fft//2+1), 1, n_fft].

    Channel c<201 computes Re(X_c); channel 201+c computes -Im(X_c) (the sign
    is irrelevant since only |X|^2 is consumed).
    """
    n = N_FFT
    n_bins = n // 2 + 1
    # Periodic Hann window: same as torch.hann_window(400, periodic=True).
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))
    k = np.arange(n_bins)[:, None]  # frequency bins
    t = np.arange(n)[None, :]       # time within frame
    angle = 2.0 * np.pi * k * t / n
    cos_b = (np.cos(angle) * window[None, :]).astype(np.float32)
    sin_b = (np.sin(angle) * window[None, :]).astype(np.float32)
    return np.concatenate([cos_b, sin_b], axis=0)[:, None, :]  # [402, 1, 400]


# device copies of the constant bases, one per (kind, n_mels, device)
_DEVICE_CONST: Dict[Tuple[str, int, str], torch.Tensor] = {}


def _const(kind: str, n_mels: int, device: torch.device) -> torch.Tensor:
    key = (kind, n_mels, str(device))
    t = _DEVICE_CONST.get(key)
    if t is None:
        arr = _dft_kernel()[:, 0, :] if kind == "dft" else mel_filterbank(n_mels)
        t = _DEVICE_CONST[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return t


def stft_power(audio: torch.Tensor) -> torch.Tensor:
    """Power spectrogram of 16 kHz float audio, shape [..., n_fft//2+1, n_frames].

    Center-padded (reflect) framing with hop 160, matching torch.stft
    semantics used by the reference; the trailing frame is dropped the same
    way (reference whisper/audio.py:147).
    """
    squeeze = audio.dim() == 1
    if squeeze:
        audio = audio[None]
    pad = N_FFT // 2
    x = torch.nn.functional.pad(audio.float()[:, None, :], (pad, pad), mode="reflect")[:, 0]
    n_frames = (x.shape[1] - N_FFT) // HOP_LENGTH + 1
    frames = x.unfold(1, N_FFT, HOP_LENGTH)[:, :n_frames]  # [B, n_frames, 400]
    kern = _const("dft", 0, x.device)                       # [402, 400]
    out = torch.matmul(frames, kern.t()).transpose(1, 2)     # [B, 402, n_frames]
    n_bins = N_FFT // 2 + 1
    real, imag = out[:, :n_bins], out[:, n_bins:]
    power = (real * real + imag * imag)[..., :-1]  # drop last frame like reference
    return power[0] if squeeze else power


def log_mel_spectrogram(
    audio: torch.Tensor, n_mels: int = 80, padding: int = 0
) -> torch.Tensor:
    """Whisper-scaled log-mel spectrogram, shape [..., n_mels, n_frames].

    ``padding`` appends that many zero samples before framing (the reference
    pads a full 30 s window before encoding, whisper/audio.py:141).
    """
    if padding > 0:
        audio = torch.nn.functional.pad(audio, (0, padding))
    power = stft_power(audio)
    filters = _const("mel", n_mels, power.device)
    mel = torch.matmul(filters, power)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    # Dynamic floor: 8 dB below the global max of each item.
    floor = log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0
    log_spec = torch.maximum(log_spec, floor)
    return (log_spec + 4.0) / 4.0


def pad_or_trim(array: torch.Tensor, length: int = N_SAMPLES, axis: int = -1) -> torch.Tensor:
    """Pad with zeros or trim along ``axis`` to exactly ``length``."""
    size = array.shape[axis]
    if size > length:
        return array.narrow(axis, 0, length)
    if size < length:
        axis = axis % array.dim()
        widths = [0, 0] * (array.dim() - 1 - axis) + [0, length - size]
        return torch.nn.functional.pad(array, widths)
    return array
