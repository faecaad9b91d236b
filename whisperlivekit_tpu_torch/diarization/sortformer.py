"""Streaming Sortformer diarization backend, session side (port of
whisperlivekit_tpu/diarization/sortformer.py).

Duck-typed contract of reference diarization/sortformer_backend.py:130-336:
``insert_audio_chunk``, ``async diarize() -> List[SpeakerSegment]``,
``insert_silence``, ``close``; ``buffer_audio`` marks the drain-until-dry
protocol. Each ~1 s chunk: NeMo-style 128-band log-mel (+99-frame left
context from the previous chunk) → one ``streaming_step`` on the model's
device → frame-wise argmax runs → SpeakerSegments on the audio-sample clock.

``diarize`` is ``async`` but computes synchronously, on the event loop's
thread, as in the JAX package. Weights load from a local ``.nemo``/``.ckpt``
(converted without a NeMo install — sortformer_model.read_nemo_state_dict)
or random dev weights for CI (``random:``).
"""

from __future__ import annotations

import functools
import logging
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..timed import SpeakerSegment
from . import sortformer_model as S

logger = logging.getLogger(__name__)

SAMPLE_RATE = 16000
HOP = 160           # 10 ms mel hop (NeMo window_stride 0.01)
N_FFT = 512
WIN = 400           # 25 ms window
PREEMPH = 0.97
LOG_GUARD = 2.0**-24


@functools.lru_cache(maxsize=None)
def _nemo_dft_kernel() -> np.ndarray:
    """Hann(400)-windowed real-DFT basis zero-padded to n_fft=512, [2*257,
    1, 512] (cos rows, then sin rows; the JAX package's conv kernels)."""
    window = np.hanning(WIN + 1)[:-1]
    k = np.arange(N_FFT // 2 + 1)[:, None]
    t = np.arange(N_FFT)[None, :]
    # window occupies the center of the n_fft frame (torch.stft semantics)
    w_full = np.zeros(N_FFT)
    off = (N_FFT - WIN) // 2
    w_full[off : off + WIN] = window
    angle = 2.0 * np.pi * k * t / N_FFT
    cos_b = (np.cos(angle) * w_full[None, :]).astype(np.float32)
    sin_b = (np.sin(angle) * w_full[None, :]).astype(np.float32)
    return np.concatenate([cos_b, sin_b], axis=0)[:, None, :]


@functools.lru_cache(maxsize=None)
def _tables(n_mels: int, device: torch.device):
    """(DFT basis [512, 514], mel filters [257, n_mels]) on ``device``."""
    from ..audio.mel import mel_filterbank

    basis = torch.from_numpy(_nemo_dft_kernel()[:, 0, :].T.copy()).to(device)
    filters = torch.from_numpy(mel_filterbank(n_mels, n_fft=N_FFT).T.copy()).to(device)
    return basis, filters


def nemo_log_mel(audio: torch.Tensor, n_mels: int = 128) -> torch.Tensor:
    """float audio [B, T] → log-mel [B, frames, n_mels], NeMo preprocessor
    semantics (preemphasis, 25 ms Hann / 10 ms hop / 512-fft power, Slaney
    mel, log(x + 2^-24), no normalization — reference passes normalize="NA").

    The STFT is the JAX package's strided conv written as frames times the
    DFT basis: two f32 matmuls (the DFT and the mel filters) under PyTorch's
    matmul default, full f32 on CUDA unless TF32 is enabled for matmuls."""
    x = audio.float()
    x = torch.cat([x[:, :1], x[:, 1:] - PREEMPH * x[:, :-1]], dim=1)
    pad = N_FFT // 2
    x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP)                      # [B, frames, 512]
    basis, filters = _tables(n_mels, x.device)
    out = torch.matmul(frames, basis)                      # [B, frames, 2*257]
    n_bins = N_FFT // 2 + 1
    power = out[..., :n_bins] ** 2 + out[..., n_bins:] ** 2
    mel = torch.matmul(power, filters)                     # [B, frames, mels]
    return torch.log(mel + LOG_GUARD)


class SortformerDiarization:
    """Shared model holder (one per engine; sessions share the weights)."""

    def __init__(self, params, dims: S.SortformerDims):
        self.params = params  # a sortformer_model.Sortformer on its device
        self.dims = dims

    def new_session(self) -> "SortformerDiarizationOnline":
        return SortformerDiarizationOnline(self)


class SortformerDiarizationOnline:
    """Per-session streaming diarizer."""

    def __init__(self, shared: SortformerDiarization, sample_rate: int = SAMPLE_RATE):
        self.shared = shared
        self.dims = shared.dims
        self.sample_rate = sample_rate
        self.buffer_audio = np.zeros(0, np.float32)  # presence => drain protocol
        self.device = shared.params.device
        self.state = S.init_state(self.dims, 1, device=self.device)
        self.global_time_offset = 0.0
        self.chunk_index = 0
        self._prev_mel: Optional[torch.Tensor] = None
        self.chunk_samples = self.dims.chunk_mel_frames * HOP
        self.chunk_duration = self.chunk_samples / sample_rate

    def insert_audio_chunk(self, pcm: np.ndarray) -> None:
        self.buffer_audio = np.concatenate([self.buffer_audio, np.asarray(pcm, np.float32)])

    def insert_silence(self, duration: Optional[float]) -> None:
        if duration:
            self.global_time_offset += duration

    async def diarize(self) -> List[SpeakerSegment]:
        if len(self.buffer_audio) < self.chunk_samples:
            return []
        audio = self.buffer_audio[: self.chunk_samples]
        self.buffer_audio = self.buffer_audio[self.chunk_samples :]

        # the mel and the left-context concat stay on the device
        mel = nemo_log_mel(torch.from_numpy(audio[None]).to(self.device), self.dims.n_mels)
        mel = mel[:, : self.dims.chunk_mel_frames]
        ctx = self.dims.left_ctx_mel_frames
        if self._prev_mel is not None:
            feats = torch.cat([self._prev_mel[:, -ctx:], mel], dim=1)
        else:
            # first chunk: zero left context keeps the shape the same
            feats = torch.cat([torch.zeros_like(mel[:, :ctx]), mel], dim=1)
        self._prev_mel = mel

        probs, self.state = S.streaming_step(
            self.shared.params, self.state, feats, self.dims, ctx_frames=ctx,
        )
        segments = self._runs_to_segments(probs[0].cpu().numpy())
        self.chunk_index += 1
        return segments

    def _runs_to_segments(self, probs: np.ndarray) -> List[SpeakerSegment]:
        """Frame-wise argmax → same-speaker runs on the audio clock
        (reference _process_predictions, sortformer_backend.py:281-318)."""
        speakers = np.argmax(probs, axis=-1)
        n = len(speakers)
        if n == 0:
            return []
        frame_dur = self.chunk_duration / n
        base = self.chunk_index * self.chunk_duration + self.global_time_offset
        out: List[SpeakerSegment] = []
        run_start = 0
        for i in range(1, n + 1):
            if i == n or speakers[i] != speakers[run_start]:
                out.append(
                    SpeakerSegment(
                        speaker=int(speakers[run_start]),
                        start=round(base + run_start * frame_dur, 2),
                        end=round(base + i * frame_dur, 2),
                    )
                )
                run_start = i
        return out

    def close(self) -> None:
        self.buffer_audio = np.zeros(0, np.float32)


def load_sortformer(config, device=None) -> SortformerDiarization:
    """Resolve weights: a local ``.nemo``/``.ckpt`` (NVIDIA
    diar_streaming_sortformer_4spk-v2 — `wlk pull sortformer` downloads it
    on networked hosts), or ``random:`` (DEV_TINY dims, seed 0) for CI; in
    f32 on ``device`` (None: the card, which raises without CUDA). Missing
    weights raise ``FileNotFoundError`` before any device is touched."""
    import glob
    import os

    from ..engine.core import default_device

    path = getattr(config, "sortformer_model_path", None)
    if path and str(path).startswith("random:"):
        dims = S.DEV_TINY
        device = torch.device(device) if device is not None else default_device()
        params = S.init_params(dims, seed=0, device=device)
        logger.warning("Sortformer running RANDOM dev weights (%s)", path)
        return SortformerDiarization(params, dims)
    if path and os.path.isdir(path):
        nemos = sorted(glob.glob(os.path.join(path, "*.nemo")))
        if not nemos:
            raise FileNotFoundError(f"no .nemo file in {path}")
        path = nemos[0]
    if path and os.path.isfile(path):
        device = torch.device(device) if device is not None else default_device()
        sd = S.read_nemo_state_dict(path)
        params, dims = S.convert_nemo_state_dict(sd, device=device)
        logger.info(
            "Loaded Sortformer %s (%d-layer conformer d=%d, %d-layer head d=%d) on %s",
            path, dims.encoder_layers, dims.d_encoder, dims.head_layers, dims.d_model, device,
        )
        return SortformerDiarization(params, dims)
    raise FileNotFoundError(
        "Sortformer weights not found: pass --sortformer-model-path "
        "pointing at diar_streaming_sortformer_4spk-v2.nemo "
        "(`wlk pull sortformer` downloads it on networked hosts)"
    )
