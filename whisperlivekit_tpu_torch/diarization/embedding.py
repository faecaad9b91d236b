"""Embedding-based streaming diarization (unsupervised, weight-free).

The working diarization backend while the Sortformer JAX port awaits
converted NeMo weights (SURVEY.md §2.9 names the embedding fallback).
Per ~1 s chunk: log-mel (same front-end as ASR) → MFCC statistics embedding
→ online cosine clustering with exponential centroid updates and a
new-speaker distance threshold. Session contract parity with the reference
backends (insert_audio_chunk / async diarize / insert_silence / close,
reference diarization/sortformer_backend.py:130-336).

(The port's copy of whisperlivekit_tpu/diarization/embedding.py.)
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np

from ..timed import SpeakerSegment

logger = logging.getLogger(__name__)

SR = 16000
CHUNK_S = 1.0
N_MFCC = 20


def _dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    mat = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in)) * np.sqrt(2.0 / n_in)
    mat[0] /= np.sqrt(2.0)
    return mat.astype(np.float32)


class _Shared:
    def __init__(self, distance_threshold: float = 0.45, max_speakers: int = 4):
        self.distance_threshold = distance_threshold
        self.max_speakers = max_speakers

    def new_session(self) -> "EmbeddingDiarization":
        return EmbeddingDiarization(self.distance_threshold, self.max_speakers)


class EmbeddingDiarization:
    def __init__(self, distance_threshold: float = 0.45, max_speakers: int = 4):
        self.buffer = np.zeros(0, np.float32)
        self.buffer_audio = self.buffer  # marks drainable-buffer backend
        self.offset = 0.0
        self.threshold = distance_threshold
        self.max_speakers = max_speakers
        self.centroids: List[np.ndarray] = []
        self.counts: List[int] = []
        self._dct = _dct_matrix(N_MFCC, 80)

    # ---- contract -----------------------------------------------------------

    def insert_audio_chunk(self, audio: np.ndarray) -> None:
        self.buffer = np.concatenate([self.buffer, np.asarray(audio, np.float32)])
        self.buffer_audio = self.buffer

    def insert_silence(self, duration: float) -> None:
        self.offset += duration or 0.0

    async def diarize(self) -> List[SpeakerSegment]:
        n = int(CHUNK_S * SR)
        if len(self.buffer) < n:
            return []
        chunk, self.buffer = self.buffer[:n], self.buffer[n:]
        self.buffer_audio = self.buffer
        start = self.offset
        self.offset += CHUNK_S
        emb = self._embed(chunk)
        if emb is None:
            return []
        speaker = self._assign(emb)
        return [SpeakerSegment(start=start, end=self.offset, speaker=speaker)]

    def close(self) -> None:
        self.buffer = np.zeros(0, np.float32)
        self.buffer_audio = self.buffer

    # ---- embedding ---------------------------------------------------------------

    def _embed(self, chunk: np.ndarray) -> Optional[np.ndarray]:
        if float(np.sqrt(np.mean(chunk**2))) < 1e-4:
            return None
        # frame to 25 ms / 10 ms, mel-like bands via FFT triangle pooling
        from ..audio.mel import mel_filterbank

        frame, hop = 400, 160
        n_frames = (len(chunk) - frame) // hop + 1
        idx = np.arange(frame)[None, :] + hop * np.arange(n_frames)[:, None]
        frames = chunk[idx] * np.hanning(frame)[None, :]
        spec = np.abs(np.fft.rfft(frames, n=frame, axis=1)) ** 2  # [T, 201]
        mel = spec @ mel_filterbank(80).T  # [T, 80]
        logmel = np.log10(np.maximum(mel, 1e-10))
        mfcc = logmel @ self._dct.T  # [T, n_mfcc]
        emb = np.concatenate([mfcc.mean(axis=0), mfcc.std(axis=0)])
        # drop c0 energy terms so loudness doesn't dominate identity
        emb[0] = 0.0
        norm = np.linalg.norm(emb)
        return emb / norm if norm > 0 else None

    def _assign(self, emb: np.ndarray) -> int:
        best, best_d = -1, np.inf
        for i, c in enumerate(self.centroids):
            d = 1.0 - float(np.dot(emb, c))
            if d < best_d:
                best, best_d = i, d
        if best >= 0 and (
            best_d < self.threshold or len(self.centroids) >= self.max_speakers
        ):
            w = min(0.15, 3.0 / (self.counts[best] + 1))
            self.centroids[best] = (1 - w) * self.centroids[best] + w * emb
            n = np.linalg.norm(self.centroids[best])
            if n > 0:
                self.centroids[best] /= n
            self.counts[best] += 1
            return best
        self.centroids.append(emb)
        self.counts.append(1)
        return len(self.centroids) - 1


def load_embedding_diarization(config) -> _Shared:
    return _Shared()
