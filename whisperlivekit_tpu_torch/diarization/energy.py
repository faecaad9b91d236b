"""Energy/spectral-change diarization — dependency-free baseline backend.

Contract parity with the reference diarization backends
(reference diarization/sortformer_backend.py:130-336): per-session object
with ``insert_audio_chunk(np.ndarray)``, ``async diarize() ->
List[SpeakerSegment]``, ``insert_silence(duration)``, ``close()``.

Heuristic: mel-band energy profiles are clustered online — a new chunk whose
profile is far (cosine) from every known speaker centroid opens a new
speaker. This is a placeholder for quality (the Sortformer port replaces
it) but exercises the full multi-speaker pipeline, attribution and wire
format end-to-end.

(The port's copy of whisperlivekit_tpu/diarization/energy.py; one change:
``load_diarization_model`` falls back from Sortformer to the embedding
backend only when the weights are absent, ``FileNotFoundError``. Any other
failure, a CUDA error or a checkpoint that does not convert, raises.)
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np

from ..timed import SpeakerSegment

logger = logging.getLogger(__name__)

SR = 16000
CHUNK_S = 1.0


class _SharedEnergyDiarization:
    def new_session(self) -> "EnergyDiarization":
        return EnergyDiarization()


class EnergyDiarization:
    def __init__(self, distance_threshold: float = 0.35, max_speakers: int = 4):
        self.buffer = np.zeros(0, np.float32)
        self.buffer_audio = self.buffer  # signals drainable-buffer backend
        self.offset = 0.0  # stream seconds consumed so far
        self.centroids: List[np.ndarray] = []
        self.threshold = distance_threshold
        self.max_speakers = max_speakers

    def insert_audio_chunk(self, audio: np.ndarray) -> None:
        self.buffer = np.concatenate([self.buffer, np.asarray(audio, np.float32)])
        self.buffer_audio = self.buffer

    def insert_silence(self, duration: float) -> None:
        self.offset += duration or 0.0

    def _profile(self, chunk: np.ndarray) -> Optional[np.ndarray]:
        if float(np.sqrt(np.mean(chunk**2))) < 1e-4:
            return None
        spec = np.abs(np.fft.rfft(chunk * np.hanning(len(chunk))))
        bands = np.array_split(spec, 16)
        prof = np.array([float(np.sum(b**2)) for b in bands])
        norm = np.linalg.norm(prof)
        return prof / norm if norm > 0 else None

    def _assign(self, prof: np.ndarray) -> int:
        best, best_d = -1, 1e9
        for i, c in enumerate(self.centroids):
            d = 1.0 - float(np.dot(prof, c))
            if d < best_d:
                best, best_d = i, d
        if best >= 0 and (best_d < self.threshold or len(self.centroids) >= self.max_speakers):
            self.centroids[best] = 0.9 * self.centroids[best] + 0.1 * prof
            n = np.linalg.norm(self.centroids[best])
            if n > 0:
                self.centroids[best] /= n
            return best
        self.centroids.append(prof)
        return len(self.centroids) - 1

    async def diarize(self) -> List[SpeakerSegment]:
        n = int(CHUNK_S * SR)
        if len(self.buffer) < n:
            return []
        chunk, self.buffer = self.buffer[:n], self.buffer[n:]
        self.buffer_audio = self.buffer
        start = self.offset
        self.offset += CHUNK_S
        prof = self._profile(chunk)
        if prof is None:
            return []
        speaker = self._assign(prof)
        return [SpeakerSegment(start=start, end=self.offset, speaker=speaker)]

    def close(self) -> None:
        self.buffer = np.zeros(0, np.float32)


def load_diarization_model(config, device=None):
    """The engine's shared diarization model. ``device`` places Sortformer
    (None: the card, which raises without CUDA)."""
    backend = getattr(config, "diarization_backend", "sortformer")
    if backend == "diart":
        from .diart import DiartDiarization

        return DiartDiarization(config)
    if backend == "sortformer":
        from .sortformer import load_sortformer

        try:
            return load_sortformer(config, device=device)
        except FileNotFoundError as e:
            logger.warning(
                "Sortformer unavailable (%s); using embedding diarization", e
            )
            backend = "embedding"
    if backend == "embedding":
        from .embedding import load_embedding_diarization

        return load_embedding_diarization(config)
    return _SharedEnergyDiarization()
