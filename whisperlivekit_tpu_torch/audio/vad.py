"""Voice-activity detection: streaming iterator + pluggable frame models.

The event contract matches the reference exactly (reference
silero_vad_iterator.py:288-317): feeding arbitrary-length float32 PCM yields
an ordered list of single-frame events ``{"start": sample}`` /
``{"end": sample}`` with the Silero hysteresis (0.5 up, 0.35 down, 100 ms
min-silence, 30 ms pad, 512-sample ticks).

Frame models:
- :class:`SileroJITVAD` — the original Silero v6 weights via torch.jit
  (host CPU; 32 ms ticks are IO-scale work, not TPU work). Weights are
  discovered, not vendored.
- :class:`EnergyVAD` — dependency-free adaptive-noise-floor fallback so the
  pipeline works with zero model assets.

A batched JAX Silero port (one device step for all sessions) is the planned
scheduler upgrade; the iterator API already isolates the model behind
``model(frame) -> prob``.

(The port's copy of whisperlivekit_tpu/audio/vad.py.)
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)

SAMPLE_RATE = 16000
FRAME = 512  # samples per VAD tick (32 ms)


# ---------------------------------------------------------------------------
# Frame models
# ---------------------------------------------------------------------------


class EnergyVAD:
    """Adaptive log-energy VAD: noise floor tracking + soft threshold.

    Dependency-free default. Probability ≈ sigmoid of SNR above an
    exponentially-tracked noise floor.
    """

    def __init__(self, floor_decay: float = 0.995, snr_on_db: float = 8.0):
        self.floor_decay = floor_decay
        self.snr_on_db = snr_on_db
        self.reset_states()

    def reset_states(self) -> None:
        self._floor_db = -60.0
        self._warmup = 0

    def new_session(self) -> "EnergyVAD":
        return EnergyVAD(self.floor_decay, self.snr_on_db)

    def __call__(self, frame: np.ndarray, sr: int = SAMPLE_RATE) -> float:
        rms = float(np.sqrt(np.mean(np.square(frame)) + 1e-12))
        db = 20.0 * np.log10(rms + 1e-12)
        if self._warmup < 6:
            # assume the stream opens with (near-)silence; seed the floor
            self._floor_db = min(self._floor_db, db) if self._warmup else db
            self._warmup += 1
        # floor rises slowly, drops fast (track the quietest recent frames)
        if db < self._floor_db:
            self._floor_db = db
        else:
            self._floor_db = self.floor_decay * self._floor_db + (1 - self.floor_decay) * db
        snr = db - self._floor_db
        return float(1.0 / (1.0 + np.exp(-(snr - self.snr_on_db) / 2.0)))


class SileroJITVAD:
    """Silero v6 via torch.jit.load — bit-identical probabilities to the
    reference's JIT fallback path (silero_vad_iterator.py load_jit_vad)."""

    def __init__(self, model_path: Optional[str] = None):
        import torch

        path = find_silero_jit(model_path)
        if path is None:
            raise FileNotFoundError(
                "silero_vad.jit not found; set WLK_TPU_ASSET_DIR or pass model_path"
            )
        self._torch = torch
        self._path = str(path)
        self.model = torch.jit.load(str(path), map_location="cpu")
        self.model.eval()
        self.reset_states()

    def reset_states(self) -> None:
        if hasattr(self.model, "reset_states"):
            self.model.reset_states()

    def new_session(self) -> "SileroJITVAD":
        return SileroJITVAD(self._path)

    def __call__(self, frame: np.ndarray, sr: int = SAMPLE_RATE) -> float:
        with self._torch.no_grad():
            x = self._torch.from_numpy(np.ascontiguousarray(frame, np.float32))
            return float(self.model(x, sr).item())


def find_silero_jit(model_path: Optional[str] = None) -> Optional[Path]:
    if model_path:
        p = Path(model_path)
        return p if p.exists() else None
    candidates = []
    env = os.environ.get("WLK_TPU_ASSET_DIR")
    if env:
        candidates.append(Path(env) / "silero_vad.jit")
    ref = os.environ.get("WLK_REFERENCE_DIR")
    if ref:
        candidates.append(Path(ref) / "whisperlivekit" / "silero_vad_models" / "silero_vad.jit")
    for c in candidates:
        if c.exists():
            return c
    return None


def load_vad_model(prefer_silero: bool = True, model_path: Optional[str] = None):
    """Best available frame model: Silero weights if discoverable, else energy."""
    if prefer_silero:
        try:
            return SileroJITVAD(model_path)
        except Exception as e:  # missing torch or weights
            logger.info("Silero VAD unavailable (%s); using EnergyVAD", e)
    return EnergyVAD()


# ---------------------------------------------------------------------------
# Streaming iterators (reference-parity hysteresis)
# ---------------------------------------------------------------------------


class VADIterator:
    def __init__(
        self,
        model,
        threshold: float = 0.5,
        sampling_rate: int = SAMPLE_RATE,
        min_silence_duration_ms: int = 100,
        speech_pad_ms: int = 30,
    ):
        if sampling_rate not in (8000, 16000):
            raise ValueError("sampling rate must be 8000 or 16000")
        self.model = model
        self.threshold = threshold
        self.sampling_rate = sampling_rate
        self.min_silence_samples = sampling_rate * min_silence_duration_ms / 1000
        self.speech_pad_samples = sampling_rate * speech_pad_ms / 1000
        self.reset_states()

    def reset_states(self) -> None:
        self.model.reset_states()
        self.triggered = False
        self.temp_end = 0
        self.current_sample = 0

    def __call__(self, x: np.ndarray, return_seconds: bool = False, time_resolution: int = 1):
        window = len(x)
        self.current_sample += window
        prob = self.model(x, self.sampling_rate)

        if prob >= self.threshold and self.temp_end:
            self.temp_end = 0

        if prob >= self.threshold and not self.triggered:
            self.triggered = True
            start = max(0, self.current_sample - self.speech_pad_samples - window)
            return {
                "start": int(start)
                if not return_seconds
                else round(start / self.sampling_rate, time_resolution)
            }

        if prob < self.threshold - 0.15 and self.triggered:
            if not self.temp_end:
                self.temp_end = self.current_sample
            if self.current_sample - self.temp_end < self.min_silence_samples:
                return None
            end = self.temp_end + self.speech_pad_samples - window
            self.temp_end = 0
            self.triggered = False
            return {
                "end": int(end)
                if not return_seconds
                else round(end / self.sampling_rate, time_resolution)
            }
        return None


class FixedVADIterator(VADIterator):
    """Re-chunks arbitrary input into 512-sample ticks; returns ordered events."""

    def reset_states(self) -> None:
        super().reset_states()
        self.buffer = np.array([], dtype=np.float32)

    def __call__(self, x: np.ndarray, return_seconds: bool = False) -> List[dict]:
        self.buffer = np.append(self.buffer, x)
        events: List[dict] = []
        while len(self.buffer) >= FRAME:
            r = super().__call__(self.buffer[:FRAME], return_seconds=return_seconds)
            self.buffer = self.buffer[FRAME:]
            if r is not None:
                events.append(r)
        return events
