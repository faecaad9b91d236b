"""Test signals made from a seed with numpy (no audio files needed)."""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16000


def speech_like(n: int, seed: int, f0: float = 150.0) -> np.ndarray:
    """f32 [n] at 16 kHz with a voice's spectral shape: the harmonics of
    ``f0`` up to 8 kHz with random phases, falling linearly in dB from the
    fundamental to -60 dB at the last, under a 3.1 Hz syllable envelope,
    plus white noise 80 dB under the fundamental. The fundamental's
    amplitude is 0.1. Spectra this shaped keep quiet mel bins inside the
    log-mel's 80 dB floor, which white noise does not."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SAMPLE_RATE
    n_h = int(SAMPLE_RATE / 2 // f0)
    gain_db = -60.0 * np.arange(n_h) / max(n_h - 1, 1)
    sig = np.zeros(n)
    for h, (g, ph) in enumerate(zip(gain_db, rng.uniform(0, 2 * np.pi, n_h)), start=1):
        sig += 10 ** (g / 20) * np.sin(2 * np.pi * f0 * h * t + ph)
    sig *= 1 + 0.4 * np.sin(2 * np.pi * 3.1 * t)
    sig += 1e-4 * rng.standard_normal(n)
    return (0.1 * sig).astype(np.float32)
