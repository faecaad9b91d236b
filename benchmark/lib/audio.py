"""The audio the benchmark feeds, and the vocabulary file it writes.

``speech_like`` is formant-synthesized pseudo-speech: a glottal sawtooth
with a prosodic pitch contour, three formant resonators that restart every
20 ms frame, a syllable-rate envelope and a little noise. It is a frozen,
vectorized copy of the generator in the program's e2e harness
(``harness/e2e_serving.speech_like``): the same math, run over all frames at
once instead of one ``lfilter`` call per frame, so minutes of audio take
about a second.

A run synthesizes a few long voices in set-up; each session reads one voice
from its own offset, wrapping at the voice's end. Which voices there are,
and which voice and offset a session gets, is drawn from the plan's seed
(``lib/drive.py``).
"""

from __future__ import annotations

import base64
import itertools
import string
from pathlib import Path

import numpy as np

SR = 16000
FRAME = 320  # the resonators restart every 20 ms


def _sawtooth(x: np.ndarray, width: float) -> np.ndarray:
    """scipy.signal.sawtooth: rises from -1 to 1 over ``width`` of the period."""
    t = np.mod(x, 2 * np.pi)
    w = width
    return np.where(t < w * 2 * np.pi, t / (np.pi * w) - 1, (np.pi * (w + 1) - t) / (np.pi * (1 - w)))


def _resonate(x: np.ndarray, freq: np.ndarray, bw: float) -> np.ndarray:
    """Two-pole resonator with gain 1 - r, restarted from rest in every row.
    x [frames, FRAME]; freq [frames] Hz."""
    r = np.exp(-np.pi * bw / SR)
    a1 = -2 * r * np.cos(2 * np.pi * freq / SR)
    a2 = r * r
    y = np.zeros_like(x)
    y1 = np.zeros(x.shape[0])
    y2 = np.zeros(x.shape[0])
    for n in range(x.shape[1]):
        cur = (1 - r) * x[:, n] - a1 * y1 - a2 * y2
        y[:, n] = cur
        y2, y1 = y1, cur
    return y


def speech_like(seconds: float, seed: int = 0) -> np.ndarray:
    """``seconds`` of pseudo-speech from time 0, float32 in about [-0.3, 0.3]."""
    rng = np.random.default_rng(seed)
    ph = rng.uniform(0, 2 * np.pi, 6)
    n = int(SR * seconds)
    t = np.arange(n) / SR
    base = 105 + 6 * (seed % 5)
    integ = (
        base * t
        - 15 / (2 * np.pi * 0.31) * np.cos(2 * np.pi * 0.31 * t + ph[0])
        - 4 / (2 * np.pi * 5.1) * np.cos(2 * np.pi * 5.1 * t + ph[1])
    )
    src = _sawtooth(2 * np.pi * integ + ph[2], 0.9)
    vow = 0.5 + 0.5 * np.sin(2 * np.pi * 0.9 * t + ph[3])
    n_frames = -(-n // FRAME)
    pad = n_frames * FRAME - n
    y = np.pad(src, (0, pad)).reshape(n_frames, FRAME)
    starts = np.arange(n_frames) * FRAME
    for freq, bw in ((350 + 450 * vow[starts], 80.0), (900 + 900 * (1 - vow[starts]), 120.0),
                     (2500 + 200 * vow[starts], 160.0)):
        y = _resonate(y, freq, bw)
    out = y.reshape(-1)[:n]
    env = np.clip(1.5 * np.sin(2 * np.pi * 2.3 * t + ph[4]), 0, 1) ** 0.5
    out = out * env * 50.0
    out += 0.008 * np.random.default_rng((seed, 0)).standard_normal(n)
    return out.astype(np.float32)


class Voices:
    """``n`` voices of ``seconds`` each, their seeds drawn from ``seed``. A
    stream is a (voice, start sample) pair; ``read`` wraps at the end."""

    def __init__(self, seed: int, n: int, seconds: float):
        seeds = np.random.default_rng([seed, 11]).integers(0, 2 ** 31, n)
        self.voices = [speech_like(seconds, int(s)) for s in seeds]
        self.length = len(self.voices[0])

    def read(self, voice: int, start: int, a: int, b: int) -> np.ndarray:
        v = self.voices[voice]
        idx = (start + np.arange(a, b)) % self.length
        return v[idx]


# ---------------------------------------------------------------------------
# Vocabulary
# ---------------------------------------------------------------------------

N_RANKS = 50257  # Whisper's byte-pair ranks; the special tokens follow
_CHARS = " " + string.ascii_lowercase + string.ascii_uppercase + string.digits + string.punctuation


def standin_ranks() -> list:
    """50257 distinct byte strings: the 256 single bytes at their own
    values, then printable 2- and 3-byte strings. No merge makes a longer
    token, so every text encodes; the special ids keep Whisper's layout."""
    out = [bytes([b]) for b in range(256)]
    seen = set(out)
    for n in (2, 3):
        for combo in itertools.product(_CHARS, repeat=n):
            tok = "".join(combo).encode()
            if tok not in seen:
                seen.add(tok)
                out.append(tok)
                if len(out) == N_RANKS:
                    return out
    raise AssertionError("alphabet too small")


def write_vocab(directory: Path) -> Path:
    """Write ``multilingual.tiktoken`` (a stand-in for Whisper's rank file,
    which the repository does not carry) into ``directory`` once."""
    path = Path(directory) / "multilingual.tiktoken"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".part")
        tmp.write_text("".join(f"{base64.b64encode(t).decode()} {r}\n" for r, t in enumerate(standin_ranks())))
        tmp.replace(path)
    return path
