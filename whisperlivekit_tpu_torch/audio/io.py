"""Host-side audio IO: WAV/PCM loading without external binaries.

The reference shells out to ffmpeg for all file decoding (reference
whisper/audio.py:45-56). This framework decodes WAV natively (stdlib
``wave`` + numpy) and falls back to an ffmpeg subprocess only for compressed
containers when the binary exists — audio decode is host IO, not device compute.
A host copy of whisperlivekit_tpu/audio/io.py; ``SAMPLE_RATE`` comes from the
port's own audio/mel.py.
"""

from __future__ import annotations

import shutil
import subprocess
import wave
from pathlib import Path

import numpy as np

from .mel import SAMPLE_RATE


def s16le_to_float32(data: bytes | np.ndarray) -> np.ndarray:
    """Convert signed 16-bit little-endian PCM to float32 in [-1, 1).

    Uses the native pcm_runtime when built (per-chunk hot path)."""
    from .. import native

    return native.s16le_to_f32(data)


def float32_to_s16le(audio: np.ndarray) -> bytes:
    from .. import native

    return native.f32_to_s16le(np.asarray(audio))


def resample(audio: np.ndarray, orig_sr: int, target_sr: int = SAMPLE_RATE) -> np.ndarray:
    """Polyphase resampling via scipy when rates differ."""
    if orig_sr == target_sr:
        return audio
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    return resample_poly(audio, target_sr // g, orig_sr // g).astype(np.float32)


def load_wav(path: str | Path, target_sr: int = SAMPLE_RATE) -> np.ndarray:
    """Load a PCM WAV file as mono float32 at ``target_sr``."""
    with wave.open(str(path), "rb") as w:
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        sr = w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 2:
        audio = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        audio = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        audio = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width: {width}")
    if n_ch > 1:
        audio = audio.reshape(-1, n_ch).mean(axis=1)
    return resample(audio, sr, target_sr)


def save_wav(path: str | Path, audio: np.ndarray, sr: int = SAMPLE_RATE) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(float32_to_s16le(audio))


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def load_audio(path: str | Path, target_sr: int = SAMPLE_RATE) -> np.ndarray:
    """Load any audio file as mono float32 @ target_sr.

    WAV decodes natively; other containers require the optional ffmpeg binary
    (same CLI contract as reference whisper/audio.py:45-56).
    """
    path = Path(path)
    if path.suffix.lower() in (".wav", ".wave"):
        try:
            return load_wav(path, target_sr)
        except wave.Error:
            pass  # mislabeled container; fall through to ffmpeg
    if not ffmpeg_available():
        raise RuntimeError(
            f"cannot decode {path.name}: not a PCM WAV and ffmpeg is not installed"
        )
    cmd = [
        "ffmpeg", "-nostdin", "-threads", "0", "-i", str(path),
        "-f", "s16le", "-ac", "1", "-acodec", "pcm_s16le", "-ar", str(target_sr), "-",
    ]
    out = subprocess.run(cmd, capture_output=True, check=True).stdout
    return s16le_to_float32(out)
