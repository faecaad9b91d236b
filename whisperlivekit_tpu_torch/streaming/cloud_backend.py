"""OpenAI-compatible cloud ASR backend for the LocalAgreement policy.

Role of reference local_agreement/backends.py:222-287 (OpenaiApiASR): each
``process_iter`` ships the rolling audio buffer to a remote
``/v1/audio/transcriptions`` endpoint (OpenAI's, or any compatible server —
including this framework's own REST surface, which is how the tests run it
hermetically). Uses urllib multipart; no SDK dependency.

A copy of whisperlivekit_tpu/streaming/cloud_backend.py (host code only).
"""

from __future__ import annotations

import io
import json
import logging
import math
import os
import urllib.request
import uuid
import wave
from typing import List, Optional

import numpy as np

from ..timed import ASRToken

logger = logging.getLogger(__name__)

DEFAULT_BASE_URL = "https://api.openai.com/v1"


def _wav_bytes(audio: np.ndarray, sample_rate: int = 16000) -> bytes:
    pcm = (np.clip(audio, -1.0, 1.0 - 1 / 32768) * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def _multipart(fields: dict, file_field: str, filename: str, file_bytes: bytes):
    boundary = uuid.uuid4().hex
    out = io.BytesIO()
    for name, value in fields.items():
        out.write(f"--{boundary}\r\n".encode())
        out.write(f'Content-Disposition: form-data; name="{name}"\r\n\r\n'.encode())
        out.write(f"{value}\r\n".encode())
    out.write(f"--{boundary}\r\n".encode())
    out.write(
        f'Content-Disposition: form-data; name="{file_field}"; filename="{filename}"\r\n'
        f"Content-Type: audio/wav\r\n\r\n".encode()
    )
    out.write(file_bytes)
    out.write(f"\r\n--{boundary}--\r\n".encode())
    return out.getvalue(), f"multipart/form-data; boundary={boundary}"


class CloudWhisperASR:
    """LocalAgreement batch-backend duck type over a remote API."""

    sep = " "

    def __init__(
        self,
        language: Optional[str] = None,
        model_name: str = "whisper-1",
        base_url: Optional[str] = None,
        api_key: Optional[str] = None,
        temperature: float = 0.0,
        timeout: float = 60.0,
    ):
        self.original_language = None if language == "auto" else language
        self.model_name = model_name
        self.base_url = (base_url or os.environ.get("OPENAI_BASE_URL") or DEFAULT_BASE_URL).rstrip("/")
        self.api_key = api_key or os.environ.get("OPENAI_API_KEY", "")
        self.temperature = temperature
        self.timeout = timeout
        self.task = "transcribe"
        self.direct_english_translation = False
        self.use_vad_opt = False
        self.transcribed_seconds = 0

    def use_vad(self) -> None:
        self.use_vad_opt = True

    # -- the LocalAgreement backend contract ---------------------------------

    def transcribe(self, audio: np.ndarray, init_prompt: str = "") -> dict:
        self.transcribed_seconds += math.ceil(len(audio) / 16000)
        fields = {
            "model": self.model_name,
            "response_format": "verbose_json",
            "temperature": str(self.temperature),
            "timestamp_granularities[]": "word",
        }
        if not self.direct_english_translation and self.original_language:
            fields["language"] = self.original_language
        if init_prompt:
            fields["prompt"] = init_prompt
        endpoint = "translations" if self.task == "translate" else "transcriptions"
        body, ctype = _multipart(
            fields, "file", "audio.wav", _wav_bytes(np.asarray(audio, np.float32))
        )
        req = urllib.request.Request(
            f"{self.base_url}/audio/{endpoint}", data=body, method="POST"
        )
        req.add_header("Content-Type", ctype)
        if self.api_key:
            req.add_header("Authorization", f"Bearer {self.api_key}")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            res = json.loads(resp.read().decode())
        logger.debug("cloud ASR processed %d cumulative seconds", self.transcribed_seconds)
        return res

    def ts_words(self, res: dict) -> List[ASRToken]:
        suppressed = []
        if self.use_vad_opt:
            suppressed = [
                (s.get("start", 0.0), s.get("end", 0.0))
                for s in res.get("segments", [])
                if s.get("no_speech_prob", 0.0) > 0.8
            ]
        tokens = []
        for word in res.get("words", []):
            start = word["start"]
            if any(a <= start <= b for a, b in suppressed):
                continue
            tokens.append(ASRToken(start=start, end=word["end"], text=word["word"]))
        return tokens

    def segments_end_ts(self, res: dict) -> List[float]:
        return [w["end"] for w in res.get("words", [])]
