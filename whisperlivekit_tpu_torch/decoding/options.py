"""Decoding options/result types (reference whisper/decoding.py:18-135 parity).

A host copy of whisperlivekit_tpu/decoding/options.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence, Union

import numpy as np


@dataclass(frozen=True)
class DecodingOptions:
    task: str = "transcribe"          # "transcribe" | "translate"
    language: Optional[str] = None    # None = detect

    temperature: float = 0.0
    sample_len: Optional[int] = None  # max new tokens
    best_of: Optional[int] = None     # independent samples when temperature > 0
    beam_size: Optional[int] = None   # beams when temperature == 0
    patience: Optional[float] = None

    length_penalty: Optional[float] = None

    prompt: Optional[Union[str, List[int]]] = None   # previous-context conditioning
    prefix: Optional[Union[str, List[int]]] = None   # forced start of this window

    suppress_tokens: Optional[Union[str, Sequence[int]]] = "-1"
    suppress_blank: bool = True

    without_timestamps: bool = False
    max_initial_timestamp: Optional[float] = 1.0

    fp16: bool = False  # kept for API compat; dtype comes from loaded params

    def with_(self, **kw) -> "DecodingOptions":
        return replace(self, **kw)


@dataclass
class DecodingResult:
    audio_features: Optional[np.ndarray] = None
    language: str = ""
    language_probs: Optional[dict] = None
    tokens: List[int] = field(default_factory=list)
    text: str = ""
    avg_logprob: float = np.nan
    no_speech_prob: float = np.nan
    temperature: float = np.nan
    compression_ratio: float = np.nan


def compression_ratio(text: str) -> float:
    """zlib compression ratio — repetition detector (reference whisper/utils.py)."""
    import zlib

    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))
