"""Voxtral ASR backend: loader + batch-transcribe surface for the policies
(port of whisperlivekit_tpu/models/voxtral_backend.py).

Loads the checkpoint onto the serving device and exposes the batch
``transcribe`` contract, so the windowed / LocalAgreement online
processors can drive Voxtral as a streaming backend. Word timestamps are
interpolated at the reference's 80 ms/audio-token rate.

Tokenizer: the directory's ``tokenizer.json`` through the ``tokenizers``
package; without the file, no text (a warning). The file present without
the package raises. ``transcribe`` runs one call at a time per backend
(``_session_lock``, as the port's ``TorchWhisperASR``): concurrent eager
greedy loops convoy on the interpreter lock.
"""

from __future__ import annotations

import json
import logging
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..audio.mel import N_SAMPLES, log_mel_spectrogram, pad_or_trim
from ..timed import ASRToken
from . import voxtral as V

logger = logging.getLogger(__name__)

HF_VOXTRAL_REPO = "mistralai/Voxtral-Mini-3B-2507"


def load_voxtral(model_path: Optional[str] = None, dtype=torch.bfloat16, device=None):
    """Load a local HF Voxtral checkpoint directory onto ``device`` →
    (model, dims, tokenizer). ``device=None`` means the card
    (``default_device``, which raises without CUDA)."""
    from ..engine.core import default_device

    device = torch.device(device) if device is not None else default_device()
    path = Path(model_path) if model_path else _find_cached()
    if path is None or not (path / "config.json").exists():
        raise FileNotFoundError(
            "no local Voxtral weights; run `wlk pull voxtral` with network access"
        )
    cfg = json.loads((path / "config.json").read_text())
    dims = V.dims_from_hf_config(cfg)
    from .whisper.load import _read_safetensors_dir

    sd = _read_safetensors_dir(path)
    params = V.convert_hf_state_dict(sd, dims, dtype=dtype, device=device)
    del sd
    tokenizer = None
    tok_file = path / "tokenizer.json"
    if tok_file.exists():
        try:
            from tokenizers import Tokenizer as HFTokenizer
        except ImportError as e:
            raise ImportError(f"{tok_file} is present, but the tokenizers package is not installed") from e
        tokenizer = HFTokenizer.from_file(str(tok_file))
    else:
        logger.warning("Voxtral tokenizer.json missing; text decode unavailable")
    return params, dims, tokenizer


def _find_cached() -> Optional[Path]:
    hub = Path.home() / ".cache" / "huggingface" / "hub"
    snaps = hub / f"models--{HF_VOXTRAL_REPO.replace('/', '--')}" / "snapshots"
    if snaps.exists():
        found = sorted(snaps.iterdir())
        return found[-1] if found else None
    return None


class VoxtralASR:
    """Batch backend contract (transcribe / ts_words / segments_end_ts)."""

    sep = ""
    SECONDS_PER_AUDIO_TOKEN = 0.08  # reference voxtral_hf_streaming.py rate

    def __init__(self, params, dims: V.VoxtralDims, tokenizer, *,
                 buffer_trimming="segment", buffer_trimming_sec=15.0):
        self.params = params
        self.dims = dims
        self.tokenizer = None  # sentence tokenizer slot (policy API)
        self.text_tokenizer = tokenizer
        self.confidence_validation = False
        self.buffer_trimming = buffer_trimming
        self.buffer_trimming_sec = buffer_trimming_sec
        self.max_new_tokens = 128
        # prompt scaffold ids resolved from the tokenizer when available
        self.bos_id = 1
        self.eos_id = 2
        self.original_language = None
        self._session_lock = threading.RLock()

    def _prompt_ids(self, n_audio_tokens: int) -> np.ndarray:
        ids = [self.bos_id] + [self.dims.audio_token_id] * n_audio_tokens
        return np.asarray([ids], np.int64)

    def transcribe(self, audio: np.ndarray, init_prompt: str = "") -> dict:
        audio = np.asarray(audio, np.float32)[: N_SAMPLES]
        duration = len(audio) / 16000.0
        dev = self.params.device
        with self._session_lock:
            mel = pad_or_trim(
                log_mel_spectrogram(
                    torch.from_numpy(audio).to(dev), n_mels=self.dims.audio.n_mels,
                    padding=N_SAMPLES - len(audio),
                ),
                2 * self.dims.audio.n_audio_ctx,
            )[None]
            prompt = torch.from_numpy(self._prompt_ids(self.dims.audio_tokens_per_window)).to(dev)
            out = V.greedy_generate(
                self.params, prompt, mel, self.eos_id, self.dims, self.max_new_tokens,
            )
            ids = out[0].tolist()
        ids = ids[: ids.index(self.eos_id)] if self.eos_id in ids else ids
        text = self.text_tokenizer.decode(ids) if self.text_tokenizer else ""
        return {"text": text, "token_ids": ids, "duration": duration}

    def ts_words(self, res: dict) -> List[ASRToken]:
        """Interpolated word timings over the utterance span (Voxtral emits
        no timestamps; reference interpolates from token positions)."""
        words = (res.get("text") or "").split()
        if not words:
            return []
        duration = max(res.get("duration", 0.0), 0.04 * len(words))
        step = duration / len(words)
        return [
            ASRToken(start=i * step, end=(i + 1) * step,
                     text=(" " if i else "") + w)
            for i, w in enumerate(words)
        ]

    def segments_end_ts(self, res: dict) -> List[float]:
        return [res.get("duration", 0.0)]

    def use_vad(self) -> None:
        pass
