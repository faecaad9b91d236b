"""Voxtral realtime-causal streaming (token-by-token, 80 ms/token) (port of
whisperlivekit_tpu/streaming/voxtral_realtime.py).

The Voxtral-Mini-Realtime checkpoint streams one text token per 80 ms of
audio through a causal audio tower. As in the JAX package, it runs on the
block-causal streaming machinery (models/qwen3_asr.py: append-only tower
KV + disposable-hypothesis decoding): no threads, one device call per
appended block, constant compute per second.

Voxtral geometry maps exactly: 1 audio token = 4 encoder frames = 80 ms
(``downsample=4``); blocks of 100 frames (2 s) are encoded once each. The
HF ``VoxtralRealtimeForConditionalGeneration`` checkpoint converts via
``load_voxtral_realtime`` (audio_tower.* whisper-style naming + the
multi_modal_projector gelu MLP + language_model.* Llama tower).
"""

from __future__ import annotations

import logging

import torch

from ..models import llama as lm
from ..models import qwen3_asr as qm
from .qwen3_causal import (
    RANDOM_WEIGHTS_SEED,
    Qwen3CausalASR,
    Qwen3CausalProcessor,
    _checkpoint_dir,
    load_hf_word_tokenizer,
)

logger = logging.getLogger(__name__)


class VoxtralRealtimeASR(Qwen3CausalASR):
    """Engine holder; the streaming machinery is shared with qwen3-causal
    (same append-only tower-KV contract, same commit policy)."""

    sep = ""


class VoxtralRealtimeProcessor(Qwen3CausalProcessor):
    pass


def load_voxtral_realtime(config, device=None, dtype=torch.float32) -> VoxtralRealtimeASR:
    """HF VoxtralRealtime checkpoint dir → holder on ``device`` in ``dtype``;
    random dev weights (seeded) for CI. ``device=None`` means the card
    (``default_device``, which raises without CUDA)."""
    import json
    import os

    from ..engine.core import default_device

    device = torch.device(device) if device is not None else default_device()
    path = config.model_path
    knobs = dict(
        window_s=float(getattr(config, "qwen3_window_sec", 15.0) or 15.0),
        hold_back_words=int(getattr(config, "qwen3_hold_back_words", 2)),
        max_new=int(getattr(config, "qwen3_max_new_tokens", 48)),
    )

    if _checkpoint_dir(path):
        with open(os.path.join(path, "config.json")) as f:
            hf_cfg = json.load(f)
        text = lm.dims_from_hf_config(hf_cfg.get("text_config", hf_cfg))
        audio_cfg = hf_cfg.get("audio_config", {})
        dims = qm.Qwen3ASRDims(
            text=text,
            n_mels=audio_cfg.get("num_mel_bins", 128),
            d_audio=audio_cfg.get("hidden_size", audio_cfg.get("d_model", 1280)),
            audio_heads=audio_cfg.get("num_attention_heads",
                                      audio_cfg.get("encoder_attention_heads", 20)),
            audio_layers=audio_cfg.get("num_hidden_layers",
                                       audio_cfg.get("encoder_layers", 32)),
            audio_ff=audio_cfg.get("intermediate_size",
                                   audio_cfg.get("encoder_ffn_dim", 5120)),
            downsample=4,  # 1 audio token = 80 ms (reference :80ms/token)
        )
        from pathlib import Path

        from ..models.whisper.load import _read_safetensors_dir

        sd = _read_safetensors_dir(Path(path))
        params = _convert_voxtral_realtime(sd, dims, dtype=dtype, device=device)
        del sd
        tokenizer = load_hf_word_tokenizer(path, "voxtral")
        return VoxtralRealtimeASR(params, dims, tokenizer=tokenizer, **knobs)

    dims = qm.DEV_TINY
    gen = torch.Generator(device=device).manual_seed(RANDOM_WEIGHTS_SEED + 1)
    params = qm.init_params(dims, gen, dtype=dtype, device=device)
    logger.warning("voxtral realtime backend running RANDOM dev weights")
    return VoxtralRealtimeASR(params, dims, **knobs)


def _convert_voxtral_realtime(sd, dims: qm.Qwen3ASRDims, dtype=torch.float32, device="cpu"):
    """The audio tower shares whisper-encoder naming with qwen3-asr; the
    projector is voxtral's 2-layer gelu MLP (``linear_1``, ``linear_2``) or
    one ``linear``; the text tower is Llama under ``language_model.``."""
    return qm.convert_hf_state_dict(
        {k: v for k, v in sd.items()
         if k.startswith(("audio_tower", "multi_modal_projector.",
                          "language_model.model.", "language_model.lm_head."))},
        dims, dtype=dtype, text_prefix="language_model.model.", device=device,
    )
