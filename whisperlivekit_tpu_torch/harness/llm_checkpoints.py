"""Seeded checkpoint directories in the published HF layouts of the
audio-LLM backends (``config.json`` + ``model.safetensors``), for tests and
the GPU smoke: no published checkpoint is in the repository, and nothing is
downloaded.

- ``qwen3``: `qfuxa/qwen3-asr-0.6b-streaming` naming (audio_tower.*,
  multi_modal_projector.linear, model.*; Qwen3's q/k norms), read by
  ``load_qwen3_causal``;
- ``voxtral_realtime``: audio_tower.*, the gelu-MLP projector
  (multi_modal_projector.linear_1/2) and language_model.*, read by
  ``load_voxtral_realtime``;
- ``voxtral``: `mistralai/Voxtral-Mini-3B-2507` naming (a Whisper encoder
  under audio_tower.*, the projector, language_model.*), read by
  ``load_voxtral``.

Values come from a ``torch.Generator`` on ``device`` (on the card a
full-width checkpoint is drawn in well under a second): weights N(0, 1/fan_in),
norm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2), embeddings N(0, 0.02^2),
written in ``dtype``. No tokenizer file is written.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from ..models.llama import LlamaDims
from ..models.qwen3_asr import Qwen3ASRDims
from ..models.voxtral import VoxtralDims
from ..models.whisper.load import write_safetensors

Entry = Tuple[str, Tuple[int, ...], str]  # (name, shape, kind: w | norm | bias | emb)


def _text_entries(t: LlamaDims, prefix: str, head: str) -> List[Entry]:
    d, dh, ff = t.hidden_size, t.head_dim, t.intermediate_size
    out: List[Entry] = [(f"{prefix}embed_tokens.weight", (t.vocab_size, d), "emb")]
    for i in range(t.n_layers):
        p = f"{prefix}layers.{i}."
        out += [(p + "input_layernorm.weight", (d,), "norm"),
                (p + "self_attn.q_proj.weight", (t.n_heads * dh, d), "w"),
                (p + "self_attn.k_proj.weight", (t.n_kv_heads * dh, d), "w"),
                (p + "self_attn.v_proj.weight", (t.n_kv_heads * dh, d), "w"),
                (p + "self_attn.o_proj.weight", (d, t.n_heads * dh), "w"),
                (p + "post_attention_layernorm.weight", (d,), "norm"),
                (p + "mlp.gate_proj.weight", (ff, d), "w"),
                (p + "mlp.up_proj.weight", (ff, d), "w"),
                (p + "mlp.down_proj.weight", (d, ff), "w")]
        if t.qk_norm:
            out += [(p + "self_attn.q_norm.weight", (dh,), "norm"),
                    (p + "self_attn.k_norm.weight", (dh,), "norm")]
    out.append((f"{prefix}norm.weight", (d,), "norm"))
    if not t.tie_embeddings:
        out.append((head, (t.vocab_size, d), "w"))
    return out


def _tower_entries(n_mels: int, d: int, layers: int, ff: int) -> List[Entry]:
    at = "audio_tower"
    out: List[Entry] = [(f"{at}.conv1.weight", (d, n_mels, 3), "w"), (f"{at}.conv1.bias", (d,), "bias"),
                        (f"{at}.conv2.weight", (d, d, 3), "w"), (f"{at}.conv2.bias", (d,), "bias")]
    for i in range(layers):
        p = f"{at}.layers.{i}."
        out += [(p + "self_attn_layer_norm.weight", (d,), "norm"), (p + "self_attn_layer_norm.bias", (d,), "bias")]
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out.append((p + f"self_attn.{proj}.weight", (d, d), "w"))
            if proj != "k_proj":
                out.append((p + f"self_attn.{proj}.bias", (d,), "bias"))
        out += [(p + "final_layer_norm.weight", (d,), "norm"), (p + "final_layer_norm.bias", (d,), "bias"),
                (p + "fc1.weight", (ff, d), "w"), (p + "fc1.bias", (ff,), "bias"),
                (p + "fc2.weight", (d, ff), "w"), (p + "fc2.bias", (d,), "bias")]
    out += [(f"{at}.layer_norm.weight", (d,), "norm"), (f"{at}.layer_norm.bias", (d,), "bias")]
    return out


def _llama_config(t: LlamaDims) -> dict:
    return dict(vocab_size=t.vocab_size, hidden_size=t.hidden_size, num_hidden_layers=t.n_layers,
                num_attention_heads=t.n_heads, num_key_value_heads=t.n_kv_heads,
                intermediate_size=t.intermediate_size, head_dim=t.head_dim, rope_theta=t.rope_theta,
                rms_norm_eps=t.rms_eps, max_position_embeddings=t.max_positions,
                tie_word_embeddings=t.tie_embeddings)


def layout(kind: str, dims) -> Tuple[List[Entry], dict]:
    """The tensors (name, shape, kind) and the config.json of a ``kind``
    checkpoint ("qwen3", "voxtral_realtime" or "voxtral") at ``dims``."""
    if kind == "qwen3":
        d: Qwen3ASRDims = dims
        entries = _tower_entries(d.n_mels, d.d_audio, d.audio_layers, d.audio_ff)
        entries.append(("multi_modal_projector.linear.weight", (d.text.hidden_size, d.downsample * d.d_audio), "w"))
        entries += _text_entries(d.text, "model.", "lm_head.weight")
        cfg = dict(text_config=_llama_config(d.text),
                   audio_config=dict(num_mel_bins=d.n_mels, d_model=d.d_audio, encoder_attention_heads=d.audio_heads,
                                     encoder_layers=d.audio_layers, encoder_ffn_dim=d.audio_ff))
    elif kind == "voxtral_realtime":
        d = dims
        h = d.text.hidden_size
        entries = _tower_entries(d.n_mels, d.d_audio, d.audio_layers, d.audio_ff)
        entries += [("multi_modal_projector.linear_1.weight", (h, d.downsample * d.d_audio), "w"),
                    ("multi_modal_projector.linear_2.weight", (h, h), "w")]
        entries += _text_entries(d.text, "language_model.model.", "language_model.lm_head.weight")
        cfg = dict(text_config=_llama_config(d.text),
                   audio_config=dict(num_mel_bins=d.n_mels, hidden_size=d.d_audio, num_attention_heads=d.audio_heads,
                                     num_hidden_layers=d.audio_layers, intermediate_size=d.audio_ff))
    elif kind == "voxtral":
        v: VoxtralDims = dims
        a, h = v.audio, v.text.hidden_size
        entries = _tower_entries(a.n_mels, a.n_audio_state, a.n_audio_layer, 4 * a.n_audio_state)
        entries += [("multi_modal_projector.linear_1.weight", (h, v.downsample * a.n_audio_state), "w"),
                    ("multi_modal_projector.linear_2.weight", (h, h), "w")]
        entries += _text_entries(v.text, "language_model.model.", "language_model.lm_head.weight")
        cfg = dict(text_config=_llama_config(v.text), audio_token_id=v.audio_token_id,
                   audio_config=dict(num_mel_bins=a.n_mels, max_source_positions=a.n_audio_ctx,
                                     hidden_size=a.n_audio_state, num_attention_heads=a.n_audio_head,
                                     num_hidden_layers=a.n_audio_layer, intermediate_size=4 * a.n_audio_state,
                                     vocab_size=a.n_vocab))
    else:
        raise ValueError(f"unknown checkpoint kind {kind!r}")
    return entries, cfg


def state_dict(kind: str, dims, seed: int, dtype=torch.float32, device="cpu") -> Dict[str, torch.Tensor]:
    """The seeded tensors of a ``kind`` checkpoint, on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    sd = {}
    for name, shape, how in layout(kind, dims)[0]:
        x = torch.randn(shape, generator=g, device=device)
        if how == "w":
            fan_in = shape[1] * (shape[2] if len(shape) == 3 else 1)
            x = x * fan_in ** -0.5
        elif how == "norm":
            x = 1.0 + 0.1 * x
        elif how == "bias":
            x = 0.1 * x
        else:
            x = 0.02 * x
        sd[name] = x.to(dtype)
    return sd


def write_checkpoint(directory, kind: str, dims, seed: int, dtype=torch.float32, device="cpu") -> int:
    """Write a seeded ``kind`` checkpoint into ``directory`` (config.json +
    model.safetensors); returns the safetensors file's bytes."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "config.json").write_text(json.dumps(layout(kind, dims)[1]))
    return write_safetensors(directory / "model.safetensors", state_dict(kind, dims, seed, dtype, device))
