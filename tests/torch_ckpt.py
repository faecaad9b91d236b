"""Checkpoint and audio files for the port's CPU tests, written from seeded
numpy arrays in the published layouts (no download, no ``transformers``):
OpenAI ``.pt`` (canonical keys, with or without ``dims``), HF directories
(``config.json`` + safetensors, one file or sharded with an index), PEFT
LoRA adapter directories, and 16-bit PCM WAVs of ``harness/signals.py``
speech-like audio."""

import dataclasses
import json
import wave

import numpy as np
import torch

from whisperlivekit_tpu_torch.harness.signals import speech_like


def canonical_state_dict(dims, seed: int) -> dict:
    """Every key of an OpenAI Whisper checkpoint (canonical names, [out, in]
    dense weights, no key bias), random f32 values from ``seed``."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(name, *shape, scale=0.1):
        sd[name] = (rng.standard_normal(shape) * scale).astype(np.float32)

    def ln(prefix, d):
        put(f"{prefix}.weight", d)
        sd[f"{prefix}.weight"] += 1.0
        put(f"{prefix}.bias", d)

    def attn(prefix, d):
        for proj in ("query", "key", "value", "out"):
            put(f"{prefix}.{proj}.weight", d, d)
            if proj != "key":
                put(f"{prefix}.{proj}.bias", d)

    def block(prefix, d, cross):
        ln(f"{prefix}.attn_ln", d)
        attn(f"{prefix}.attn", d)
        if cross:
            ln(f"{prefix}.cross_attn_ln", d)
            attn(f"{prefix}.cross_attn", d)
        ln(f"{prefix}.mlp_ln", d)
        put(f"{prefix}.mlp.0.weight", 4 * d, d)
        put(f"{prefix}.mlp.0.bias", 4 * d)
        put(f"{prefix}.mlp.2.weight", d, 4 * d)
        put(f"{prefix}.mlp.2.bias", d)

    d = dims.n_audio_state
    put("encoder.conv1.weight", d, dims.n_mels, 3)
    put("encoder.conv1.bias", d)
    put("encoder.conv2.weight", d, d, 3)
    put("encoder.conv2.bias", d)
    put("encoder.positional_embedding", dims.n_audio_ctx, d)
    for i in range(dims.n_audio_layer):
        block(f"encoder.blocks.{i}", d, cross=False)
    ln("encoder.ln_post", d)
    put("decoder.token_embedding.weight", dims.n_vocab, dims.n_text_state)
    put("decoder.positional_embedding", dims.n_text_ctx, dims.n_text_state)
    for i in range(dims.n_text_layer):
        block(f"decoder.blocks.{i}", dims.n_text_state, cross=True)
    ln("decoder.ln", dims.n_text_state)
    return sd


_TO_HF = [
    ("encoder.positional_embedding", "encoder.embed_positions.weight"),
    ("decoder.positional_embedding", "decoder.embed_positions.weight"),
    ("decoder.token_embedding.", "decoder.embed_tokens."),
    ("encoder.ln_post.", "encoder.layer_norm."),
    ("decoder.ln.", "decoder.layer_norm."),
    (".blocks.", ".layers."),
    (".cross_attn_ln.", ".encoder_attn_layer_norm."),
    (".cross_attn.", ".encoder_attn."),
    (".attn_ln.", ".self_attn_layer_norm."),
    (".attn.", ".self_attn."),
    (".mlp_ln.", ".final_layer_norm."),
    (".mlp.0.", ".fc1."),
    (".mlp.2.", ".fc2."),
    (".query.", ".q_proj."),
    (".key.", ".k_proj."),
    (".value.", ".v_proj."),
    (".out.", ".out_proj."),
]


def hf_name(canon: str) -> str:
    for a, b in _TO_HF:
        canon = canon.replace(a, b)
    return "model." + canon


def hf_config(dims) -> dict:
    return dict(d_model=dims.n_audio_state, encoder_attention_heads=dims.n_audio_head,
                encoder_layers=dims.n_audio_layer, decoder_attention_heads=dims.n_text_head,
                decoder_layers=dims.n_text_layer, vocab_size=dims.n_vocab, num_mel_bins=dims.n_mels,
                max_source_positions=dims.n_audio_ctx, max_target_positions=dims.n_text_ctx)


def write_openai(path, sd, dims=None, dtype=np.float16):
    state = {k: torch.from_numpy(v.astype(dtype)) for k, v in sd.items()}
    torch.save({"dims": dataclasses.asdict(dims), "model_state_dict": state} if dims else state, path)
    return path


def write_hf(directory, sd, dims, shards: int = 1, dtype=np.float32):
    from safetensors.numpy import save_file

    directory.mkdir()
    (directory / "config.json").write_text(json.dumps(hf_config(dims)))
    items = sorted((hf_name(k), v.astype(dtype)) for k, v in sd.items())
    if shards == 1:
        save_file(dict(items), str(directory / "model.safetensors"))
        return directory
    weight_map = {}
    for s in range(shards):
        name = f"model-{s + 1:05d}-of-{shards:05d}.safetensors"
        part = dict(items[s::shards])
        save_file(part, str(directory / name))
        weight_map.update(dict.fromkeys(part, name))
    (directory / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    return directory


def write_lora(directory, dims, seed: int, r: int = 4):
    """A PEFT adapter on encoder and decoder self-attention, decoder
    cross-attention and one target no loader maps (fc1)."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(seed)
    directory.mkdir()
    (directory / "adapter_config.json").write_text(json.dumps({"r": r, "lora_alpha": 3 * r}))
    d = dims.n_audio_state
    targets = ["model.encoder.layers.0.self_attn.q_proj", "model.encoder.layers.2.self_attn.v_proj",
               "model.decoder.layers.1.self_attn.k_proj", "model.decoder.layers.0.encoder_attn.out_proj",
               "model.decoder.layers.1.fc1"]
    sd = {}
    for t in targets:
        d_out = 4 * d if t.endswith("fc1") else d
        sd[f"base_model.model.{t}.lora_A.weight"] = (rng.standard_normal((r, d)) * 0.05).astype(np.float32)
        sd[f"base_model.model.{t}.lora_B.weight"] = (rng.standard_normal((d_out, r)) * 0.05).astype(np.float32)
    save_file(sd, str(directory / "adapter_model.safetensors"))
    return directory


def write_wav(path, seconds: float = 3.0, seed: int = 1):
    """Speech-like 16 kHz mono s16le: two voices back to back."""
    n = int(16000 * seconds)
    audio = np.concatenate([speech_like(n // 2, seed), speech_like(n - n // 2, seed + 1, f0=200.0)])
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(3 * audio, -1, 1) * 32767).astype("<i2").tobytes())
    return path
