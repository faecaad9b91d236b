"""Voxtral (Mistral audio-LLM) in PyTorch: whisper-style encoder + Llama
decoder (port of whisperlivekit_tpu/models/voxtral.py).

The audio tower is models/whisper's encoder (identical architecture), run
by the port's ``encode``, so on the card its attention is the K1 kernel
(ops/flash_encoder.py). Frames are grouped 4x into audio tokens (1 token =
80 ms), projected (gelu MLP, no bias) into the Llama embedding space, and
spliced over the audio placeholder ids. Decode runs on models/llama with
per-lane KV-cache positions.

The weights live in a ``Voxtral`` module (``audio``: a whisper ``Encoder``,
``proj1``/``proj2``, ``text``: a ``Llama``); ``convert_hf_state_dict`` maps
`mistralai/Voxtral-Mini-3B-2507`-style checkpoints and
``voxtral_params_from_jax`` the JAX pytree. ``greedy_generate`` is a host
loop of decoder steps that reads ``done.all()`` once a step, where JAX
compiles one ``while_loop``.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import llama as lm
from .whisper import model as wm
from .whisper.dims import ModelDimensions
from .whisper.model import Dense, _linear_f32


@dataclass(frozen=True)
class VoxtralDims:
    audio: ModelDimensions        # encoder half only (decoder fields unused)
    text: lm.LlamaDims
    downsample: int = 4           # encoder frames per audio token
    audio_token_id: int = 24      # HF default placeholder id

    @property
    def audio_tokens_per_window(self) -> int:
        return self.audio.n_audio_ctx // self.downsample


#: mistralai/Voxtral-Mini-3B-2507's published widths (its config.json): the
#: Whisper-large-v3 encoder (32 layers) and a 30-layer Mistral text tower
VOXTRAL_MINI_3B = VoxtralDims(
    audio=ModelDimensions(n_mels=128, n_audio_ctx=1500, n_audio_state=1280, n_audio_head=20, n_audio_layer=32,
                          n_vocab=51866, n_text_ctx=1, n_text_state=1280, n_text_head=20, n_text_layer=1),
    text=lm.LlamaDims(vocab_size=131072, hidden_size=3072, n_layers=30, n_heads=32, n_kv_heads=8,
                      intermediate_size=8192, head_dim=128, rope_theta=1e8, rms_eps=1e-5,
                      max_positions=131072, tie_embeddings=False),
    audio_token_id=24,
)


def audio_dims_from_hf(cfg: dict) -> ModelDimensions:
    return ModelDimensions(
        n_mels=cfg.get("num_mel_bins", 128),
        n_audio_ctx=cfg.get("max_source_positions", 1500),
        n_audio_state=cfg["hidden_size"],
        n_audio_head=cfg["num_attention_heads"],
        n_audio_layer=cfg["num_hidden_layers"],
        n_vocab=cfg.get("vocab_size", 51866),
        n_text_ctx=1,
        n_text_state=cfg["hidden_size"],
        n_text_head=cfg["num_attention_heads"],
        n_text_layer=1,
    )


def dims_from_hf_config(cfg: dict) -> VoxtralDims:
    return VoxtralDims(
        audio=audio_dims_from_hf(cfg["audio_config"]),
        text=lm.dims_from_hf_config(cfg["text_config"]),
        audio_token_id=cfg.get("audio_token_id") or 24,
    )


# ---------------------------------------------------------------------------
# Modules and params
# ---------------------------------------------------------------------------


class Voxtral(nn.Module):
    def __init__(self, dims: VoxtralDims, lm_head: bool = True):
        super().__init__()
        self.dims = dims
        inter = dims.audio.n_audio_state * dims.downsample
        self.audio = wm.Encoder(dims.audio)
        self.proj1 = Dense(inter, dims.text.hidden_size, bias=False)
        self.proj2 = Dense(dims.text.hidden_size, dims.text.hidden_size, bias=False)
        self.text = lm.Llama(dims.text, lm_head=lm_head)

    @property
    def dtype(self) -> torch.dtype:
        return self.text.dtype

    @property
    def device(self) -> torch.device:
        return self.text.device


def init_params(dims: VoxtralDims, generator: torch.Generator, dtype=torch.float32, device="cpu") -> Voxtral:
    """Random weights with JAX ``init_params``' shapes and scales from
    ``generator``, drawn on its device; the numbers differ from JAX's."""
    model = Voxtral(dims, lm_head=not dims.text.tie_embeddings)
    gdev = generator.device
    with torch.no_grad():
        for mod in list(model.audio.modules()) + [model.proj1, model.proj2]:
            if isinstance(mod, (Dense, wm.Conv)):
                fan_in = mod.weight.shape[1] * (3 if isinstance(mod, wm.Conv) else 1)
                mod.weight.data = torch.randn(mod.weight.shape, generator=generator, device=gdev) * fan_in ** -0.5
    model.text = lm.init_params(dims.text, generator, dtype=dtype, device=device)
    return model.to(device=device, dtype=dtype).requires_grad_(False)


def voxtral_params_from_jax(tree, dims: VoxtralDims, dtype=None, device="cpu") -> Voxtral:
    """The JAX pytree ({"audio": a whisper encoder tree, "proj": {w1, w2},
    "text"}, numpy leaves) as a ``Voxtral`` module; ``dtype`` None keeps
    the leaves' dtype."""
    model = Voxtral(dims)

    def arr(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True))

    def put_dense(mod: Dense, p, i) -> None:
        mod.weight.data = arr(np.asarray(p["w"])[i].T)
        if mod.bias is not None:
            mod.bias.data = arr(np.asarray(p["b"])[i])

    def put_ln(mod, p, i=None) -> None:
        sel = (lambda a: a) if i is None else (lambda a: np.asarray(a)[i])  # noqa: E731
        mod.scale.data, mod.bias.data = arr(sel(p["scale"])), arr(sel(p["bias"]))

    au = tree["audio"]
    for conv in ("conv1", "conv2"):
        getattr(model.audio, conv).weight.data = arr(au[conv]["w"])
        getattr(model.audio, conv).bias.data = arr(au[conv]["b"])
    bp = au["blocks"]
    for i, blk in enumerate(model.audio.blocks):
        put_ln(blk.attn_ln, bp["attn_ln"], i)
        for name in ("q", "k", "v", "o"):
            put_dense(getattr(blk.attn, name), bp["attn"][name], i)
        put_ln(blk.mlp_ln, bp["mlp_ln"], i)
        put_dense(blk.fc1, bp["mlp"]["fc1"], i)
        put_dense(blk.fc2, bp["mlp"]["fc2"], i)
    put_ln(model.audio.ln_post, au["ln_post"])
    model.proj1.weight.data = arr(np.asarray(tree["proj"]["w1"]).T)
    model.proj2.weight.data = arr(np.asarray(tree["proj"]["w2"]).T)
    model.text = lm.llama_params_from_jax(tree["text"], dims.text)
    model = model.to(device)
    return (model.to(dtype) if dtype is not None else model).requires_grad_(False)


def convert_hf_state_dict(sd: Dict[str, torch.Tensor], dims: VoxtralDims, dtype=torch.float32,
                          device="cpu") -> Voxtral:
    """VoxtralForConditionalGeneration state dict → ``Voxtral``."""
    model = Voxtral(dims, lm_head=False)

    def take(name) -> torch.Tensor:
        return sd[name].to(device=device, dtype=dtype)

    def lin(mod: Dense, prefix: str) -> None:
        mod.weight.data = take(f"{prefix}.weight")
        if mod.bias is not None:
            mod.bias.data = (take(f"{prefix}.bias") if f"{prefix}.bias" in sd
                             else torch.zeros(mod.bias.shape, dtype=dtype, device=device))

    def ln(mod, prefix: str) -> None:
        mod.scale.data, mod.bias.data = take(f"{prefix}.weight"), take(f"{prefix}.bias")

    au = model.audio
    for conv in ("conv1", "conv2"):
        getattr(au, conv).weight.data = take(f"audio_tower.{conv}.weight")
        getattr(au, conv).bias.data = take(f"audio_tower.{conv}.bias")
    for i, blk in enumerate(au.blocks):
        p = f"audio_tower.layers.{i}"
        ln(blk.attn_ln, f"{p}.self_attn_layer_norm")
        for name, key in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            lin(getattr(blk.attn, name), f"{p}.self_attn.{key}")
        ln(blk.mlp_ln, f"{p}.final_layer_norm")
        lin(blk.fc1, f"{p}.fc1")
        lin(blk.fc2, f"{p}.fc2")
    ln(au.ln_post, "audio_tower.layer_norm")
    au.pos = au.pos.to(device)
    model.proj1.weight.data = take("multi_modal_projector.linear_1.weight")
    model.proj2.weight.data = take("multi_modal_projector.linear_2.weight")
    model.text = lm.convert_hf_state_dict(sd, dims.text, dtype, prefix="language_model.model.", device=device)
    return model.requires_grad_(False)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def audio_features(model: Voxtral, mel: torch.Tensor, dims: VoxtralDims) -> torch.Tensor:
    """mel [B, n_mels, 2*n_audio_ctx] → audio embeds [B, T_audio, D_text]."""
    enc = wm.encode(SimpleNamespace(encoder=model.audio), mel, dims.audio)  # [B, 1500, D]
    B, T, D = enc.shape
    grouped = enc.reshape(B, T // dims.downsample, dims.downsample * D)
    h = F.gelu(_linear_f32(grouped, model.proj1.weight))
    h = _linear_f32(h.to(enc.dtype), model.proj2.weight)
    return h.to(enc.dtype)


def splice_audio(model: Voxtral, tokens: torch.Tensor, audio_embeds: torch.Tensor,
                 audio_token_id: int) -> torch.Tensor:
    """Token embeddings with audio placeholder positions replaced in order."""
    tok_emb = lm.embed_tokens(model.text, tokens)  # [B,S,D]
    mask = tokens == audio_token_id
    order = torch.cumsum(mask.long(), dim=1) - 1  # audio index per position
    order = torch.clamp(order, 0, audio_embeds.shape[1] - 1)
    gathered = torch.gather(audio_embeds, 1, order[:, :, None].expand(-1, -1, audio_embeds.shape[2]))
    return torch.where(mask[:, :, None], gathered.to(tok_emb.dtype), tok_emb)


def forward(
    model: Voxtral,
    tokens: torch.Tensor,     # [B,S] with audio placeholders
    mel: torch.Tensor,        # [B, n_mels, 3000]
    pos: torch.Tensor,        # [B]
    cache: lm.LlamaCache,
    dims: VoxtralDims,
    last_only: bool = False,
) -> Tuple[torch.Tensor, lm.LlamaCache]:
    a = audio_features(model, mel, dims)
    embeds = splice_audio(model, tokens, a, dims.audio_token_id)
    return lm.forward(model.text, embeds, pos, cache, dims.text, last_only=last_only)


@torch.no_grad()
def greedy_generate(
    model: Voxtral,
    tokens: torch.Tensor,   # [B,S] prompt incl. audio placeholders
    mel: torch.Tensor,
    eos: int,
    dims: VoxtralDims,
    max_new: int,
) -> torch.Tensor:
    """-> [B, max_new] tokens: the first from the prefill, then greedy steps,
    ``eos`` after each lane's end. Stops once every lane is done."""
    B, S = tokens.shape
    dev = tokens.device
    cache = lm.init_cache(dims.text, B, S + max_new, dtype=model.dtype, device=dev)
    logits, cache = forward(model, tokens, mel, torch.zeros(B, dtype=torch.long, device=dev), cache, dims,
                            last_only=True)
    tok = torch.argmax(logits[:, -1], dim=-1)
    out = torch.full((B, max_new), eos, dtype=torch.long, device=dev)
    out[:, 0] = tok
    done = tok == eos
    eos_t = torch.full_like(tok, eos)
    for k in range(max_new - 1):
        if bool(done.all()):
            break
        lg, cache = lm.forward(model.text, lm.embed_tokens(model.text, tok[:, None]),
                               torch.full((B,), S + k, dtype=torch.long, device=dev), cache, dims.text)
        nxt = torch.where(done, eos_t, torch.argmax(lg[:, 0], dim=-1))
        done = done | (nxt == eos)
        out[:, k + 1] = nxt
        tok = nxt
    return out

