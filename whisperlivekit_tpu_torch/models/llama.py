"""Llama-family decoder in PyTorch (port of whisperlivekit_tpu/models/llama.py):
RMSNorm, RoPE, GQA, SiLU MLP, and Qwen3's optional per-head q/k norms.

The text tower of Qwen3-ASR and Voxtral. As in models/whisper/model.py, the
weights live in ``nn.Module``s and the forward pass is a function with the
JAX module's name and layouts: ``LlamaCache`` [L, B, T, KV, Dh] with
per-lane positions, written IN PLACE by ``forward`` (JAX returns a new
cache). Dense weights are stored [out, in] (``F.linear``'s layout, the HF
checkpoint's); ``llama_params_from_jax`` converts the JAX pytree.

Precision follows JAX's ``preferred_element_type=f32``: every product sums
in f32 and rounds once to the activations' dtype; norms, RoPE and the
softmax run in f32. On the card a dense is one ``F.linear`` (cuBLAS sums
in f32) and an RMSNorm one ``F.rms_norm`` in f32, which keeps a decode
step's launches down; elsewhere the JAX formulas run, for the parity tests.

GQA: query head h reads KV head ``h // (n_heads // n_kv_heads)``, as JAX's
``jnp.repeat(ck, h_rep, axis=2)``; the port groups the query heads per KV
head instead of repeating the cache.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .whisper.model import Dense, _linear_f32, dense


@dataclass(frozen=True)
class LlamaDims:
    vocab_size: int
    hidden_size: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    intermediate_size: int
    head_dim: int
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    max_positions: int = 8192
    tie_embeddings: bool = False
    qk_norm: bool = False  # Qwen3: per-head-dim RMSNorm on q/k before RoPE


# ---------------------------------------------------------------------------
# Modules (weights only; the forward pass is the function below)
# ---------------------------------------------------------------------------


class Layer(nn.Module):
    def __init__(self, dims: LlamaDims):
        super().__init__()
        d, h, kv, dh = dims.hidden_size, dims.n_heads, dims.n_kv_heads, dims.head_dim
        self.attn_norm = nn.Parameter(torch.ones(d))
        self.wq = Dense(d, h * dh, bias=False)
        self.wk = Dense(d, kv * dh, bias=False)
        self.wv = Dense(d, kv * dh, bias=False)
        self.wo = Dense(h * dh, d, bias=False)
        self.q_norm = nn.Parameter(torch.ones(dh)) if dims.qk_norm else None
        self.k_norm = nn.Parameter(torch.ones(dh)) if dims.qk_norm else None
        self.mlp_norm = nn.Parameter(torch.ones(d))
        self.w_gate = Dense(d, dims.intermediate_size, bias=False)
        self.w_up = Dense(d, dims.intermediate_size, bias=False)
        self.w_down = Dense(dims.intermediate_size, d, bias=False)


class Llama(nn.Module):
    """``lm_head`` is None when the output projection is the token embedding
    (tied, or absent from the checkpoint, as in JAX)."""

    def __init__(self, dims: LlamaDims, lm_head: bool = True):
        super().__init__()
        self.dims = dims
        self.tok_emb = nn.Parameter(torch.empty(dims.vocab_size, dims.hidden_size))
        self.blocks = nn.ModuleList(Layer(dims) for _ in range(dims.n_layers))
        self.norm = nn.Parameter(torch.ones(dims.hidden_size))
        self.lm_head = Dense(dims.hidden_size, dims.vocab_size, bias=False) if lm_head else None

    @property
    def dtype(self) -> torch.dtype:
        return self.tok_emb.dtype

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device


def init_params(dims: LlamaDims, generator: torch.Generator, dtype=torch.float32, device="cpu") -> Llama:
    """Random weights with JAX ``init_params``' shapes and scales (dense
    N(0, 1/d_in), embedding N(0, 0.02^2), unit norms); drawn on the
    generator's device, so a card generator fills full-width weights fast.
    The numbers differ from ``PRNGKey``'s."""
    model = Llama(dims, lm_head=not dims.tie_embeddings)
    gdev = generator.device
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Dense):
                mod.weight.data = torch.randn(mod.weight.shape, generator=generator, device=gdev) \
                    * mod.weight.shape[1] ** -0.5
        model.tok_emb.data = torch.randn(model.tok_emb.shape, generator=generator, device=gdev) * 0.02
    return model.to(device=device, dtype=dtype).requires_grad_(False)


def llama_params_from_jax(tree, dims: LlamaDims, dtype=None, device="cpu") -> Llama:
    """The JAX pytree (numpy leaves: stacked [L, ...] blocks, [in, out]
    dense weights) as a ``Llama`` module; ``dtype`` None keeps the leaves'."""
    model = Llama(dims, lm_head="lm_head" in tree)

    def arr(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True))

    bp = tree["blocks"]
    for i, blk in enumerate(model.blocks):
        for name in ("attn_norm", "mlp_norm") + (("q_norm", "k_norm") if dims.qk_norm else ()):
            getattr(blk, name).data = arr(np.asarray(bp[name])[i])
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            getattr(blk, name).weight.data = arr(np.asarray(bp[name])[i].T)
    model.tok_emb.data = arr(tree["tok_emb"])
    model.norm.data = arr(tree["norm"])
    if model.lm_head is not None:
        model.lm_head.weight.data = arr(np.asarray(tree["lm_head"]).T)
    model = model.to(device)
    return (model.to(dtype) if dtype is not None else model).requires_grad_(False)


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------


def _dense(x: torch.Tensor, p: Dense) -> torch.Tensor:
    """x @ w (+ b), an f32 sum rounded once to x's dtype: one ``F.linear``
    on the card, the port's widened ``dense`` elsewhere."""
    if x.is_cuda:
        return F.linear(x, p.weight, p.bias)
    return dense(x, p)


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    if x.is_cuda:
        return F.rms_norm(x.float(), x.shape[-1:], w.float(), eps).to(x.dtype)
    xf = x.float()
    out = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (out * w.float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _inv_freq(dh: int, theta: float) -> torch.Tensor:
    """RoPE's inverse frequencies computed in f32 as JAX does
    (``1 / theta ** (arange(0, dh, 2) / dh)``), once, on the CPU: the card
    and the CPU then rotate by the same values."""
    return 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32) / dh))


def rope_tables(positions: torch.Tensor, dh: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos, sin [B, S, 1, Dh/2] in f32 for positions [B, S] (shared by every
    layer, q and k)."""
    inv = _inv_freq(dh, float(theta)).to(positions.device)
    ang = positions.float()[:, :, None] * inv[None, None, :]
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B,S,H,Dh] — HF llama convention (half-split), in f32."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """q [B,S,H,Dh], k/v [B,T,KV,Dh], additive f32 mask [B,S,T] ->
    [B,S,H,Dh] in v's dtype. Query head h reads KV head h // (H // KV)
    (JAX's ``repeat`` along heads). Both products widen their operands
    (exact products, f32 sums) and the softmax runs in f32."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    R = H // KV
    qg = q.reshape(B, S, KV, R, dh).permute(0, 2, 3, 1, 4).reshape(B, KV, R * S, dh)
    scores = torch.matmul(qg.float(), k.permute(0, 2, 3, 1).float())  # [B,KV,R*S,T]
    scores = scores.reshape(B, KV, R, S, -1) * (dh ** -0.5) + mask[:, None, None]
    probs = torch.softmax(scores, dim=-1).to(v.dtype).reshape(B, KV, R * S, -1)
    out = torch.matmul(probs.float(), v.transpose(1, 2).float())     # [B,KV,R*S,Dh]
    return out.reshape(B, KV, R, S, dh).permute(0, 3, 1, 2, 4).reshape(B, S, H, dh).to(v.dtype)


class LlamaCache(NamedTuple):
    k: torch.Tensor  # [L, B, T, KV, Dh], written in place by forward
    v: torch.Tensor


def init_cache(dims: LlamaDims, batch: int, max_len: int, dtype=torch.float32, device="cpu") -> LlamaCache:
    shape = (dims.n_layers, batch, max_len, dims.n_kv_heads, dims.head_dim)
    return LlamaCache(torch.zeros(shape, dtype=dtype, device=device),
                      torch.zeros(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def forward(
    model: Llama,
    embeds: torch.Tensor,  # [B, S, D] input embeddings (post token/audio splice)
    pos: torch.Tensor,     # [B] cache fill per lane
    cache: LlamaCache,
    dims: LlamaDims,
    last_only: bool = False,
) -> Tuple[torch.Tensor, LlamaCache]:
    """Returns (logits [B,S,V] f32, cache), the cache written in place at rows
    ``pos + arange(S)`` (clamped to its length, as JAX). ``last_only``
    computes the logits of the last position only ([B,1,V]), for callers
    that read no others."""
    B, S, _ = embeds.shape
    T_ctx = cache.k.shape[2]
    dev = embeds.device
    positions = pos.long()[:, None] + torch.arange(S, device=dev)[None, :]
    write_pos = torch.clamp(positions, max=T_ctx - 1)
    key_idx = torch.arange(T_ctx, device=dev)[None, None, :]
    mask = torch.zeros((B, S, T_ctx), dtype=torch.float32, device=dev).masked_fill(
        key_idx > positions[:, :, None], float("-inf"))
    batch_idx = torch.arange(B, device=dev)[:, None]
    cos, sin = rope_tables(positions, dims.head_dim, dims.rope_theta)

    x = embeds
    for li, bp in enumerate(model.blocks):
        ck, cv = cache.k[li], cache.v[li]
        h = _rms_norm(x, bp.attn_norm, dims.rms_eps)
        q = _dense(h, bp.wq).reshape(B, S, dims.n_heads, dims.head_dim)
        k = _dense(h, bp.wk).reshape(B, S, dims.n_kv_heads, dims.head_dim)
        v = _dense(h, bp.wv).reshape(B, S, dims.n_kv_heads, dims.head_dim)
        if bp.q_norm is not None:
            q = _rms_norm(q, bp.q_norm, dims.rms_eps)
            k = _rms_norm(k, bp.k_norm, dims.rms_eps)
        q = _rope(q, cos, sin)
        ck[batch_idx, write_pos] = _rope(k, cos, sin).to(ck.dtype)
        cv[batch_idx, write_pos] = v.to(cv.dtype)
        attn = gqa_attend(q, ck, cv, mask).to(x.dtype)
        x = x + _dense(attn.reshape(B, S, dims.n_heads * dims.head_dim), bp.wo)

        h = _rms_norm(x, bp.mlp_norm, dims.rms_eps)
        gate = F.silu(_linear_f32(h, bp.w_gate.weight))
        up = _linear_f32(h, bp.w_up.weight)
        x = x + _dense((gate * up).to(x.dtype), bp.w_down)
    if last_only:
        x = x[:, -1:]
    x = _rms_norm(x, model.norm, dims.rms_eps)
    head = model.lm_head.weight if model.lm_head is not None else model.tok_emb
    return _linear_f32(x, head.to(x.dtype)), cache


def embed_tokens(model: Llama, tokens: torch.Tensor) -> torch.Tensor:
    return model.tok_emb[tokens]


# ---------------------------------------------------------------------------
# HF checkpoints
# ---------------------------------------------------------------------------


def dims_from_hf_config(cfg: dict) -> LlamaDims:
    return LlamaDims(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
        intermediate_size=cfg["intermediate_size"],
        head_dim=cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"],
        rope_theta=cfg.get("rope_theta", 10000.0),
        rms_eps=cfg.get("rms_norm_eps", 1e-5),
        max_positions=cfg.get("max_position_embeddings", 8192),
        tie_embeddings=cfg.get("tie_word_embeddings", False),
    )


def convert_hf_state_dict(
    sd: Dict[str, torch.Tensor],
    dims: LlamaDims,
    dtype=torch.float32,
    prefix: str = "model.",
    lm_head_key: Optional[str] = None,
    device="cpu",
) -> Llama:
    """HF LlamaForCausalLM / Qwen3ForCausalLM state dict -> ``Llama``. HF
    linears are [out, in] already; the q/k norms are read when
    ``dims.qk_norm``."""
    if lm_head_key is None:
        # "model." -> "lm_head.weight"; "language_model.model." -> "language_model.lm_head.weight"
        lm_head_key = prefix[: -len("model.")] + "lm_head.weight"
    model = Llama(dims, lm_head=lm_head_key in sd and not dims.tie_embeddings)

    def put(param: torch.Tensor, name: str) -> None:
        param.data = sd[name].to(device=device, dtype=dtype)

    for i, blk in enumerate(model.blocks):
        p = f"{prefix}layers.{i}."
        if dims.qk_norm:
            put(blk.q_norm, p + "self_attn.q_norm.weight")
            put(blk.k_norm, p + "self_attn.k_norm.weight")
        put(blk.attn_norm, p + "input_layernorm.weight")
        for name, key in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"), ("wo", "o_proj")):
            put(getattr(blk, name).weight, f"{p}self_attn.{key}.weight")
        put(blk.mlp_norm, p + "post_attention_layernorm.weight")
        for name, key in (("w_gate", "gate_proj"), ("w_up", "up_proj"), ("w_down", "down_proj")):
            put(getattr(blk, name).weight, f"{p}mlp.{key}.weight")
    put(model.tok_emb, f"{prefix}embed_tokens.weight")
    put(model.norm, f"{prefix}norm.weight")
    if model.lm_head is not None:
        put(model.lm_head.weight, lm_head_key)
    return model.requires_grad_(False)
