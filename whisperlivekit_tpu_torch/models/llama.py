"""Llama-family decoder in PyTorch (port of whisperlivekit_tpu/models/llama.py):
RMSNorm, RoPE, GQA, SiLU MLP, and Qwen3's optional per-head q/k norms; also
Qwen2's q/k/v biases and a dynamic mixture of experts in the FFN
(Uni-MoE-2.0-Omni's, which the JAX package has no twin of).

The text tower of Qwen3-ASR, Voxtral and Uni-MoE-2.0-Omni. As in
models/whisper/model.py, the weights live in ``nn.Module``s and the forward
pass is a function with the JAX module's name and layouts: ``LlamaCache`` [L, B, T, KV, Dh] with
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

The expert layer (``MoEDims``, in every layer): with
h the RMSNorm of x, ``p = softmax(W_r h)`` in f32 over the routed experts
and the null experts; ``route`` takes outputs in order of ``p`` (ties to
the lower index) while the mass already taken is under ``moe_top_p``, at
most ``moe_top_k`` of them; the FFN is ``sum_shared SwiGLU_s(h) + sum_{e
chosen} p_e SwiGLU_e(h)``, a null expert adding nothing. Every routed
expert runs on every row and an unchosen one is weighted by exactly 0 (so
it adds exactly nothing): the dispatch needs no row counts on the host,
and at a decode step's rows the expert weights are read whole anyway.
``forward`` adds the routing's counts into the model's device accumulator
(``moe_counts``); ``moe.calls`` and ``moe.rows`` go to the tracer at once.
No shape of a forward depends on the data and it reads nothing back to the
host, so a CUDA graph can hold one (``streaming/qwen3_batch.py``
``DecodeGraphs``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..engine.trace import TRACER
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

    # what ``MoEDims`` sets (class attributes here, not fields: a dense
    # model's dims hold the JAX package's fields and no others)
    qkv_bias = False
    n_routed_experts = n_null_experts = n_shared_experts = shared_expert_size = moe_top_k = 0
    moe_top_p = 1.0

    @property
    def moe(self) -> bool:
        return self.n_routed_experts > 0


@dataclass(frozen=True)
class MoEDims(LlamaDims):
    """Qwen2's text tower with a dynamic mixture of experts in every layer's
    FFN (Uni-MoE-2.0-Omni): routed SwiGLU experts ``intermediate_size``
    wide, router outputs that choose no expert, shared SwiGLU experts
    ``shared_expert_size`` wide on every row."""

    qkv_bias: bool = True  # biases on the q, k and v projections
    n_routed_experts: int = 4
    n_null_experts: int = 1
    n_shared_experts: int = 2
    shared_expert_size: int = 0
    moe_top_p: float = 0.7
    moe_top_k: int = 2


# ---------------------------------------------------------------------------
# Modules (weights only; the forward pass is the function below)
# ---------------------------------------------------------------------------


class Experts(nn.Module):
    """The expert layer's weights: ``router`` [E + N0, d]; each stack holds
    one expert per leading index, [X, ff, d]: gate and up in ``F.linear``'s
    [out, in] layout, down as the [in, out] matrix that a row multiplies
    (``x @ down[e]``), so the experts of a stack run as one product each
    (``stack.reshape(X * ff, d)`` is a view). The stacks start on the meta
    device and are given their tensors by ``init_params`` or a loader: at
    full size they are most of the model and must exist once."""

    def __init__(self, dims: LlamaDims):
        super().__init__()
        d = dims.hidden_size
        self.router = Dense(d, dims.n_routed_experts + dims.n_null_experts, bias=False)
        for prefix, n, ff in (("", dims.n_routed_experts, dims.intermediate_size),
                              ("shared_", dims.n_shared_experts, dims.shared_expert_size)):
            for name in ("gate", "up", "down"):
                setattr(self, prefix + name, nn.Parameter(torch.empty(n, ff, d, device="meta")))

    def put(self, name: str, tensor: torch.Tensor) -> None:
        """Give a stack its tensor, held as it is (a meta parameter takes no
        ``.data``)."""
        old = getattr(self, name)
        if tuple(tensor.shape) != tuple(old.shape):
            raise ValueError(f"expert stack {name}: shape {tuple(tensor.shape)}, expected {tuple(old.shape)}")
        setattr(self, name, nn.Parameter(tensor, requires_grad=False))


class Layer(nn.Module):
    def __init__(self, dims: LlamaDims):
        super().__init__()
        d, h, kv, dh = dims.hidden_size, dims.n_heads, dims.n_kv_heads, dims.head_dim
        self.attn_norm = nn.Parameter(torch.ones(d))
        self.wq = Dense(d, h * dh, bias=dims.qkv_bias)
        self.wk = Dense(d, kv * dh, bias=dims.qkv_bias)
        self.wv = Dense(d, kv * dh, bias=dims.qkv_bias)
        self.wo = Dense(h * dh, d, bias=False)
        self.q_norm = nn.Parameter(torch.ones(dh)) if dims.qk_norm else None
        self.k_norm = nn.Parameter(torch.ones(dh)) if dims.qk_norm else None
        self.mlp_norm = nn.Parameter(torch.ones(d))
        self.experts = Experts(dims) if dims.moe else None
        ff = dims.intermediate_size
        self.w_gate = None if dims.moe else Dense(d, ff, bias=False)
        self.w_up = None if dims.moe else Dense(d, ff, bias=False)
        self.w_down = None if dims.moe else Dense(ff, d, bias=False)


class Llama(nn.Module):
    """``lm_head`` is None when the output projection is the token embedding
    (tied, or absent from the checkpoint, as in JAX). ``moe_counts`` holds
    the expert layers' device accumulator (the function ``moe_counts``),
    made at the first forward that routes."""

    def __init__(self, dims: LlamaDims, lm_head: bool = True):
        super().__init__()
        self.dims = dims
        self.moe_counts: Optional[torch.Tensor] = None
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
    N(0, 1/d_in), embedding N(0, 0.02^2), unit norms, zero biases; each
    expert's matrices N(0, 1/d_in) too); drawn on the generator's device, so
    a card generator fills full-width weights fast, and each cast to
    ``dtype`` as it is drawn, so a full-size model is never held in f32.
    The numbers differ from ``PRNGKey``'s."""
    model = Llama(dims, lm_head=not dims.tie_embeddings)
    gdev = generator.device

    def draw(shape, fan_in: int, scale: float = 1.0) -> torch.Tensor:
        return (torch.randn(shape, generator=generator, device=gdev) * (scale * fan_in ** -0.5)).to(
            device=device, dtype=dtype)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Dense):
                mod.weight.data = draw(mod.weight.shape, mod.weight.shape[1])
        model.tok_emb.data = draw(model.tok_emb.shape, 1, 0.02)
        for mod in model.modules():
            if isinstance(mod, Experts):
                for name, p in list(mod.named_parameters(recurse=False)):
                    mod.put(name, draw(p.shape, p.shape[1] if name.endswith("down") else p.shape[2]))
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


@functools.lru_cache(maxsize=None)
def _inv_freq_on(dh: int, theta: float, device: torch.device) -> torch.Tensor:
    """``_inv_freq`` copied once to ``device``: a step then makes no copy
    from the host, which a CUDA graph's capture cannot hold."""
    return _inv_freq(dh, theta).to(device)


def rope_tables(positions: torch.Tensor, dh: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos, sin [B, S, 1, Dh/2] in f32 for positions [B, S] (shared by every
    layer, q and k)."""
    inv = _inv_freq_on(dh, float(theta), positions.device)
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
# The expert layer
# ---------------------------------------------------------------------------


def route(h: torch.Tensor, router: Dense, dims: LlamaDims) -> Tuple[torch.Tensor, torch.Tensor]:
    """h [N, d] -> (p [N, E + N0] f32, chosen [N, E + N0] bool). The router
    runs in f32 (``fp32_gate``); the outputs are taken in order of ``p``,
    ties to the lower index (a stable sort), while the mass of those
    already taken is under ``moe_top_p``, at most ``moe_top_k``. A null
    output counts in both and adds nothing."""
    p = torch.softmax(F.linear(h.float(), router.weight.float()), dim=-1)
    ps, order = torch.sort(p, dim=-1, descending=True, stable=True)
    ahead = F.pad(torch.cumsum(ps[:, :-1], dim=-1), (1, 0))  # mass taken before each rank
    rank = torch.arange(p.shape[-1], device=p.device)
    keep = (rank < dims.moe_top_k) & (ahead < dims.moe_top_p)
    return p, torch.zeros_like(keep).scatter_(-1, order, keep)


def _swiglu_sum(h: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
                w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sum over a stack's X experts of ``w[:, e] * SwiGLU_e(h)`` (``w``
    None: weight 1), h [N, d] -> [N, d] f32. Gate and up run as one product
    each over every expert ([N, X * ff]); the weighted activations round
    once to h's dtype and the down products of all X sum in one f32 product."""
    X, ff, d = gate.shape
    act = F.silu(_linear_f32(h, gate.reshape(X * ff, d))) * _linear_f32(h, up.reshape(X * ff, d))
    if w is not None:
        act = (act.view(-1, X, ff) * w[:, :, None]).view(-1, X * ff)
    return _linear_f32(act.to(h.dtype), down.reshape(X * ff, d).t())


def moe_counts(model: "Llama", device) -> torch.Tensor:
    """The model's routing accumulator on ``device``, [2, E + N0] int64: row
    0 the rows each router output took, row 1 the expert-layer calls in
    which it took at least one. Every forward adds to it on the device; the
    reader copies it with a host read it makes anyway, then zeroes it."""
    acc = model.moe_counts
    if acc is None or acc.device != torch.device(device):
        d = model.dims
        acc = model.moe_counts = torch.zeros((2, d.n_routed_experts + d.n_null_experts),
                                             dtype=torch.long, device=device)
    return acc


def moe_ffn(h: torch.Tensor, ex: Experts, dims: LlamaDims, counts: torch.Tensor) -> torch.Tensor:
    """The expert layer on h [N, d] (the FFN's normed input) -> [N, d] in h's
    dtype: the shared experts' sum plus each chosen routed expert weighted
    by its router probability. Every routed expert runs on every row; an
    unchosen one is weighted by 0, which is exact. ``counts`` gets the
    call's routing (``moe_counts``)."""
    p, chosen = route(h, ex.router, dims)
    E = dims.n_routed_experts
    y = _swiglu_sum(h, ex.gate, ex.up, ex.down, torch.where(chosen[:, :E], p[:, :E], 0.0))
    if dims.n_shared_experts:
        y = y + _swiglu_sum(h, ex.shared_gate, ex.shared_up, ex.shared_down)
    took = chosen.sum(0)
    counts[0].add_(took)
    counts[1].add_(took.clamp_(max=1))
    return y.to(h.dtype)


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
    lanes: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, LlamaCache]:
    """Returns (logits [B,S,V] f32, cache), the cache written in place at rows
    ``pos + arange(S)`` (clamped to its length, as JAX). ``last_only``
    computes the logits of the last position only ([B,1,V]), for callers
    that read no others.

    With ``lanes`` [B], ``cache`` is a lane pool [L, C, T, KV, Dh]: batch
    row b reads and writes pool row ``lanes[b]``, one layer at a time, so
    no copy of the batch's rows of the whole pool is made."""
    B, S, _ = embeds.shape
    T_ctx = cache.k.shape[2]
    dev = embeds.device
    positions = pos.long()[:, None] + torch.arange(S, device=dev)[None, :]
    write_pos = torch.clamp(positions, max=T_ctx - 1)
    key_idx = torch.arange(T_ctx, device=dev)[None, None, :]
    mask = torch.zeros((B, S, T_ctx), dtype=torch.float32, device=dev).masked_fill(
        key_idx > positions[:, :, None], float("-inf"))
    if lanes is None:
        write_rows = torch.arange(B, device=dev)[:, None]
    else:
        write_rows = lanes[:, None]
    cos, sin = rope_tables(positions, dims.head_dim, dims.rope_theta)
    if dims.moe:
        counts = moe_counts(model, dev)
        TRACER.count("moe.calls", dims.n_layers)
        TRACER.count("moe.rows", dims.n_layers * B * S)

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
        ck[write_rows, write_pos] = _rope(k, cos, sin).to(ck.dtype)
        cv[write_rows, write_pos] = v.to(cv.dtype)
        if lanes is not None:
            ck, cv = ck[lanes], cv[lanes]
        attn = gqa_attend(q, ck, cv, mask).to(x.dtype)
        x = x + _dense(attn.reshape(B, S, dims.n_heads * dims.head_dim), bp.wo)

        h = _rms_norm(x, bp.mlp_norm, dims.rms_eps)
        if bp.experts is not None:
            x = x + moe_ffn(h.reshape(B * S, -1), bp.experts, dims, counts).reshape(B, S, -1)
            continue
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
    ``dims.qk_norm``, the q/k/v biases when ``dims.qkv_bias``. An expert
    layer reads ``mlp.gate.weight`` (the router, routed outputs first, then
    the null ones) and the stacks ``mlp.experts.{gate,up,down}_proj`` and
    ``mlp.shared_experts.{gate,up,down}_proj`` in ``Experts``' layout.
    A tensor already on ``device`` in ``dtype`` is held as it is, not
    copied."""
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
            if getattr(blk, name).bias is not None:
                put(getattr(blk, name).bias, f"{p}self_attn.{key}.bias")
        put(blk.mlp_norm, p + "post_attention_layernorm.weight")
        if blk.experts is not None:
            put(blk.experts.router.weight, f"{p}mlp.gate.weight")
            for stack, attr in (("experts", ""), ("shared_experts", "shared_")):
                for proj in ("gate", "up", "down"):
                    blk.experts.put(attr + proj, sd[f"{p}mlp.{stack}.{proj}_proj"].to(device=device, dtype=dtype))
            continue
        for name, key in (("w_gate", "gate_proj"), ("w_up", "up_proj"), ("w_down", "down_proj")):
            put(getattr(blk, name).weight, f"{p}mlp.{key}.weight")
    put(model.tok_emb, f"{prefix}embed_tokens.weight")
    put(model.norm, f"{prefix}norm.weight")
    if model.lm_head is not None:
        put(model.lm_head.weight, lm_head_key)
    return model.requires_grad_(False)
