"""NLLB-200 (M2M100 architecture) encoder-decoder in PyTorch (port of
whisperlivekit_tpu/translation/nllb_model.py).

The in-process translation backend (role of the reference's external `nllw`
package, reference core.py:261-289 / translation.py:18-47). Architecture
facts (public NLLB/M2M100): pre-LN transformer, ReLU FFN, sinusoidal
positions with fairseq offset 2 (padding_idx 1), scaled embeddings
(sqrt d), tied input/output embeddings.

As in models/whisper/model.py, the weights live in ``nn.Module``s and the
forward passes are functions with the JAX module's names and layouts
(``encode``, ``cross_kv`` [L, B, S, H, Dh], ``decode`` with per-lane
``pos``; the ``NLLBCache`` [L, B, T, H, Dh] is written IN PLACE, where JAX
returns a new one). Dense weights are stored [out, in] (``F.linear``'s
layout, the HF checkpoint's); ``nllb_params_from_jax`` converts the JAX
pytree. ``_dense`` takes the operands in the weights' dtype and gives an
f32 result before its one rounding, as JAX's ``preferred_element_type``:
on the card one ``F.linear`` (cuBLAS accumulates in f32 and adds the bias
before it rounds), elsewhere the port's ``dense`` (widened operands, f32
bias, one cast). ``_layer_norm`` is ``F.layer_norm`` in f32 on the card and
JAX's formula elsewhere. Both keep a decoder step's launches down (it is
host-bound); the CPU parity tests run the JAX formulas.

``greedy_translate`` is a host loop over decoder steps that reads
``done.all()`` once per step, where the JAX package compiles one
``while_loop``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.whisper.model import Dense, LayerNorm, _linear_f32, dense, layer_norm


@dataclass(frozen=True)
class NLLBDims:
    vocab_size: int = 256206
    d_model: int = 1024
    encoder_layers: int = 12
    decoder_layers: int = 12
    heads: int = 16
    ffn_dim: int = 4096
    max_positions: int = 1024
    pad_token_id: int = 1

    @property
    def head_dim(self) -> int:
        return self.d_model // self.heads


NLLB_SIZES = {
    "600M": NLLBDims(),
    "1.3B": NLLBDims(encoder_layers=24, decoder_layers=24, ffn_dim=8192),
    "dev-tiny": NLLBDims(vocab_size=512, d_model=64, encoder_layers=2,
                         decoder_layers=2, heads=4, ffn_dim=128, max_positions=128),
}

HF_NLLB_REPOS = {
    "600M": "facebook/nllb-200-distilled-600M",
    "1.3B": "facebook/nllb-200-distilled-1.3B",
}


# ---------------------------------------------------------------------------
# Modules (weights only; the forward passes are the functions below)
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q, self.k, self.v, self.o = (Dense(d, d) for _ in range(4))


class Layer(nn.Module):
    def __init__(self, dims: NLLBDims, cross: bool):
        super().__init__()
        d = dims.d_model
        self.attn_ln = LayerNorm(d)
        self.attn = Attention(d)
        self.cross_ln = LayerNorm(d) if cross else None
        self.cross = Attention(d) if cross else None
        self.ffn_ln = LayerNorm(d)
        self.fc1 = Dense(d, dims.ffn_dim)
        self.fc2 = Dense(dims.ffn_dim, d)


class Stack(nn.Module):
    def __init__(self, dims: NLLBDims, n_layers: int, cross: bool):
        super().__init__()
        self.blocks = nn.ModuleList(Layer(dims, cross) for _ in range(n_layers))
        self.ln = LayerNorm(dims.d_model)


class NLLB(nn.Module):
    def __init__(self, dims: NLLBDims):
        super().__init__()
        self.dims = dims
        self.emb = nn.Parameter(torch.empty(dims.vocab_size, dims.d_model))
        self.encoder = Stack(dims, dims.encoder_layers, cross=False)
        self.decoder = Stack(dims, dims.decoder_layers, cross=True)
        self.register_buffer("pos_table", torch.from_numpy(sinusoidal_table(dims)), persistent=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.emb.dtype

    @property
    def device(self) -> torch.device:
        return self.emb.device


def init_params(dims: NLLBDims, seed: int = 0, dtype=torch.float32, device="cpu") -> NLLB:
    """Random weights from a seeded generator on ``device`` (JAX's
    ``init_params`` scales: dense N(0, 1/d_in), embedding N(0, 0.02^2);
    the numbers differ from ``PRNGKey``'s)."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    model = NLLB(dims)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name == "emb":
                p.data = torch.randn(p.shape, generator=g, device=device) * 0.02
            elif name.endswith("weight"):
                p.data = torch.randn(p.shape, generator=g, device=device) * p.shape[1] ** -0.5
            elif name.endswith("scale"):
                p.data = torch.ones(p.shape, device=device)
            else:
                p.data = torch.zeros(p.shape, device=device)
    return model.to(device=device, dtype=dtype).eval().requires_grad_(False)


def nllb_params_from_jax(tree, dims: NLLBDims, dtype=None, device="cpu") -> NLLB:
    """The JAX pytree (numpy leaves: stacked [L, ...] blocks, [in, out] dense
    weights) as an ``NLLB`` module; ``dtype`` None keeps the leaves' dtype."""
    model = NLLB(dims)

    def put(param: torch.Tensor, arr) -> None:
        param.data = torch.from_numpy(np.array(arr, copy=True))

    def put_dense(mod: Dense, p, i: int) -> None:
        put(mod.weight, np.asarray(p["w"][i]).T)
        put(mod.bias, p["b"][i])

    def put_ln(mod: LayerNorm, p, i=None) -> None:
        put(mod.scale, p["scale"] if i is None else p["scale"][i])
        put(mod.bias, p["bias"] if i is None else p["bias"][i])

    put(model.emb, tree["emb"])
    for stack, jt in ((model.encoder, tree["encoder"]), (model.decoder, tree["decoder"])):
        bp = jt["blocks"]
        for i, blk in enumerate(stack.blocks):
            for name in ("attn", "cross"):
                if getattr(blk, name) is None:
                    continue
                put_ln(getattr(blk, f"{name}_ln"), bp[f"{name}_ln"], i)
                for proj in "qkvo":
                    put_dense(getattr(getattr(blk, name), proj), bp[name][proj], i)
            put_ln(blk.ffn_ln, bp["ffn_ln"], i)
            put_dense(blk.fc1, bp["fc1"], i)
            put_dense(blk.fc2, bp["fc2"], i)
        put_ln(stack.ln, jt["ln"])
    model = model.to(device)
    return (model.to(dtype) if dtype is not None else model).eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------


def _dense(x: torch.Tensor, p: Dense) -> torch.Tensor:
    if x.is_cuda:
        return F.linear(x, p.weight, p.bias)
    return dense(x, p)


def _layer_norm(x: torch.Tensor, p: LayerNorm, eps: float = 1e-5) -> torch.Tensor:
    if x.is_cuda:
        return F.layer_norm(x.float(), x.shape[-1:], p.scale.float(), p.bias.float(), eps).to(x.dtype)
    return layer_norm(x, p, eps)


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, h, d // h)


def _merge(x: torch.Tensor) -> torch.Tensor:
    b, s, h, dh = x.shape
    return x.reshape(b, s, h * dh)


def _attend(q, k, v, mask=None):
    """q [B,S,H,Dh], k/v [B,T,H,Dh], additive mask [B,S|1,T] -> [B,S,H,Dh]
    in v's dtype. Both products widen their operands (exact products, f32
    sums) and the softmax runs in f32, as JAX's ``preferred_element_type``."""
    dh = q.shape[-1]
    scores = torch.matmul(q.transpose(1, 2).float(), k.permute(0, 2, 3, 1).float()) * (dh ** -0.5)
    if mask is not None:
        scores = scores + mask[:, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.transpose(1, 2).float())
    return out.transpose(1, 2).to(v.dtype)


def sinusoidal_table(dims: NLLBDims) -> np.ndarray:
    """fairseq/M2M100 sinusoidal embedding table with padding_idx zeroed."""
    n_pos = dims.max_positions + 2
    d = dims.d_model
    half = d // 2
    emb = math.log(10000) / (half - 1)
    freq = np.exp(np.arange(half) * -emb)
    pos = np.arange(n_pos)[:, None] * freq[None, :]
    table = np.concatenate([np.sin(pos), np.cos(pos)], axis=1).astype(np.float32)
    if d % 2 == 1:
        table = np.concatenate([table, np.zeros((n_pos, 1), np.float32)], axis=1)
    table[dims.pad_token_id] = 0.0
    return table


def _embed(model: NLLB, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    x = model.emb[tokens] * math.sqrt(model.dims.d_model)
    return x + model.pos_table[positions].to(x.dtype)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def encode(model: NLLB, tokens: torch.Tensor, dims: NLLBDims, pad_mask: Optional[torch.Tensor] = None):
    """tokens [B,S] -> features [B,S,D]. pad_mask [B,S] True=real."""
    # past the table (a source longer than max_positions) the row clamps, as
    # JAX's gather clamps an out-of-bounds index
    positions = torch.clamp(torch.arange(tokens.shape[1], device=tokens.device)[None, :] + 2,
                            max=model.pos_table.shape[0] - 1)
    x = _embed(model, tokens, positions)
    mask = None
    if pad_mask is not None:
        mask = torch.zeros(pad_mask.shape, dtype=torch.float32, device=x.device).masked_fill(
            ~pad_mask, float("-inf"))[:, None, :]
    for bp in model.encoder.blocks:
        h = _layer_norm(x, bp.attn_ln)
        q = _heads(_dense(h, bp.attn.q), dims.heads)
        k = _heads(_dense(h, bp.attn.k), dims.heads)
        v = _heads(_dense(h, bp.attn.v), dims.heads)
        x = x + _dense(_merge(_attend(q, k, v, mask)), bp.attn.o)
        h = _layer_norm(x, bp.ffn_ln)
        x = x + _dense(F.relu(_dense(h, bp.fc1)), bp.fc2)
    return _layer_norm(x, model.encoder.ln)


class NLLBCache(NamedTuple):
    k: torch.Tensor  # [L,B,T,H,Dh], written in place by decode
    v: torch.Tensor


def init_cache(dims: NLLBDims, batch: int, max_len: int, dtype=torch.float32, device="cpu") -> NLLBCache:
    shape = (dims.decoder_layers, batch, max_len, dims.heads, dims.head_dim)
    return NLLBCache(torch.zeros(shape, dtype=dtype, device=device),
                     torch.zeros(shape, dtype=dtype, device=device))


def cross_kv(model: NLLB, enc: torch.Tensor, dims: NLLBDims):
    """Per-layer cross-attention keys and values, [L, B, S, H, Dh] each."""
    ks = [_heads(_dense(enc, bp.cross.k), dims.heads) for bp in model.decoder.blocks]
    vs = [_heads(_dense(enc, bp.cross.v), dims.heads) for bp in model.decoder.blocks]
    return torch.stack(ks), torch.stack(vs)


def decode(
    model: NLLB,
    tokens: torch.Tensor,  # [B,S]
    pos: torch.Tensor,  # [B]
    xk,
    xv,
    cache: NLLBCache,
    dims: NLLBDims,
    enc_pad_mask: Optional[torch.Tensor] = None,
):
    """Decoder step(s) -> (logits [B,S,V] f32, cache), the cache written in
    place at rows ``pos + arange(S)`` (clipped to its length, as JAX)."""
    B, S = tokens.shape
    T_ctx = cache.k.shape[2]
    dev = tokens.device
    positions = pos[:, None] + torch.arange(S, dtype=pos.dtype, device=dev)[None, :]
    x = _embed(model, tokens, torch.clamp(positions + 2, max=model.pos_table.shape[0] - 1))

    key_idx = torch.arange(T_ctx, device=dev)[None, None, :]
    self_mask = torch.zeros((B, S, T_ctx), dtype=torch.float32, device=dev).masked_fill(
        key_idx > positions[:, :, None], float("-inf"))
    cross_mask = None
    if enc_pad_mask is not None:
        cross_mask = torch.zeros(enc_pad_mask.shape, dtype=torch.float32, device=dev).masked_fill(
            ~enc_pad_mask, float("-inf"))[:, None, :]
    batch_idx = torch.arange(B, device=dev)[:, None]
    write_pos = torch.clamp(positions, max=T_ctx - 1)

    for li, bp in enumerate(model.decoder.blocks):
        ck, cv = cache.k[li], cache.v[li]
        h = _layer_norm(x, bp.attn_ln)
        q = _heads(_dense(h, bp.attn.q), dims.heads)
        ck[batch_idx, write_pos] = _heads(_dense(h, bp.attn.k), dims.heads).to(ck.dtype)
        cv[batch_idx, write_pos] = _heads(_dense(h, bp.attn.v), dims.heads).to(cv.dtype)
        x = x + _dense(_merge(_attend(q, ck, cv, self_mask)), bp.attn.o)

        h = _layer_norm(x, bp.cross_ln)
        qx = _heads(_dense(h, bp.cross.q), dims.heads)
        x = x + _dense(_merge(_attend(qx, xk[li], xv[li], cross_mask)), bp.cross.o)

        h = _layer_norm(x, bp.ffn_ln)
        x = x + _dense(F.relu(_dense(h, bp.fc1)), bp.fc2)
    x = _layer_norm(x, model.decoder.ln)
    return _linear_f32(x, model.emb.to(x.dtype)), cache


# ---------------------------------------------------------------------------
# Greedy translate (a host loop of decoder steps)
# ---------------------------------------------------------------------------


@torch.no_grad()
def greedy_translate(
    model: NLLB,
    src_tokens: torch.Tensor,   # [B,S] right-padded with pad id
    src_mask: torch.Tensor,     # [B,S] bool
    bos: torch.Tensor,          # [B] forced first token (target lang id)
    eos: int,
    dims: NLLBDims,
    max_len: int,
) -> torch.Tensor:
    """-> [B, max_len] int tokens: the forced first token, then greedy
    argmax tokens, eos-filled after each lane's eos. One host read of
    ``done.all()`` per step ends the loop early."""
    B = src_tokens.shape[0]
    dev = src_tokens.device
    enc = encode(model, src_tokens, dims, pad_mask=src_mask)
    xk, xv = cross_kv(model, enc, dims)
    cache = init_cache(dims, B, max_len + 2, dtype=model.dtype, device=dev)

    # decoder_start = eos token (M2M100 convention), then the forced lang id
    start = torch.full((B, 1), eos, dtype=torch.long, device=dev)
    decode(model, start, torch.zeros(B, dtype=torch.long, device=dev), xk, xv, cache, dims, src_mask)
    tok = bos.to(device=dev, dtype=torch.long)
    out = torch.full((B, max_len), eos, dtype=torch.long, device=dev)
    out[:, 0] = tok
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for k in range(max_len - 1):
        logits, cache = decode(model, tok[:, None], torch.full((B,), k + 1, dtype=torch.long, device=dev),
                               xk, xv, cache, dims, src_mask)
        nxt = torch.argmax(logits[:, 0], dim=-1)
        nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
        done = done | (nxt == eos)
        out[:, k + 1] = nxt
        tok = nxt
        if bool(done.all()):
            break
    return out
