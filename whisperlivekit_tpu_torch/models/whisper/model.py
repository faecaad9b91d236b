"""Whisper encoder/decoder in PyTorch (port of whisperlivekit_tpu/models/whisper/model.py).

The weights live in ``nn.Module``s (per-layer blocks in ``nn.ModuleList``);
the forward passes are plain functions with the JAX module's names,
signatures and layouts, so the parity tests compare like with like:

- ``encode(model, mel, dims, pos_start)``: mel [B, n_mels, 2F] -> [B, F, D];
- ``cross_kv``: [L, B, T, H, Dh], or [L, B, H, Dh, T] when transposed;
- ``cross_kv_into_pool``: the transposed projection written layer by layer
  into a group pool [L, G, H, Dh, Tp] IN PLACE (JAX donates the pool);
- ``KVCache``: [L, B, W, H, Dh], written IN PLACE by ``decode`` (the JAX
  version returns a new cache; here the returned cache is the argument);
- ``decode``: per-lane ``pos``, ``align_reduce``, ``t_valid`` and
  ``positions_override`` as in JAX.

Dense weights are stored [out, in] (``F.linear``'s layout);
``params_from_jax_numpy`` converts the JAX pytree (stacked [L, ...] leaves,
[in, out] dense weights; ``quantize_decoder_f8``'s float8 ``{w, w_scale}``
too) into a ``Whisper`` module and ``params_to_jax_numpy`` goes back. The
flash kernel (ops/flash_encoder.py) runs when the tensors are on CUDA, where
the JAX module checks for the TPU backend; ``encode(..., flash=False)`` keeps
the differentiable path, as training needs (the kernel has no backward).
A ``Dense`` whose ``tp`` is set is one rank's tensor-parallel shard
(parallel/mesh.py): ``dense`` runs its collectives around the product.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.f8 import F8, F8_MAX, cast_to, to_e4m3fn, write_cast
from .dims import ModelDimensions


def _flash_attn_available(x: torch.Tensor, dh: int) -> bool:
    """Kernel preconditions: CUDA tensors and a supported head dim (the
    CUDA kernel masks ragged T itself, so no 128-alignment is needed)."""
    return x.is_cuda and dh in (64, 128)


# ---------------------------------------------------------------------------
# Modules (weights only; the forward passes are the functions below)
# ---------------------------------------------------------------------------


class Dense(nn.Module):
    """``weight`` [out, in] and ``bias``. The f8 form (``quantize_decoder_f8``)
    holds a float8_e4m3fn ``weight`` and its f32 per-output-channel
    ``w_scale``. A module-wide cast (``model.to(dtype=...)``) would widen the
    one and round the other, so it passes both by: they only follow the
    module between devices."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None
        self.register_buffer("w_scale", None)
        self.tp = None  # parallel.mesh.TPRole of a tensor-parallel shard

    def _apply(self, fn, recurse=True):
        if self.w_scale is None:
            return super()._apply(fn, recurse)
        w, scale = self.weight, self.w_scale
        self._parameters["weight"], self._buffers["w_scale"] = None, None
        try:
            super()._apply(fn, recurse)
        finally:
            dev = fn(torch.empty(0, device=w.device)).device
            self._parameters["weight"] = nn.Parameter(w.data.to(dev), requires_grad=False)
            self._buffers["w_scale"] = scale.to(dev)
        return self


class LayerNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))


class Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q = Dense(d, d)
        self.k = Dense(d, d, bias=False)
        self.v = Dense(d, d)
        self.o = Dense(d, d)


class Block(nn.Module):
    def __init__(self, d: int, cross: bool):
        super().__init__()
        self.attn_ln = LayerNorm(d)
        self.attn = Attention(d)
        self.cross_ln = LayerNorm(d) if cross else None
        self.cross = Attention(d) if cross else None
        self.mlp_ln = LayerNorm(d)
        self.fc1 = Dense(d, 4 * d)
        self.fc2 = Dense(4 * d, d)


class Conv(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, 3))  # OIH, as in JAX
        self.bias = nn.Parameter(torch.zeros(c_out))


class Encoder(nn.Module):
    def __init__(self, dims: ModelDimensions):
        super().__init__()
        d = dims.n_audio_state
        self.conv1 = Conv(dims.n_mels, d)
        self.conv2 = Conv(d, d)
        self.blocks = nn.ModuleList(Block(d, cross=False) for _ in range(dims.n_audio_layer))
        self.ln_post = LayerNorm(d)
        self.register_buffer(
            "pos", torch.from_numpy(sinusoids(dims.n_audio_ctx, d)), persistent=False
        )


class Decoder(nn.Module):
    def __init__(self, dims: ModelDimensions):
        super().__init__()
        d = dims.n_text_state
        self.tok_emb = nn.Parameter(torch.empty(dims.n_vocab, d))
        self.pos_emb = nn.Parameter(torch.zeros(dims.n_text_ctx, d))
        self.blocks = nn.ModuleList(Block(d, cross=True) for _ in range(dims.n_text_layer))
        self.ln = LayerNorm(d)


class Whisper(nn.Module):
    def __init__(self, dims: ModelDimensions):
        super().__init__()
        self.dims = dims
        self.encoder = Encoder(dims)
        self.decoder = Decoder(dims)

    @property
    def dtype(self) -> torch.dtype:
        return self.decoder.tok_emb.dtype

    @property
    def device(self) -> torch.device:
        return self.decoder.tok_emb.device


# ---------------------------------------------------------------------------
# Parameter initialization and the JAX bridge
# ---------------------------------------------------------------------------


def init_params(
    dims: ModelDimensions,
    generator: torch.Generator,
    dtype: torch.dtype = torch.float32,
    device="cpu",
) -> Whisper:
    """Random weights with the shapes and scales of the JAX ``init_params``
    (normal * d_in**-0.5 dense, normal * (3*C_in)**-0.5 conv, normal * 0.02
    token embedding, zero biases and position embedding, unit LN scales).
    The numbers differ from JAX's: ``torch.Generator`` is not ``PRNGKey``.
    The module is built and drawn on the generator's device, so a card
    generator fills full-width weights fast."""
    with torch.device(generator.device):
        model = Whisper(dims)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Dense):
                d_out, d_in = mod.weight.shape
                mod.weight.normal_(generator=generator).mul_(d_in ** -0.5)
            elif isinstance(mod, Conv):
                mod.weight.normal_(generator=generator).mul_((3 * mod.weight.shape[1]) ** -0.5)
        model.decoder.tok_emb.normal_(generator=generator).mul_(0.02)
    return model.to(device=device, dtype=dtype).requires_grad_(False)


def params_from_jax_numpy(tree, dims: ModelDimensions, dtype=None, device="cpu") -> Whisper:
    """Convert the JAX parameter pytree (leaves as numpy arrays) into a
    ``Whisper`` module: unstack the [L, ...] block leaves and transpose the
    [in, out] dense weights to [out, in]. Conv weights are already OIH."""
    model = Whisper(dims)

    def put(param: torch.Tensor, arr) -> None:
        param.data = torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))

    def put_dense(mod: Dense, p, layer: int) -> None:
        w = np.asarray(p["w"])
        if w.dtype.name == "float8_e4m3fn":  # quantize_decoder_f8's {w, w_scale}
            w8 = np.ascontiguousarray(w.view(np.uint8)[layer].T)
            mod.weight = nn.Parameter(torch.from_numpy(w8).view(F8), requires_grad=False)
            mod.w_scale = torch.from_numpy(np.array(p["w_scale"], np.float32)[layer])
        else:
            put(mod.weight, np.asarray(w, np.float32)[layer].T)
        if mod.bias is not None:
            put(mod.bias, np.asarray(p["b"], np.float32)[layer])

    def put_ln(mod: LayerNorm, p, layer=None) -> None:
        sel = (lambda a: np.asarray(a, np.float32)[layer]) if layer is not None else (lambda a: a)
        put(mod.scale, sel(p["scale"]))
        put(mod.bias, sel(p["bias"]))

    def put_block(blk: Block, bp, layer: int) -> None:
        put_ln(blk.attn_ln, bp["attn_ln"], layer)
        for name in ("q", "k", "v", "o"):
            put_dense(getattr(blk.attn, name), bp["attn"][name], layer)
        if blk.cross is not None:
            put_ln(blk.cross_ln, bp["cross_ln"], layer)
            for name in ("q", "k", "v", "o"):
                put_dense(getattr(blk.cross, name), bp["cross"][name], layer)
        put_ln(blk.mlp_ln, bp["mlp_ln"], layer)
        put_dense(blk.fc1, bp["mlp"]["fc1"], layer)
        put_dense(blk.fc2, bp["mlp"]["fc2"], layer)

    enc, dec = tree["encoder"], tree["decoder"]
    for conv in ("conv1", "conv2"):
        put(getattr(model.encoder, conv).weight, enc[conv]["w"])
        put(getattr(model.encoder, conv).bias, enc[conv]["b"])
    for i, blk in enumerate(model.encoder.blocks):
        put_block(blk, enc["blocks"], i)
    put_ln(model.encoder.ln_post, enc["ln_post"])
    put(model.decoder.tok_emb, dec["tok_emb"])
    put(model.decoder.pos_emb, dec["pos_emb"])
    for i, blk in enumerate(model.decoder.blocks):
        put_block(blk, dec["blocks"], i)
    put_ln(model.decoder.ln, dec["ln"])
    model = model.to(device=device)
    if dtype is not None:
        model = model.to(dtype=dtype)  # f8 weights and their scales keep theirs
    return model.requires_grad_(False)


def params_to_jax_numpy(model: Whisper, dims: ModelDimensions, grad: bool = False) -> dict:
    """The inverse of ``params_from_jax_numpy``: the JAX parameter pytree as
    float32 numpy arrays, block leaves stacked [L, ...] and dense weights
    transposed to [in, out]. With ``grad`` each leaf is the parameter's
    ``.grad`` (zeros where it has none), so gradients and updated weights
    compare with JAX's leaf by leaf. Exact: bfloat16 widens to float32
    without rounding. f8 weights are refused."""

    def get(param: torch.Tensor) -> np.ndarray:
        t = param.grad if grad else param
        if t is None:
            t = torch.zeros_like(param)
        if t.dtype == F8:
            raise ValueError("params_to_jax_numpy takes no f8 weights (quantize_decoder_f8)")
        return t.detach().to("cpu", torch.float32).numpy()

    def stack(blocks, fn) -> np.ndarray:
        return np.stack([fn(b) for b in blocks])

    def dense_p(blocks, path) -> dict:
        mod = lambda b: functools.reduce(getattr, path, b)  # noqa: E731
        out = {"w": stack(blocks, lambda b: get(mod(b).weight).T)}
        if mod(blocks[0]).bias is not None:
            out["b"] = stack(blocks, lambda b: get(mod(b).bias))
        return out

    def ln_p(blocks, name) -> dict:
        return {k: stack(blocks, lambda b: get(getattr(getattr(b, name), k))) for k in ("scale", "bias")}

    def blocks_p(blocks, cross: bool) -> dict:
        out = {
            "attn_ln": ln_p(blocks, "attn_ln"),
            "attn": {n: dense_p(blocks, ("attn", n)) for n in ("q", "k", "v", "o")},
            "mlp_ln": ln_p(blocks, "mlp_ln"),
            "mlp": {n: dense_p(blocks, (n,)) for n in ("fc1", "fc2")},
        }
        if cross:
            out["cross_ln"] = ln_p(blocks, "cross_ln")
            out["cross"] = {n: dense_p(blocks, ("cross", n)) for n in ("q", "k", "v", "o")}
        return out

    enc, dec = model.encoder, model.decoder
    return {
        "encoder": {
            **{c: {"w": get(getattr(enc, c).weight), "b": get(getattr(enc, c).bias)}
               for c in ("conv1", "conv2")},
            "blocks": blocks_p(list(enc.blocks), cross=False),
            "ln_post": {"scale": get(enc.ln_post.scale), "bias": get(enc.ln_post.bias)},
        },
        "decoder": {
            "tok_emb": get(dec.tok_emb),
            "pos_emb": get(dec.pos_emb),
            "blocks": blocks_p(list(dec.blocks), cross=True),
            "ln": {"scale": get(dec.ln.scale), "bias": get(dec.ln.bias)},
        },
    }


def _f8_linears(model: Whisper):
    """The decoder-block linears that ``quantize_decoder_f8`` converts."""
    for blk in model.decoder.blocks:
        yield from (blk.attn.q, blk.attn.k, blk.attn.v, blk.attn.o,
                    blk.cross.q, blk.cross.o, blk.fc1, blk.fc2)


def quantize_decoder_f8(model: Whisper) -> Whisper:
    """Quantize the decoder blocks' linear weights to float8_e4m3fn with f32
    per-output-channel scales, in place (JAX ``quantize_decoder_f8``):
    self q/k/v/o, cross q/o and the MLP. Cross k/v (run once per anchor) and
    the token embedding (also the unembedding) stay. Each weight is divided
    in f32 by its channel's scale ``max(amax / 448, 1e-12)`` and rounded as
    JAX rounds (``to_e4m3fn``), so the bytes and scales equal JAX's."""
    for mod in _f8_linears(model):
        if mod.w_scale is not None:
            continue
        w = mod.weight.detach().float()                       # [out, in]
        amax = w.abs().amax(dim=1)
        # a tensor divisor: CUDA turns a division by a Python number into a
        # product with its reciprocal, which is not JAX's f32 division
        scale = torch.clamp(amax / torch.full_like(amax, F8_MAX), min=1e-12)
        mod.weight = nn.Parameter(to_e4m3fn(w / scale[:, None]), requires_grad=False)
        mod.w_scale = scale
    return model


# ---------------------------------------------------------------------------
# Primitive ops
# ---------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, p: LayerNorm, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * p.scale.float() + p.bias.float()).to(x.dtype)


def _linear_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w.T with an f32 result (``preferred_element_type=f32``). On CUDA,
    16-bit operands go to cuBLAS as they are, accumulating in f32 and
    writing f32; elsewhere they are widened first (exact products, f32
    sums), which is the same math."""
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[0])
    return F.linear(x.float(), w.float())


def dense(x: torch.Tensor, p: Dense) -> torch.Tensor:
    """x @ w (+ b) in f32, rounded once to x's dtype, as JAX's ``dense``. An
    f8 weight is widened to x's dtype for the product, and its channel
    scale multiplies the f32 result before the bias. A tensor-parallel
    shard's role (``p.tp``) wraps the product in its collectives."""
    if p.tp is not None:
        x = p.tp.enter(x)
    if p.weight.dtype == F8:
        y = _linear_f32(x, p.weight.to(x.dtype)) * p.w_scale
    else:
        y = _linear_f32(x, p.weight)
    if p.tp is not None:
        y = p.tp.leave(y)
    if p.bias is not None:
        y = y + p.bias.float()
    return y.to(x.dtype)


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, n_head, d // n_head)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, s, h, dh = x.shape
    return x.reshape(b, s, h * dh)


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Sinusoidal position embeddings (reference whisper/model.py sinusoids)."""
    assert channels % 2 == 0
    log_timescale_increment = math.log(10000) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(np.float32)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 output; reduced-precision operands are widened first
    so products are exact and sums f32 (preferred_element_type=f32)."""
    return torch.matmul(a.float(), b.float())


def _attend(q, k, v, mask=None):
    """Materializing attention for short query blocks.

    q:[B,S,H,Dh] k,v:[B,T,H,Dh] mask:[B,S,T] additive or None ->
    ([B,S,H,Dh], probs [B,H,S,T]). Softmax in f32 regardless of dtype.
    """
    dh = q.shape[-1]
    scores = _mm_f32(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1)) * (dh ** -0.5)
    if mask is not None:
        scores = scores + mask[:, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype), v.permute(0, 2, 1, 3))  # [B,H,S,Dh]
    return out.permute(0, 2, 1, 3).to(v.dtype), probs


def _attend_t(q, k, v, mask=None):
    """Attention over *transposed* KV storage [B,H,Dh,T].

    q: [B,S,H,Dh] -> ([B,S,H,Dh], probs [B,H,S,T]).
    """
    dh = q.shape[-1]
    scores = _mm_f32(q.permute(0, 2, 1, 3), k) * (dh ** -0.5)
    if mask is not None:
        scores = scores + mask[:, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype), v.transpose(-1, -2))  # [B,H,S,Dh]
    return out.permute(0, 2, 1, 3).to(v.dtype), probs


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _conv1d(x: torch.Tensor, p: Conv, stride: int) -> torch.Tensor:
    # x: [B, C_in, T], w: [C_out, C_in, K], padding 1 like the reference;
    # widened operands give the f32 result JAX asks for, rounded once
    y = F.conv1d(x.float(), p.weight.float(), stride=stride, padding=1)
    return (y + p.bias.float()[None, :, None]).to(x.dtype)


def encode(
    model: Whisper,
    mel: torch.Tensor,
    dims: ModelDimensions,
    pos_start: Optional[torch.Tensor] = None,
    flash: Optional[bool] = None,
) -> torch.Tensor:
    """mel [B, n_mels, 2*F] -> encoder features [B, F, D].

    ``pos_start`` ([B] int) offsets the sinusoidal position table per lane:
    an incremental tick encodes only a window tail whose frames carry their
    absolute positions within the 30 s window.

    ``flash`` forces the attention path, as in JAX: None takes the kernel
    where it runs (CUDA, Dh 64 or 128), False the differentiable plain
    attention (the training step: the kernel has no backward), True the
    kernel, which raises without CUDA rather than run the plain version.
    """
    p = model.encoder
    x = mel.to(p.conv1.weight.dtype)
    x = F.gelu(_conv1d(x, p.conv1, 1))
    x = F.gelu(_conv1d(x, p.conv2, 2))
    x = x.transpose(1, 2)  # [B, T, D]
    pos = p.pos
    if pos_start is None:
        x = x + pos[: x.shape[1]].to(x.dtype)
    else:
        idx = torch.clamp(
            pos_start.long()[:, None] + torch.arange(x.shape[1], device=x.device)[None, :],
            max=dims.n_audio_ctx - 1,
        )
        x = x + pos[idx].to(x.dtype)

    n_head = dims.n_audio_head
    T0 = x.shape[1]
    use_flash = _flash_attn_available(x, dims.n_audio_state // n_head) if flash is None else flash
    if flash and not x.is_cuda:
        raise ValueError("encode(flash=True) needs CUDA tensors: the flash kernel has no CPU form")

    for bp in p.blocks:
        h = layer_norm(x, bp.attn_ln)
        q = _split_heads(dense(h, bp.attn.q), n_head)
        k = _split_heads(dense(h, bp.attn.k), n_head)
        v = _split_heads(dense(h, bp.attn.v), n_head)
        if use_flash:
            from ...ops.flash_encoder import flash_encoder_attn

            # strided views, no transposing copies: the kernel takes strides
            attn = flash_encoder_attn(
                q.transpose(1, 2), k.permute(0, 2, 3, 1), v.transpose(1, 2), t_valid=T0,
            ).transpose(1, 2)
        else:
            attn, _ = _attend(q, k, v)
        x = x + dense(_merge_heads(attn), bp.attn.o)
        h = layer_norm(x, bp.mlp_ln)
        h = F.gelu(dense(h, bp.fc1))
        x = x + dense(h, bp.fc2)
    return layer_norm(x, p.ln_post)


# ---------------------------------------------------------------------------
# Decoder with explicit KV cache
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Self-attention cache: [L, B, W, H, Dh] keys/values."""

    k: torch.Tensor
    v: torch.Tensor


class CrossKV(NamedTuple):
    """Per-layer encoder keys/values: [L, B, T_enc, H, Dh], or
    [L, B, H, Dh, T_enc] in the transposed layout."""

    k: torch.Tensor
    v: torch.Tensor


def init_cache(
    dims: ModelDimensions, batch: int, dtype=torch.float32,
    width: Optional[int] = None, device="cpu",
) -> KVCache:
    """``width`` bounds the cache timeline (prefix bucket + step budget)."""
    w = min(width or dims.n_text_ctx, dims.n_text_ctx)
    shape = (dims.n_text_layer, batch, w, dims.n_text_head, dims.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


def cross_kv(
    model: Whisper,
    enc: torch.Tensor,
    dims: ModelDimensions,
    out_dtype=None,
    transposed: bool = False,
) -> CrossKV:
    """Project every decoder layer's cross-attention K/V from ``enc``
    [B, T, D]. ``out_dtype`` (e.g. float8_e4m3fn) casts per layer;
    ``transposed`` stores [B, H, Dh, T] per layer (T innermost)."""
    n_head = dims.n_text_head
    B_, T_, _ = enc.shape
    ks, vs = [], []
    for bp in model.decoder.blocks:
        if transposed:
            def project(p: Dense):
                out = _linear_f32(enc, p.weight)  # [B, T, D] f32
                if p.bias is not None:
                    out = out + p.bias.float()
                out = cast_to(out, out_dtype or enc.dtype)
                return out.transpose(1, 2).reshape(B_, n_head, -1, T_)

            ks.append(project(bp.cross.k))
            vs.append(project(bp.cross.v))
        else:
            k = _split_heads(dense(enc, bp.cross.k), n_head)
            v = _split_heads(dense(enc, bp.cross.v), n_head)
            if out_dtype is not None:
                k, v = cast_to(k, out_dtype), cast_to(v, out_dtype)
            ks.append(k)
            vs.append(v)
    return CrossKV(k=torch.stack(ks), v=torch.stack(vs))


def cross_kv_into_pool(
    model: Whisper,
    enc: torch.Tensor,      # [G, T, D]
    pool_k: torch.Tensor,   # [L, G, H, Dh, Tp], written IN PLACE
    pool_v: torch.Tensor,
    dims: ModelDimensions,
    active: Optional[torch.Tensor] = None,  # [G] bool: slots to (re)write
) -> CrossKV:
    """Project the full-window cross-KV directly into a group pool, one
    layer at a time (transposed layout), so the transient is one layer's
    K or V rather than a dense [L,G,H,Dh,T] copy beside the pool. Columns
    T..Tp are zeroed; inactive slots keep every bit. The f32 projection is
    rounded once to the pool's dtype (to float8_e4m3fn as JAX rounds).
    Returns the pools."""
    n_head = dims.n_text_head
    G, T_, _ = enc.shape
    Tp = pool_k.shape[-1]
    keep = None if active is None else active.bool()[:, None, None, None]
    for layer_i, bp in enumerate(model.decoder.blocks):
        for pool, p in ((pool_k, bp.cross.k), (pool_v, bp.cross.v)):
            out = _linear_f32(enc, p.weight)  # [G, T, D] f32
            if p.bias is not None:
                out = out + p.bias.float()
            out = out.transpose(1, 2).reshape(G, n_head, -1, T_)
            write_cast(pool, layer_i, F.pad(out, (0, Tp - T_)), keep)
    return CrossKV(k=pool_k, v=pool_v)


class AlignSpec(NamedTuple):
    """Static alignment-head routing: K entries of (layer, head)."""

    layers: torch.Tensor  # [K] int64
    heads: torch.Tensor   # [K] int64

    @classmethod
    def from_pairs(cls, pairs, device="cpu") -> "AlignSpec":
        arr = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        return cls(
            layers=torch.as_tensor(arr[:, 0], device=device),
            heads=torch.as_tensor(arr[:, 1], device=device),
        )

    @property
    def count(self) -> int:
        return self.layers.shape[0]


def decode(
    model: Whisper,
    tokens: torch.Tensor,  # [B, S] int — the new tokens to process
    pos: torch.Tensor,     # [B] int — current cache fill per lane
    xkv: CrossKV,
    cache: KVCache,
    dims: ModelDimensions,
    align: Optional[AlignSpec] = None,
    enc_mask: Optional[torch.Tensor] = None,  # [B, T_enc] bool — valid frames
    align_reduce: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    xkv_transposed: bool = False,
    t_valid: Optional[int] = None,
    positions_override: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, object, KVCache]:
    """Teacher-forced step over S new tokens for every lane.

    Returns (logits [B,S,V] f32, align output | None, cache). The align
    output is probs [K,B,S,T] f32, or with ``align_reduce=(w_sum [B,S],
    w_last [B,S])`` the in-loop row reductions (asum, asq, last), each
    [B,K,T]. The new K/V rows are written into ``cache`` in place.

    Write slots are pos + s (or ``positions_override``) clamped to W-1. Two
    rows of a lane can share a slot only at that clamp, the scratch slot
    where padding rows park and which only padding rows read, so the
    unordered ``index_put_`` is deterministic on every row a valid query
    attends.
    """
    dec = model.decoder
    B, S = tokens.shape
    n_head = dims.n_text_head
    W = cache.k.shape[2]
    dev = tokens.device

    if positions_override is not None:
        raw_pos = positions_override.long()
    else:
        raw_pos = pos.long()[:, None] + torch.arange(S, device=dev)[None, :]  # [B,S]
    emb_pos = torch.clamp(raw_pos, max=dims.n_text_ctx - 1)
    positions = torch.clamp(raw_pos, max=W - 1)
    x = dec.tok_emb[tokens.long()] + dec.pos_emb[emb_pos]

    # key j visible to query s iff j <= its position (per-lane offsets)
    key_idx = torch.arange(W, device=dev)[None, None, :]
    zero = torch.zeros((), device=dev)
    ninf = torch.full((), float("-inf"), device=dev)
    self_mask = torch.where(key_idx <= positions[:, :, None], zero, ninf)

    T_enc_in = xkv.k.shape[-1] if xkv_transposed else xkv.k.shape[2]
    cross_mask = None
    if enc_mask is not None:
        cross_mask = torch.where(enc_mask[:, None, :], zero, ninf)
    if t_valid is not None and t_valid < T_enc_in:
        pad_mask = torch.where(
            torch.arange(T_enc_in, device=dev)[None, None, :] < t_valid, zero, ninf
        )
        cross_mask = pad_mask if cross_mask is None else cross_mask + pad_mask

    batch_idx = torch.arange(B, device=dev)[:, None]
    T_enc = T_enc_in
    # prefill (S>1) cross-attention through the kernel when nothing reads its
    # probs: with align_reduce the gate statistics come from the K-head
    # recompute below, and without align nothing reads them
    use_flash_prefill = (
        xkv_transposed
        and S > 1
        and S % 8 == 0
        and enc_mask is None
        and (align is None or align_reduce is not None)
        and xkv.k.is_cuda
    )
    flash_t_valid = min(t_valid or T_enc_in, T_enc_in)
    if align is not None and align_reduce is not None:
        align_acc = tuple(
            torch.zeros((B, align.count, T_enc), dtype=torch.float32, device=dev)
            for _ in range(3)
        )
    elif align is not None:
        align_acc = torch.zeros((align.count, B, S, T_enc), dtype=torch.float32, device=dev)
    else:
        align_acc = None

    for layer_i, bp in enumerate(dec.blocks):
        ck, cv = cache.k[layer_i], cache.v[layer_i]
        xk, xv = xkv.k[layer_i], xkv.v[layer_i]

        # -- self attention over cache --
        h = layer_norm(x, bp.attn_ln)
        q = _split_heads(dense(h, bp.attn.q), n_head)
        k_new = _split_heads(dense(h, bp.attn.k), n_head)
        v_new = _split_heads(dense(h, bp.attn.v), n_head)
        ck[batch_idx, positions] = k_new.to(ck.dtype)
        cv[batch_idx, positions] = v_new.to(cv.dtype)
        attn, _ = _attend(q, ck, cv, mask=self_mask)
        x = x + dense(_merge_heads(attn), bp.attn.o)

        # -- cross attention over encoder features --
        h = layer_norm(x, bp.cross_ln)
        qx = _split_heads(dense(h, bp.cross.q), n_head)
        # cross-KV may be stored narrow (f8); cast per layer
        xk = xk.to(x.dtype)
        xv = xv.to(x.dtype)
        if use_flash_prefill:
            from ...ops.flash_encoder import flash_encoder_attn

            xattn = flash_encoder_attn(
                qx.transpose(1, 2), xk, xv, t_valid=flash_t_valid, v_transposed=True,
            ).transpose(1, 2)
            xprobs = None
        elif xkv_transposed:
            xattn, xprobs = _attend_t(qx, xk, xv, mask=cross_mask)
        else:
            xattn, xprobs = _attend(qx, xk, xv, mask=cross_mask)
        x = x + dense(_merge_heads(xattn), bp.cross.o)

        if align_acc is not None and align_reduce is not None:
            # recompute scores for ONLY the K registered heads and reduce,
            # in row chunks of <=64 (softmax is row-local, the reductions
            # are row sums) to bound the [B,K,S,T] transient
            sel = (align.layers == layer_i).float()             # [K]
            q_sel = qx[:, :, align.heads]                       # [B,S,K,Dh]
            if xkv_transposed:
                k_sel = xk[:, align.heads]                      # [B,K,Dh,T]
            else:
                k_sel = xk[:, :, align.heads].permute(0, 2, 3, 1)  # [B,K,Dh,T]
            w_sum, w_last = align_reduce
            scale = qx.shape[-1] ** -0.5
            S_rows = q_sel.shape[1]
            CH = 64 if S_rows % 64 == 0 else S_rows
            parts = []
            for c0 in range(0, S_rows, CH):
                q_c = q_sel[:, c0 : c0 + CH].permute(0, 2, 1, 3)  # [B,K,CH,Dh]
                s_c = _mm_f32(q_c, k_sel) * scale               # [B,K,CH,T]
                if cross_mask is not None:
                    s_c = s_c + cross_mask[:, None, :, :]
                g = torch.softmax(s_c, dim=-1)
                ws = w_sum[:, c0 : c0 + CH].float()
                wl = w_last[:, c0 : c0 + CH].float()
                parts.append((
                    torch.einsum("bkst,bs->bkt", g, ws),
                    torch.einsum("bkst,bs->bkt", g * g, ws),
                    torch.einsum("bkst,bs->bkt", g, wl),
                ))
            if len(parts) == 1:
                g_sum, g_sq, g_last = parts[0]
            else:
                g_sum, g_sq, g_last = (torch.stack(z).sum(0) for z in zip(*parts))
            asum, asq, alast = align_acc
            selk = sel[None, :, None]
            align_acc = (asum + selk * g_sum, asq + selk * g_sq, alast + selk * g_last)
        elif align_acc is not None:
            # step path (S=1): gather the registered heads' probability rows
            sel = (align.layers == layer_i).float()
            gathered = xprobs[:, align.heads]  # [B,K,S,T]
            align_acc = align_acc + sel[:, None, None, None] * gathered.transpose(0, 1)

        # -- mlp --
        h = layer_norm(x, bp.mlp_ln)
        x = x + dense(F.gelu(dense(h, bp.fc1)), bp.fc2)

    x = layer_norm(x, dec.ln)
    logits = _linear_f32(x, dec.tok_emb.to(x.dtype))
    if align_acc is not None and t_valid is not None and t_valid < T_enc_in:
        # padded pool columns carry zero attention; return T-true stats
        if isinstance(align_acc, tuple):
            align_acc = tuple(a[..., :t_valid] for a in align_acc)
        else:
            align_acc = align_acc[..., :t_valid]
    return logits, align_acc, cache
