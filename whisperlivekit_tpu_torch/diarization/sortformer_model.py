"""Streaming Sortformer diarization model in PyTorch (port of
whisperlivekit_tpu/diarization/sortformer_jax.py).

End-to-end speaker diarization with arrival-order speaker outputs
(Sortformer, arXiv:2409.06656; the streaming variant the reference runs via
NeMo — reference diarization/sortformer_backend.py:50-128 configuration,
:130-336 per-chunk streaming). Architecture mirrors NVIDIA
``diar_streaming_sortformer_4spk-v2`` so its checkpoint converts directly:

    mel (128 bands, 10 ms) → dw-striding conv subsampling (×8)
    → conformer encoder (rel-pos MHA, GLU conv module w/ batch-norm)
    → encoder_proj (512→192) → post-LN transformer over
      [speaker-cache | FIFO | chunk] embeddings → sigmoid heads (≤4 spk)

Streaming: the conformer runs ONLY on each new chunk (with mel left
context); chunk embeddings append to a FIFO; on overflow the popped frames
compress into a bounded speaker cache by per-speaker confidence quota
(arrival order preserved), silence frames average into a running silence
embedding used as cache padding. ``StreamingState`` is a small dataclass of
tensors; ``streaming_step`` reads one bool to the host per chunk (whether
anything popped), where JAX branches with ``lax.cond``.

Layouts are torch's, as the NeMo checkpoint stores them: Linear [out, in],
conv2d OIHW in NCHW activations with explicit ``padding=1``, the conformer's
depthwise conv1d [d, 1, K]. ``convert_nemo_state_dict`` therefore
transposes nothing (batch norm folds into the conv module); it raises on
unmapped keys. ``sortformer_params_from_jax`` converts the JAX package's
pytree (HWIO convs, [in, out] dense), the bridge the parity tests use.

Precision: every product here is a matmul under PyTorch's matmul default
(full f32 on CUDA unless ``torch.backends.cuda.matmul.allow_tf32`` is set)
or elementwise; the subsampling convs are written as unfolds and products,
so cuDNN's TF32 default for convolutions does not apply.
"""

from __future__ import annotations

import io
import math
import re
import tarfile
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.whisper.model import Dense, LayerNorm, dense, layer_norm


@dataclass(frozen=True)
class SortformerDims:
    n_mels: int = 128
    subsampling: int = 8
    subsampling_channels: int = 256
    d_encoder: int = 512
    encoder_layers: int = 18
    encoder_heads: int = 8
    encoder_ff: int = 2048
    conv_kernel: int = 9
    d_model: int = 192            # fc_d_model: transformer-head hidden
    head_layers: int = 18
    head_heads: int = 8
    head_ff: int = 768
    max_speakers: int = 4
    # streaming geometry (reference sortformer_backend.py:117-124)
    spkcache_len: int = 188
    fifo_len: int = 188
    spkcache_update_period: int = 144
    chunk_mel_frames: int = 100   # 1.0 s chunks at 10 ms hop
    left_ctx_mel_frames: int = 99 # mel left context carried between chunks


DEV_TINY = SortformerDims(
    n_mels=64, subsampling_channels=16, d_encoder=32, encoder_layers=2,
    encoder_heads=4, encoder_ff=64, d_model=16, head_layers=2, head_heads=4,
    head_ff=32, spkcache_len=16, fifo_len=12, spkcache_update_period=8,
    chunk_mel_frames=40, left_ctx_mel_frames=23,
)


def _ceil_div3(t: int) -> int:
    for _ in range(3):
        t = -(-t // 2)
    return t


# ---------------------------------------------------------------------------
# Modules (weights only; the forward passes are the functions below)
# ---------------------------------------------------------------------------


class Conv2d(nn.Module):
    """OIHW weight and bias (a 3x3 full or depthwise conv, or a 1x1)."""

    def __init__(self, c_out: int, c_in: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k))
        self.bias = nn.Parameter(torch.zeros(c_out))


class Subsampling(nn.Module):
    """NeMo ConvSubsampling('dw_striding'): a 3x3 stride-2 conv, then two
    (depthwise 3x3 stride 2, pointwise) stages, all padding=1, in NCHW;
    then the channel-major flatten and the out linear."""

    def __init__(self, dims: SortformerDims):
        super().__init__()
        C = dims.subsampling_channels
        self.conv0 = Conv2d(C, 1, 3)
        self.dw1, self.pw1 = Conv2d(C, 1, 3), Conv2d(C, C, 1)
        self.dw2, self.pw2 = Conv2d(C, 1, 3), Conv2d(C, C, 1)
        self.out = Dense(C * _ceil_div3(dims.n_mels), dims.d_encoder)


class RelPosAttention(nn.Module):
    def __init__(self, d: int, n_head: int):
        super().__init__()
        self.q, self.k, self.v, self.o = (Dense(d, d) for _ in range(4))
        self.pos = Dense(d, d, bias=False)
        self.bias_u = nn.Parameter(torch.zeros(n_head, d // n_head))
        self.bias_v = nn.Parameter(torch.zeros(n_head, d // n_head))


class ConformerLayer(nn.Module):
    def __init__(self, dims: SortformerDims):
        super().__init__()
        d, ff = dims.d_encoder, dims.encoder_ff
        self.ff1_ln, self.ff1_in, self.ff1_out = LayerNorm(d), Dense(d, ff), Dense(ff, d)
        self.attn_ln, self.attn = LayerNorm(d), RelPosAttention(d, dims.encoder_heads)
        self.conv_ln, self.conv_pw1 = LayerNorm(d), Dense(d, 2 * d)
        self.conv_dw = nn.Parameter(torch.empty(d, 1, dims.conv_kernel))  # conv1d [d, 1, K]
        self.conv_dw_b = nn.Parameter(torch.zeros(d))
        # batch norm folded at load; identity at init
        self.conv_bn_scale = nn.Parameter(torch.ones(d))
        self.conv_bn_bias = nn.Parameter(torch.zeros(d))
        self.conv_pw2 = Dense(d, d)
        self.ff2_ln, self.ff2_in, self.ff2_out = LayerNorm(d), Dense(d, ff), Dense(ff, d)
        self.out_ln = LayerNorm(d)


class HeadAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q, self.k, self.v, self.o = (Dense(d, d) for _ in range(4))


class HeadLayer(nn.Module):
    def __init__(self, dims: SortformerDims):
        super().__init__()
        d = dims.d_model
        self.attn, self.ln1 = HeadAttention(d), LayerNorm(d)
        self.ff_in, self.ff_out, self.ln2 = Dense(d, dims.head_ff), Dense(dims.head_ff, d), LayerNorm(d)


class Sortformer(nn.Module):
    def __init__(self, dims: SortformerDims):
        super().__init__()
        self.dims = dims
        self.sub = Subsampling(dims)
        self.conformer = nn.ModuleList(ConformerLayer(dims) for _ in range(dims.encoder_layers))
        self.proj = Dense(dims.d_encoder, dims.d_model)
        self.head = nn.ModuleList(HeadLayer(dims) for _ in range(dims.head_layers))
        self.spk_mid = Dense(dims.d_model, dims.d_model)
        self.spk_out = Dense(dims.d_model, dims.max_speakers)

    @property
    def device(self) -> torch.device:
        return self.proj.weight.device


def init_params(dims: SortformerDims, seed: int = 0, dtype=torch.float32, device="cpu") -> Sortformer:
    """Random weights from a seeded generator on ``device`` (JAX's
    ``init_params`` scales; the numbers differ from ``PRNGKey``'s)."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    model = Sortformer(dims).to(device)
    rnd = lambda shape, std: torch.randn(shape, generator=g, device=device) * std  # noqa: E731
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight" and p.dim() == 2:          # dense [out, in]
                p.data = rnd(p.shape, p.shape[1] ** -0.5)
            elif leaf == "weight" and p.shape[-1] == 1:    # pointwise conv
                p.data = rnd(p.shape, p.shape[1] ** -0.5)
            elif leaf in ("weight",):                      # 3x3 convs
                p.data = rnd(p.shape, 0.2)
            elif leaf == "conv_dw":
                p.data = rnd(p.shape, 0.1)
            elif leaf in ("scale", "conv_bn_scale"):
                p.data = torch.ones(p.shape, device=device)
            else:
                p.data = torch.zeros(p.shape, device=device)
    return model.to(dtype).eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------


def _conv3x3_s2(x: torch.Tensor, p: Conv2d, groups: int) -> torch.Tensor:
    """A 3x3 stride-2 conv with padding=1 (torch ``Conv2d(..., padding=1)``,
    not XLA SAME), NCHW, as an unfold and a product: ``groups`` 1 with one
    input channel (the full conv), or one group per channel (depthwise)."""
    B, C, H, W = x.shape
    Ho, Wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    cols = F.unfold(x, kernel_size=3, padding=1, stride=2)  # [B, C*9, Ho*Wo]
    w = p.weight.reshape(p.weight.shape[0], 9)
    if groups == 1:
        y = torch.matmul(w, cols)                                   # [B, C_out, L]
    else:
        y = (cols.reshape(B, C, 9, -1) * w[None, :, :, None]).sum(2)  # [B, C, L]
    return (y + p.bias[None, :, None]).reshape(B, -1, Ho, Wo)


def _conv1x1(x: torch.Tensor, p: Conv2d) -> torch.Tensor:
    B, C, H, W = x.shape
    y = torch.matmul(p.weight.reshape(p.weight.shape[0], C), x.reshape(B, C, H * W))
    return (y + p.bias[None, :, None]).reshape(B, -1, H, W)


def subsample(model: Sortformer, mel: torch.Tensor, dims: SortformerDims) -> torch.Tensor:
    """mel [B, T, n_mels] → [B, ceil(T/8), d_encoder] (dw-striding ×8).

    NeMo ConvSubsampling(subsampling='dw_striding'): 3×3 stride-2 convs with
    padding=1, ReLU after the full conv and after each pointwise, and the
    output flattened CHANNEL-major (``x.transpose(1, 2).reshape(b, t, -1)``)
    before the out linear."""
    s = model.sub
    C = dims.subsampling_channels
    x = mel[:, None]  # [B, 1, T, mels]
    x = F.relu(_conv3x3_s2(x, s.conv0, 1))
    x = F.relu(_conv1x1(_conv3x3_s2(x, s.dw1, C), s.pw1))
    x = F.relu(_conv1x1(_conv3x3_s2(x, s.dw2, C), s.pw2))
    B, _, T8, M8 = x.shape
    x = x.transpose(1, 2).reshape(B, T8, C * M8)  # channel-major flatten
    return dense(x, s.out)


def _relpos_table(length: int, d: int) -> np.ndarray:
    """NeMo RelPositionalEncoding: interleaved sin/cos for positions
    length-1 … -(length-1), shape [2*length-1, d]."""
    pos = np.arange(length - 1, -length, -1, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(math.log(10000.0) / d))
    pe = np.zeros((2 * length - 1, d), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """[B,H,T,2T-1] → [B,H,T,2T-1] with the Transformer-XL index shift."""
    b, h, t, p2 = x.shape
    x = F.pad(x, (1, 0))
    x = x.reshape(b, h, p2 + 1, t)[:, :, 1:]
    return x.reshape(b, h, t, p2)


def _relpos_attend(x: torch.Tensor, p: RelPosAttention, pos_emb: torch.Tensor, n_head: int) -> torch.Tensor:
    """NeMo RelPositionMultiHeadAttention (Transformer-XL scoring)."""
    B, T, d = x.shape
    dh = d // n_head
    q = dense(x, p.q).reshape(B, T, n_head, dh)
    k = dense(x, p.k).reshape(B, T, n_head, dh)
    v = dense(x, p.v).reshape(B, T, n_head, dh)
    pe = dense(pos_emb, p.pos).reshape(-1, n_head, dh)  # [2T-1, H, dh]

    q_u = (q + p.bias_u.to(q.dtype)).transpose(1, 2).float()   # [B, H, T, dh]
    q_v = (q + p.bias_v.to(q.dtype)).transpose(1, 2).float()
    ac = torch.matmul(q_u, k.permute(0, 2, 3, 1).float())       # [B, H, T, T]
    bd = torch.matmul(q_v, pe.permute(1, 2, 0).float()[None])   # [B, H, T, 2T-1]
    bd = _rel_shift(bd)[..., :T]
    scores = (ac + bd) * (dh ** -0.5)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.transpose(1, 2).float())
    out = out.transpose(1, 2).to(x.dtype)
    return dense(out.reshape(B, T, d), p.o)


def conformer(model: Sortformer, x: torch.Tensor, dims: SortformerDims) -> torch.Tensor:
    """[B, T, d_encoder] → same shape; NeMo ConformerLayer ordering."""
    n_head = dims.encoder_heads
    K = dims.conv_kernel
    x = x * math.sqrt(dims.d_encoder)  # NeMo xscale on the pos-enc input
    pos_emb = torch.from_numpy(_relpos_table(x.shape[1], dims.d_encoder)).to(device=x.device, dtype=x.dtype)
    T = x.shape[1]
    for p in model.conformer:
        x = x + 0.5 * dense(F.silu(dense(layer_norm(x, p.ff1_ln), p.ff1_in)), p.ff1_out)
        x = x + _relpos_attend(layer_norm(x, p.attn_ln), p.attn, pos_emb, n_head)
        # conv module: pointwise GLU → depthwise → (folded) BN → swish → pointwise
        h = dense(layer_norm(x, p.conv_ln), p.conv_pw1)
        a, b = h.chunk(2, dim=-1)
        h = a * torch.sigmoid(b)
        pad = K // 2
        windows = F.pad(h, (0, 0, pad, pad)).unfold(1, K, 1)[:, :T]  # [B, T, d, K]
        h = torch.einsum("btdk,dk->btd", windows, p.conv_dw[:, 0, :]) + p.conv_dw_b
        h = h * p.conv_bn_scale + p.conv_bn_bias
        h = F.silu(h)
        x = x + dense(h, p.conv_pw2)
        x = x + 0.5 * dense(F.silu(dense(layer_norm(x, p.ff2_ln), p.ff2_in)), p.ff2_out)
        x = layer_norm(x, p.out_ln)
    return x


def encode_chunk(model: Sortformer, mel: torch.Tensor, dims: SortformerDims) -> torch.Tensor:
    """mel chunk [B, T_mel, n_mels] → projected embeddings [B, T_mel/8, d_model]."""
    feats = subsample(model, mel, dims)
    feats = conformer(model, feats, dims)
    return dense(feats, model.proj)


def head_predict(
    model: Sortformer, emb: torch.Tensor, dims: SortformerDims,
    valid: Optional[torch.Tensor] = None,  # [B, T] bool — attendable positions
) -> torch.Tensor:
    """Embeddings [B, T, d_model] → speaker probs [B, T, S] (post-LN
    transformer + 2-layer sigmoid head). ``valid`` masks the static-shape
    padding inside [spkcache | fifo | chunk] out of attention."""
    attn_mask = None
    if valid is not None:
        attn_mask = torch.zeros(valid.shape, dtype=torch.float32, device=valid.device).masked_fill(
            ~valid, float("-inf"))[:, None, None, :]
    x = emb
    for p in model.head:
        B, T, d = x.shape
        dh = d // dims.head_heads
        q = dense(x, p.attn.q).reshape(B, T, dims.head_heads, dh)
        k = dense(x, p.attn.k).reshape(B, T, dims.head_heads, dh)
        v = dense(x, p.attn.v).reshape(B, T, dims.head_heads, dh)
        scores = torch.matmul(q.transpose(1, 2).float(), k.permute(0, 2, 3, 1).float()) * (dh ** -0.5)
        if attn_mask is not None:
            scores = scores + attn_mask
        probs = torch.softmax(scores, dim=-1)
        attn = torch.matmul(probs.to(v.dtype).float(), v.transpose(1, 2).float()).transpose(1, 2).to(x.dtype)
        attn = dense(attn.reshape(B, T, d), p.attn.o)
        x = layer_norm(x + attn, p.ln1)
        ff = dense(F.relu(dense(x, p.ff_in)), p.ff_out)
        x = layer_norm(x + ff, p.ln2)
    h = F.relu(dense(x, model.spk_mid))
    return torch.sigmoid(dense(h, model.spk_out).float())


def forward(model: Sortformer, mel: torch.Tensor, dims: SortformerDims) -> torch.Tensor:
    """Offline: mel [B, T, n_mels] → [B, T/8, S] speaker probabilities."""
    return head_predict(model, encode_chunk(model, mel, dims), dims)


# ---------------------------------------------------------------------------
# Streaming state machine (embedding-domain cache/FIFO, NeMo semantics)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StreamingState:
    spkcache: torch.Tensor       # [B, spkcache_len, d_model]
    spkcache_preds: torch.Tensor # [B, spkcache_len, S]
    spkcache_len: torch.Tensor   # [B] int32
    fifo: torch.Tensor           # [B, fifo_len, d_model]
    fifo_len: torch.Tensor       # [B] int32
    mean_sil_emb: torch.Tensor   # [B, d_model]
    n_sil_frames: torch.Tensor   # [B] int32

    def _replace(self, **kw) -> "StreamingState":
        return replace(self, **kw)


def init_state(dims: SortformerDims, batch: int, dtype=torch.float32, device="cpu") -> StreamingState:
    z = lambda *s, dt=dtype: torch.zeros(s, dtype=dt, device=device)  # noqa: E731
    return StreamingState(
        spkcache=z(batch, dims.spkcache_len, dims.d_model),
        spkcache_preds=z(batch, dims.spkcache_len, dims.max_speakers, dt=torch.float32),
        spkcache_len=z(batch, dt=torch.int32),
        fifo=z(batch, dims.fifo_len, dims.d_model),
        fifo_len=z(batch, dt=torch.int32),
        mean_sil_emb=z(batch, dims.d_model),
        n_sil_frames=z(batch, dt=torch.int32),
    )


def _top_quota(score: torch.Tensor, quota: int) -> torch.Tensor:
    """The indices of each row's ``quota`` largest scores, ties to the lower
    index (``jax.lax.top_k``'s order): a stable descending sort."""
    return torch.sort(score, dim=1, descending=True, stable=True).indices[:, :quota]


def _compress_into_cache(state: StreamingState, popped, popped_preds, popped_valid, dims) -> StreamingState:
    """Merge popped FIFO frames into the bounded speaker cache: per-speaker
    confidence quota over [cache | popped], arrival order preserved; frames
    confidently silent feed the running silence embedding."""
    B = popped.shape[0]
    S = dims.max_speakers
    Lc, Lp = dims.spkcache_len, popped.shape[1]
    L = Lc + Lp
    dev = popped.device

    cache_valid = torch.arange(Lc, device=dev)[None, :] < state.spkcache_len[:, None]
    cand = torch.cat([state.spkcache, popped], dim=1)                    # [B,L,D]
    cand_preds = torch.cat([state.spkcache_preds, popped_preds], dim=1)
    valid = torch.cat([cache_valid, popped_valid], dim=1)                # [B,L]

    # silence bookkeeping: popped frames with no confident speaker
    sil = popped_valid & (popped_preds.amax(dim=-1) < 0.5)
    sil_sum = torch.einsum("bl,bld->bd", sil.to(popped.dtype), popped)
    n_sil = state.n_sil_frames + sil.sum(dim=1).to(torch.int32)
    mean_sil = torch.where(
        (n_sil > 0)[:, None],
        (state.mean_sil_emb * state.n_sil_frames[:, None].to(popped.dtype) + sil_sum)
        / torch.clamp(n_sil, min=1)[:, None].to(popped.dtype),
        state.mean_sil_emb,
    )

    # per-speaker quota selection
    quota = max(dims.spkcache_len // S, 1)
    keep = torch.zeros((B, L), dtype=torch.bool, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    for s in range(S):
        score = torch.where(valid, cand_preds[..., s], neg_inf)
        idx = _top_quota(score, quota)
        ok = torch.gather(score, 1, idx) > 0.05  # ignore near-zero
        keep = keep | torch.zeros_like(keep).scatter(1, idx, ok)

    # arrival order: sort kept indices, take the first spkcache_len
    arange_l = torch.arange(L, device=dev)[None, :].expand(B, L)
    pos = torch.where(keep, arange_l, torch.full_like(arange_l, L + 1))
    order = torch.sort(pos, dim=1).values[:, :Lc]
    safe = torch.clamp(order, max=L - 1)
    D = cand.shape[-1]
    new_cache = torch.gather(cand, 1, safe[..., None].expand(B, Lc, D))
    new_preds = torch.gather(cand_preds, 1, safe[..., None].expand(B, Lc, S))
    kept = order <= L
    n_kept = kept.sum(dim=1).to(torch.int32)
    # pad with the mean silence embedding (NeMo pads the cache with it)
    new_cache = torch.where(kept[..., None], new_cache, mean_sil[:, None, :])
    new_preds = torch.where(kept[..., None], new_preds, torch.zeros_like(new_preds))

    return state._replace(
        spkcache=new_cache,
        spkcache_preds=new_preds,
        spkcache_len=n_kept,
        mean_sil_emb=mean_sil,
        n_sil_frames=n_sil,
    )


@torch.no_grad()
def streaming_step(
    model: Sortformer,
    state: StreamingState,
    mel: torch.Tensor,   # [B, ctx+chunk mel frames, n_mels]
    dims: SortformerDims,
    ctx_frames: int = 0,  # leading mel frames to drop from the outputs
) -> Tuple[torch.Tensor, StreamingState]:
    """One streaming step. Returns (chunk speaker probs [B, n_chunk, S],
    new state). The conformer runs only on [left ctx | chunk]; the head runs
    over [spkcache | fifo | chunk] embeddings. The compression runs only
    when a frame popped (one host read: it is not a no-op when nothing
    popped, since it re-selects the cache)."""
    emb_all = encode_chunk(model, mel, dims)           # [B, T8, d_model]
    drop = _ceil_div3(ctx_frames)
    chunk_emb = emb_all[:, drop:]
    n_chunk = chunk_emb.shape[1]
    B = mel.shape[0]
    Lc, Lf = dims.spkcache_len, dims.fifo_len
    dev = mel.device
    D = chunk_emb.shape[-1]

    # static-shape padding inside [cache | fifo | chunk] is masked out of the
    # head's attention (valid = filled cache rows + filled fifo rows + chunk)
    pos_c = torch.arange(Lc, device=dev)[None, :] < state.spkcache_len[:, None]
    pos_f = torch.arange(Lf, device=dev)[None, :] < state.fifo_len[:, None]
    valid = torch.cat([pos_c, pos_f, torch.ones((B, n_chunk), dtype=torch.bool, device=dev)], dim=1)
    seq = torch.cat([state.spkcache, state.fifo, chunk_emb], dim=1)
    preds = head_predict(model, seq, dims, valid=valid)  # [B, Lc+Lf+n, S]
    chunk_preds = preds[:, -n_chunk:]
    fifo_preds = preds[:, Lc : Lc + Lf]

    # append the chunk AT fifo_len (valid-timeline semantics): output slot i
    # holds valid position i+overflow of [old fifo | chunk]; the first
    # `overflow` valid positions pop into the speaker cache
    new_len = state.fifo_len + n_chunk
    overflow = torch.clamp(new_len - Lf, min=0)  # [B], <= n_chunk
    src = torch.arange(Lf, device=dev)[None, :] + overflow[:, None]          # [B, Lf]
    from_old = src < state.fifo_len[:, None]
    old_vals = torch.gather(state.fifo, 1, torch.clamp(src, max=Lf - 1)[..., None].expand(B, Lf, D))
    chunk_src = torch.clamp(src - state.fifo_len[:, None], 0, n_chunk - 1)
    chunk_vals = torch.gather(chunk_emb, 1, chunk_src[..., None].expand(B, Lf, D))
    in_range = src < new_len[:, None]
    fifo = torch.where(
        from_old[..., None], old_vals,
        torch.where(in_range[..., None], chunk_vals, torch.zeros_like(chunk_vals)),
    )

    pop_idx = torch.arange(n_chunk, device=dev)[None, :]
    popped_valid = pop_idx < overflow[:, None]
    # popped frames are the oldest valid fifo rows (slots 0..overflow)
    popped = state.fifo[:, :n_chunk]
    popped_preds = fifo_preds[:, :n_chunk]

    state = state._replace(fifo=fifo, fifo_len=torch.clamp(new_len, max=dims.fifo_len).to(torch.int32))
    if bool(popped_valid.any()):
        state = _compress_into_cache(state, popped, popped_preds, popped_valid, dims)
    return chunk_preds, state


# ---------------------------------------------------------------------------
# NeMo checkpoint conversion
# ---------------------------------------------------------------------------


def read_nemo_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load model_weights.ckpt from a .nemo tar (or a bare .ckpt) without
    NeMo: it is a plain torch state dict. Tensors come back as f32."""
    if str(path).endswith(".nemo"):
        with tarfile.open(path) as tar:
            member = next(
                m for m in tar.getmembers() if m.name.endswith("model_weights.ckpt")
            )
            data = tar.extractfile(member).read()
        sd = torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.float() for k, v in sd.items() if isinstance(v, torch.Tensor)}


def dims_from_state_dict(sd: Dict) -> SortformerDims:
    """Infer model geometry from checkpoint shapes."""
    d_enc = sd["encoder.layers.0.self_attn.linear_q.weight"].shape[0]
    n_layers = 1 + max(
        int(m.group(1))
        for k in sd
        if (m := re.match(r"encoder\.layers\.(\d+)\.", k))
    )
    ff = sd["encoder.layers.0.feed_forward1.linear1.weight"].shape[0]
    kern = sd["encoder.layers.0.conv.depthwise_conv.weight"].shape[-1]
    sub_c = sd["encoder.pre_encode.conv.0.weight"].shape[0]
    n_mels = sd["encoder.pre_encode.out.weight"].shape[1] // sub_c * 8
    proj_key = next(k for k in sd if k.endswith("encoder_proj.weight"))
    d_model = sd[proj_key].shape[0]
    head_layers = 1 + max(
        (int(m.group(1)) for k in sd
         if (m := re.match(r"transformer_encoder\.layers\.(\d+)\.", k))),
        default=-1,
    )
    head_ff_keys = [k for k in sd if re.match(r"transformer_encoder\.layers\.0\..*dense_in.*weight", k)]
    head_ff = sd[head_ff_keys[0]].shape[0] if head_ff_keys else 4 * d_model
    spk_key = next(
        (k for k in sd if k.startswith("sortformer_modules") and k.endswith(".weight")
         and sd[k].shape[0] <= 8 and sd[k].ndim == 2),
        None,
    )
    n_spk = sd[spk_key].shape[0] if spk_key else 4
    heads = sd["encoder.layers.0.self_attn.pos_bias_u"].shape[0]
    return SortformerDims(
        n_mels=n_mels, subsampling_channels=sub_c, d_encoder=d_enc,
        encoder_layers=n_layers, encoder_heads=heads, encoder_ff=ff,
        conv_kernel=kern, d_model=d_model,
        head_layers=max(head_layers, 0) or 18,
        head_heads=8 if d_model % 8 == 0 else 4,
        head_ff=head_ff, max_speakers=n_spk,
    )


def _np32(v) -> np.ndarray:
    return (v.detach().cpu().float().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v, dtype=np.float32))


def convert_nemo_state_dict(
    sd: Dict, dims: Optional[SortformerDims] = None, dtype=torch.float32, device="cpu",
) -> Tuple[Sortformer, SortformerDims]:
    """NeMo ``diar_streaming_sortformer_4spk-v2`` state dict (torch or numpy
    tensors) → ``Sortformer`` on ``device``.

    Torch layouts map as they are (Linear [O, I], conv OIHW, depthwise
    conv1d [d, 1, K], pointwise conv1d [O, I, 1] as a Linear). Batch norm
    (conv module) folds into scale/shift, in f32 as the JAX converter folds
    it. Unmapped parameter keys raise ``ValueError``."""
    if dims is None:
        dims = dims_from_state_dict(sd)
    used = set()
    model = Sortformer(dims)

    def take(name) -> np.ndarray:
        used.add(name)
        return _np32(sd[name])

    def put(param: torch.Tensor, arr: np.ndarray, name: str) -> None:
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)}, expected {tuple(param.shape)}")
        param.data = torch.from_numpy(arr.copy())

    def lin(mod: Dense, prefix: str) -> None:
        put(mod.weight, take(f"{prefix}.weight"), prefix)
        if mod.bias is not None and f"{prefix}.bias" in sd:
            put(mod.bias, take(f"{prefix}.bias"), prefix)

    def ln(mod: LayerNorm, prefix: str) -> None:
        put(mod.scale, take(f"{prefix}.weight"), prefix)
        put(mod.bias, take(f"{prefix}.bias"), prefix)

    def conv(mod: Conv2d, name: str) -> None:
        put(mod.weight, take(f"{name}.weight"), name)  # [O, I/g, kH, kW]
        put(mod.bias, take(f"{name}.bias"), name)

    for i, p in enumerate(model.conformer):
        pre = f"encoder.layers.{i}"
        # fold BN: y = (x - mean)/sqrt(var+eps) * gamma + beta
        gamma = take(f"{pre}.conv.batch_norm.weight")
        beta = take(f"{pre}.conv.batch_norm.bias")
        mean = take(f"{pre}.conv.batch_norm.running_mean")
        var = take(f"{pre}.conv.batch_norm.running_var")
        used.add(f"{pre}.conv.batch_norm.num_batches_tracked")
        inv = gamma / np.sqrt(var + np.float32(1e-5))
        dw = take(f"{pre}.conv.depthwise_conv.weight")  # [d, 1, K]
        dw_b = (
            take(f"{pre}.conv.depthwise_conv.bias")
            if f"{pre}.conv.depthwise_conv.bias" in sd
            else np.zeros(dw.shape[0], np.float32)
        )
        ln(p.ff1_ln, f"{pre}.norm_feed_forward1")
        lin(p.ff1_in, f"{pre}.feed_forward1.linear1")
        lin(p.ff1_out, f"{pre}.feed_forward1.linear2")
        ln(p.attn_ln, f"{pre}.norm_self_att")
        for proj, name in zip("qkvo", ("linear_q", "linear_k", "linear_v", "linear_out")):
            lin(getattr(p.attn, proj), f"{pre}.self_attn.{name}")
        lin(p.attn.pos, f"{pre}.self_attn.linear_pos")
        put(p.attn.bias_u, take(f"{pre}.self_attn.pos_bias_u"), "pos_bias_u")
        put(p.attn.bias_v, take(f"{pre}.self_attn.pos_bias_v"), "pos_bias_v")
        ln(p.conv_ln, f"{pre}.norm_conv")
        # pointwise convs are [O, I, 1]: a Linear's [O, I]
        put(p.conv_pw1.weight, take(f"{pre}.conv.pointwise_conv1.weight")[:, :, 0], "pointwise_conv1")
        put(p.conv_pw1.bias, take(f"{pre}.conv.pointwise_conv1.bias"), "pointwise_conv1")
        put(p.conv_dw, dw, "depthwise_conv")
        put(p.conv_dw_b, dw_b, "depthwise_conv")
        put(p.conv_bn_scale, inv, "batch_norm")
        put(p.conv_bn_bias, beta - mean * inv, "batch_norm")
        put(p.conv_pw2.weight, take(f"{pre}.conv.pointwise_conv2.weight")[:, :, 0], "pointwise_conv2")
        put(p.conv_pw2.bias, take(f"{pre}.conv.pointwise_conv2.bias"), "pointwise_conv2")
        ln(p.ff2_ln, f"{pre}.norm_feed_forward2")
        lin(p.ff2_in, f"{pre}.feed_forward2.linear1")
        lin(p.ff2_out, f"{pre}.feed_forward2.linear2")
        ln(p.out_ln, f"{pre}.norm_out")

    for i, p in enumerate(model.head):
        pre = f"transformer_encoder.layers.{i}"
        for proj, name in zip("qkvo", ("query_net", "key_net", "value_net", "out_projection")):
            lin(getattr(p.attn, proj), f"{pre}.first_sub_layer.{name}")
        ln(p.ln1, f"{pre}.layer_norm_1")
        lin(p.ff_in, f"{pre}.second_sub_layer.dense_in")
        lin(p.ff_out, f"{pre}.second_sub_layer.dense_out")
        ln(p.ln2, f"{pre}.layer_norm_2")

    # sortformer head linears located by shape (naming drifts across NeMo
    # versions): the [n_spk, d] matrix is the speaker head; a [d, d] matrix
    # under sortformer_modules (not encoder_proj) is the hidden layer.
    proj_key = next(k for k in sd if k.endswith("encoder_proj.weight"))
    spk_out_key = spk_mid_key = None
    for k in sd:
        if not k.startswith("sortformer_modules") or not k.endswith(".weight"):
            continue
        if k == proj_key or sd[k].ndim != 2:
            continue
        if sd[k].shape[0] == dims.max_speakers:
            spk_out_key = k[: -len(".weight")]
        elif tuple(sd[k].shape) == (dims.d_model, dims.d_model):
            spk_mid_key = k[: -len(".weight")]
    if spk_out_key is None:
        raise ValueError("speaker output head not found under sortformer_modules.*")

    sub = model.sub
    conv(sub.conv0, "encoder.pre_encode.conv.0")
    conv(sub.dw1, "encoder.pre_encode.conv.2")
    conv(sub.pw1, "encoder.pre_encode.conv.3")
    conv(sub.dw2, "encoder.pre_encode.conv.5")
    conv(sub.pw2, "encoder.pre_encode.conv.6")
    lin(sub.out, "encoder.pre_encode.out")
    lin(model.proj, proj_key[: -len(".weight")])
    if spk_mid_key:
        lin(model.spk_mid, spk_mid_key)
    else:
        put(model.spk_mid.weight, np.eye(dims.d_model, dtype=np.float32), "spk_mid")
        put(model.spk_mid.bias, np.zeros(dims.d_model, np.float32), "spk_mid")
    lin(model.spk_out, spk_out_key)

    leftover = sorted(
        k for k in sd
        if k not in used
        and not any(s in k for s in ("preprocessor", "loss", "_fifo", "position"))
    )
    if leftover:
        raise ValueError(
            f"unmapped checkpoint keys ({len(leftover)}): {leftover[:10]}"
        )
    return model.to(device=device, dtype=dtype).eval().requires_grad_(False), dims


def sortformer_params_from_jax(tree, dims: SortformerDims, dtype=None, device="cpu") -> Sortformer:
    """The JAX pytree (numpy leaves: HWIO convs, [in, out] dense, stacked
    [L, ...] conformer and head layers) as a ``Sortformer`` module; ``dtype``
    None keeps the leaves' dtype."""
    model = Sortformer(dims)

    def put(param: torch.Tensor, arr) -> None:
        param.data = torch.from_numpy(np.ascontiguousarray(arr).copy())

    def put_dense(mod: Dense, p, i=None) -> None:
        w = np.asarray(p["w"] if i is None else p["w"][i])
        put(mod.weight, w.T)
        if mod.bias is not None:
            put(mod.bias, np.asarray(p["b"] if i is None else p["b"][i]))

    def put_ln(mod: LayerNorm, p, i) -> None:
        put(mod.scale, np.asarray(p["scale"][i]))
        put(mod.bias, np.asarray(p["bias"][i]))

    def put_conv(mod: Conv2d, p) -> None:
        put(mod.weight, np.asarray(p["w"]).transpose(3, 2, 0, 1))  # HWIO → OIHW
        put(mod.bias, np.asarray(p["b"]))

    for name in ("conv0", "dw1", "pw1", "dw2", "pw2"):
        jname = {"conv0": "sub0", "dw1": "sub1_dw", "pw1": "sub1_pw",
                 "dw2": "sub2_dw", "pw2": "sub2_pw"}[name]
        put_conv(getattr(model.sub, name), tree[jname])
    put_dense(model.sub.out, tree["sub_out"])
    c = tree["conformer"]
    for i, p in enumerate(model.conformer):
        for ln_name in ("ff1_ln", "attn_ln", "conv_ln", "ff2_ln", "out_ln"):
            put_ln(getattr(p, ln_name), c[ln_name], i)
        for d_name in ("ff1_in", "ff1_out", "conv_pw1", "conv_pw2", "ff2_in", "ff2_out"):
            put_dense(getattr(p, d_name), c[d_name], i)
        for proj in ("q", "k", "v", "o", "pos"):
            put_dense(getattr(p.attn, proj), c["attn"][proj], i)
        put(p.attn.bias_u, np.asarray(c["attn"]["bias_u"][i]))
        put(p.attn.bias_v, np.asarray(c["attn"]["bias_v"][i]))
        put(p.conv_dw, np.asarray(c["conv_dw"]["w"][i]).T[:, None, :])  # [K, d] → [d, 1, K]
        put(p.conv_dw_b, np.asarray(c["conv_dw"]["b"][i]))
        put(p.conv_bn_scale, np.asarray(c["conv_bn_scale"][i]))
        put(p.conv_bn_bias, np.asarray(c["conv_bn_bias"][i]))
    h = tree["head"]
    for i, p in enumerate(model.head):
        for proj in "qkvo":
            put_dense(getattr(p.attn, proj), h["attn"][proj], i)
        put_ln(p.ln1, h["ln1"], i)
        put_ln(p.ln2, h["ln2"], i)
        put_dense(p.ff_in, h["ff_in"], i)
        put_dense(p.ff_out, h["ff_out"], i)
    put_dense(model.proj, tree["proj"])
    put_dense(model.spk_mid, tree["spk_mid"])
    put_dense(model.spk_out, tree["spk_out"])
    model = model.to(device)
    return (model.to(dtype) if dtype is not None else model).eval().requires_grad_(False)
