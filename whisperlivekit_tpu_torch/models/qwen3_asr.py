"""Qwen3-ASR with a causal (append-only) audio tower in PyTorch (port of
whisperlivekit_tpu/models/qwen3_asr.py).

Each ~2 s audio block is encoded exactly once by a block-causal encoder
(a frame attends to every frame up to the end of its own block) with an
explicit KV cache, so ``encode_block`` appends one block's KV and returns
its features; the text tower (models/llama.py, Qwen3 with q/k norms)
consumes ``[prompt | audio embeds | hypothesis]`` through one decoder
cache, and new audio embeds overwrite the stale hypothesis region.

The weights live in ``nn.Module``s (``Qwen3ASR``: ``tower`` and ``text``);
the forward passes are functions with the JAX module's names and layouts.
``TowerCache`` [L, B, T, H, Dh] and the text cache are written IN PLACE
(JAX donates them and returns new ones). The tower's attention is two
widened ``torch.matmul``s, as JAX's ``einsum`` (no Pallas kernel there).
Its convolutions are unfolds and products, so cuDNN's TF32 default for
convolutions does not apply. ``decode_hypothesis`` is a host loop of
decoder steps that reads ``done.all()`` once a step, where JAX compiles
one ``while_loop``; its caller may hand it the step (the pooled service
replays one CUDA graph a step).

``convert_hf_state_dict`` maps `qfuxa/qwen3-asr-0.6b-streaming`-style
checkpoints (audio_tower.* / multi_modal_projector.* / model.* naming) and
raises on unmapped audio-tower keys; ``qwen3_params_from_jax`` converts the
JAX pytree, the bridge the parity tests use.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..engine.trace import TRACER
from . import llama as lm
from .llama import _dense
from .whisper.model import Dense, LayerNorm, _linear_f32, layer_norm

SAMPLE_RATE = 16000
HOP = 160  # mel hop; 1 encoder frame = 2 mel frames = 20 ms


@dataclass(frozen=True)
class Qwen3ASRDims:
    """Tower geometry. Defaults follow the 0.6b streaming checkpoint scale."""

    text: lm.LlamaDims = None
    n_mels: int = 128
    d_audio: int = 1024
    audio_heads: int = 16
    audio_layers: int = 24
    audio_ff: int = 4096
    downsample: int = 4          # encoder frames per audio token (80 ms/token)
    block_frames: int = 100      # encoder frames per causal block (2 s)
    max_frames: int = 1500       # KV capacity (30 s)
    audio_token_id: int = 151676

    @property
    def block_tokens(self) -> int:
        return self.block_frames // self.downsample

    @property
    def block_samples(self) -> int:
        return self.block_frames * 2 * HOP

    def window_blocks(self, window_s: float) -> int:
        """Blocks the segment policy admits before a flush (the flush check
        fires once blocks*block_s >= window_s, before the NEXT append)."""
        block_s = self.block_samples / (16000)
        return max(int(math.ceil(window_s / block_s)), 1)


DEV_TINY_TEXT = lm.LlamaDims(
    vocab_size=512, hidden_size=64, n_layers=2, n_heads=4, n_kv_heads=2,
    intermediate_size=128, head_dim=16, qk_norm=True,
)

DEV_TINY = Qwen3ASRDims(
    text=DEV_TINY_TEXT, n_mels=80, d_audio=64, audio_heads=4, audio_layers=2,
    audio_ff=128, block_frames=20, max_frames=200,
)

#: Qwen/Qwen3-0.6B's text tower (its published config.json), the text half
#: of qfuxa/qwen3-asr-0.6b-streaming: the widths of the full 0.6B model
QWEN3_0_6B_TEXT = lm.LlamaDims(
    vocab_size=151936, hidden_size=1024, n_layers=28, n_heads=16, n_kv_heads=8,
    intermediate_size=3072, head_dim=128, rope_theta=1e6, rms_eps=1e-6,
    max_positions=40960, tie_embeddings=True, qk_norm=True,
)

#: openai/whisper-large-v3's encoder (its config.json), the audio tower of
#: Uni-MoE-2.0-Omni, whose config gives only its width (``whisper_hidden_size``)
WHISPER_LARGE_V3_TOWER = dict(n_mels=128, d_audio=1280, audio_heads=20, audio_layers=32, audio_ff=5120,
                              max_frames=1500)


def dims_from_grin_qwen2_vl(cfg: dict, audio: Optional[dict] = None) -> Qwen3ASRDims:
    """Uni-MoE-2.0-Omni's audio-in, text-out path from its published
    config.json (``model_type`` ``grin_qwen2_vl``): a Whisper-large encoder
    whose ``whisper_query_tokens_size`` tokens cover ``whisper_audio_time``
    seconds (50 encoder frames a second, so ``downsample`` frames a token),
    a linear projector, and Qwen2's text tower (q/k/v biases, no q/k norms)
    whose FFN is the dynamic mixture (``mlp_dynamic_*``, ``mlp_fixed_*``).
    ``audio`` overrides the tower's sizes (``num_mel_bins``, ``d_model``,
    ``encoder_attention_heads``, ``encoder_layers``, ``encoder_ffn_dim``,
    ``downsample``, ``block_frames``, ``max_frames``); unset ones are
    whisper-large-v3's. The vision tower and the speech generator are not
    built."""
    audio = audio or {}
    if cfg.get("whisper_projector_type", "linear") != "linear":
        raise ValueError(f"projector {cfg['whisper_projector_type']!r}: only 'linear' is built")
    if cfg.get("use_sliding_window"):
        raise ValueError("use_sliding_window: only full attention is built")
    base = dataclasses.asdict(lm.dims_from_hf_config(cfg))
    base["intermediate_size"] = cfg.get("dynamic_intermediate_size", cfg["intermediate_size"])
    text = lm.MoEDims(
        **base, n_routed_experts=cfg["mlp_dynamic_expert_num"], n_null_experts=cfg.get("mlp_dynamic_null_expert_num", 0),
        n_shared_experts=cfg.get("mlp_fixed_expert_num", 0), shared_expert_size=cfg.get("shared_intermediate_size", 0),
        moe_top_p=float(cfg["mlp_dynamic_top_p"]), moe_top_k=int(cfg["mlp_dynamic_top_k"]))
    per_token = 50 * cfg.get("whisper_audio_time", 20) / cfg.get("whisper_query_tokens_size", 200)
    tower = dict(WHISPER_LARGE_V3_TOWER, d_audio=cfg.get("whisper_hidden_size", 1280), downsample=int(per_token))
    keys = dict(n_mels="num_mel_bins", d_audio="d_model", audio_heads="encoder_attention_heads",
                audio_layers="encoder_layers", audio_ff="encoder_ffn_dim", downsample="downsample",
                block_frames="block_frames", max_frames="max_frames")
    tower.update({field: audio[key] for field, key in keys.items() if key in audio})
    return Qwen3ASRDims(text=text, **tower)


#: HIT-TMG/Uni-MoE-2.0-Omni at its published widths (config.json): 28
#: Qwen2 layers of hidden 3584, 28 query and 4 KV heads, an untied
#: vocabulary of 152064, 2 shared experts 2368 wide, 4 routed 18944 wide
#: and a null expert, top-p 0.7 capped at 2; a whisper-large-v3 tower,
#: 200 tokens for 20 s
UNIMOE_2_OMNI = dims_from_grin_qwen2_vl(dict(
    model_type="grin_qwen2_vl", vocab_size=152064, hidden_size=3584, num_hidden_layers=28,
    num_attention_heads=28, num_key_value_heads=4, intermediate_size=18944, dynamic_intermediate_size=18944,
    shared_intermediate_size=2368, rope_theta=1000000, rms_norm_eps=1e-06, max_position_embeddings=128000,
    tie_word_embeddings=False, use_sliding_window=False, mlp_dynamic_expert_num=4, mlp_dynamic_null_expert_num=1,
    mlp_fixed_expert_num=2, mlp_dynamic_top_p=0.7, mlp_dynamic_top_k=2, whisper_hidden_size=1280,
    whisper_projector_type="linear", whisper_query_tokens_size=200, whisper_audio_time=20))


# ---------------------------------------------------------------------------
# Modules (weights only; the forward passes are the functions below)
# ---------------------------------------------------------------------------


class Conv(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, 3))  # OIH, as in JAX and HF
        self.bias = nn.Parameter(torch.zeros(c_out))


class TowerLayer(nn.Module):
    def __init__(self, d: int, ff: int):
        super().__init__()
        self.attn_ln = LayerNorm(d)
        self.q = Dense(d, d)
        self.k = Dense(d, d, bias=False)
        self.v = Dense(d, d)
        self.o = Dense(d, d)
        self.mlp_ln = LayerNorm(d)
        self.fc1 = Dense(d, ff)
        self.fc2 = Dense(ff, d)


class Tower(nn.Module):
    """Conv front end, block-causal encoder, and the audio-token projection
    (one linear; ``proj2`` is voxtral's second gelu-MLP layer, or None)."""

    def __init__(self, dims: Qwen3ASRDims, proj2: bool = False):
        super().__init__()
        d = dims.d_audio
        self.conv1 = Conv(dims.n_mels, d)
        self.conv2 = Conv(d, d)
        self.blocks = nn.ModuleList(TowerLayer(d, dims.audio_ff) for _ in range(dims.audio_layers))
        self.ln_post = LayerNorm(d)
        self.proj = Dense(dims.downsample * d, dims.text.hidden_size, bias=False)
        self.proj2 = Dense(dims.text.hidden_size, dims.text.hidden_size, bias=False) if proj2 else None
        self.register_buffer("pos", torch.from_numpy(_sinusoids(dims.max_frames, d)), persistent=False)


class Qwen3ASR(nn.Module):
    def __init__(self, dims: Qwen3ASRDims, proj2: bool = False, lm_head: bool = True):
        super().__init__()
        self.dims = dims
        self.tower = Tower(dims, proj2)
        self.text = lm.Llama(dims.text, lm_head=lm_head)

    @property
    def dtype(self) -> torch.dtype:
        return self.text.dtype

    @property
    def device(self) -> torch.device:
        return self.text.device


def init_params(dims: Qwen3ASRDims, generator: torch.Generator, dtype=torch.float32, device="cpu") -> Qwen3ASR:
    """Random weights with JAX ``init_params``' shapes and scales (dense
    N(0, 1/d_in), conv N(0, 1/(3 C_in)), zero biases, unit LN scales) from
    ``generator``, drawn on its device; the numbers differ from JAX's."""
    model = Qwen3ASR(dims, lm_head=not dims.text.tie_embeddings)
    gdev = generator.device
    with torch.no_grad():
        for mod in model.tower.modules():
            if isinstance(mod, (Dense, Conv)):
                fan_in = mod.weight.shape[1] * (3 if isinstance(mod, Conv) else 1)
                mod.weight.data = torch.randn(mod.weight.shape, generator=generator, device=gdev) * fan_in ** -0.5
    model.text = lm.init_params(dims.text, generator, dtype=dtype, device=device)
    return model.to(device=device, dtype=dtype).requires_grad_(False)


def qwen3_params_from_jax(tree, dims: Qwen3ASRDims, dtype=None, device="cpu") -> Qwen3ASR:
    """The JAX pytree ({"tower", "text"}, numpy leaves: stacked [L, ...]
    blocks, [in, out] dense weights, OIH convs) as a ``Qwen3ASR`` module;
    ``dtype`` None keeps the leaves' dtype."""
    tw = tree["tower"]
    model = Qwen3ASR(dims, proj2="proj2" in tw)

    def arr(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True))

    def put_dense(mod: Dense, p, i=None) -> None:
        w = np.asarray(p["w"])
        mod.weight.data = arr((w if i is None else w[i]).T)
        if mod.bias is not None:
            mod.bias.data = arr(np.asarray(p["b"])[i])

    def put_ln(mod: LayerNorm, p, i=None) -> None:
        sel = (lambda a: a) if i is None else (lambda a: np.asarray(a)[i])  # noqa: E731
        mod.scale.data, mod.bias.data = arr(sel(p["scale"])), arr(sel(p["bias"]))

    for conv in ("conv1", "conv2"):
        getattr(model.tower, conv).weight.data = arr(tw[conv]["w"])
        getattr(model.tower, conv).bias.data = arr(tw[conv]["b"])
    bp = tw["blocks"]
    for i, blk in enumerate(model.tower.blocks):
        put_ln(blk.attn_ln, bp["attn_ln"], i)
        put_ln(blk.mlp_ln, bp["mlp_ln"], i)
        for name in ("q", "k", "v", "o", "fc1", "fc2"):
            put_dense(getattr(blk, name), bp[name], i)
    put_ln(model.tower.ln_post, tw["ln_post"])
    put_dense(model.tower.proj, tw["proj"])
    if model.tower.proj2 is not None:
        put_dense(model.tower.proj2, tw["proj2"])
    model.text = lm.llama_params_from_jax(tree["text"], dims.text)
    model = model.to(device)
    return (model.to(dtype) if dtype is not None else model).requires_grad_(False)


# ---------------------------------------------------------------------------
# Block-causal audio tower with KV cache
# ---------------------------------------------------------------------------


class TowerCache(NamedTuple):
    """Append-only per-layer KV over encoder frames: [L, B, frames, H, Dh],
    written in place by ``encode_block``."""

    k: torch.Tensor
    v: torch.Tensor


def init_tower_cache(
    dims: Qwen3ASRDims, batch: int, dtype=torch.float32, frames: Optional[int] = None, device="cpu"
) -> TowerCache:
    """``frames`` bounds the KV timeline (the segment policy flushes at
    window_s, so ceil(window/block)*block_frames suffices)."""
    shape = (
        dims.audio_layers, batch, frames or dims.max_frames,
        dims.audio_heads, dims.d_audio // dims.audio_heads,
    )
    return TowerCache(torch.zeros(shape, dtype=dtype, device=device),
                      torch.zeros(shape, dtype=dtype, device=device))


def _sinusoids(length: int, channels: int) -> np.ndarray:
    inc = math.log(10000) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def _conv1d(x: torch.Tensor, p: Conv, stride: int) -> torch.Tensor:
    """Kernel 3, padding 1: the padded input's windows (an unfold) times the
    OIH weight, an f32 sum plus the f32 bias, rounded once to x's dtype."""
    B, C, _ = x.shape
    cols = F.pad(x, (1, 1)).unfold(2, 3, stride)               # [B, C, T_out, 3]
    cols = cols.permute(0, 2, 1, 3).reshape(B, -1, C * 3)      # [B, T_out, C*3]
    y = _linear_f32(cols, p.weight.reshape(p.weight.shape[0], C * 3)) + p.bias.float()
    return y.transpose(1, 2).to(x.dtype)                       # [B, C_out, T_out]


def _layer_norm(x: torch.Tensor, p: LayerNorm, eps: float = 1e-5) -> torch.Tensor:
    if x.is_cuda:
        return F.layer_norm(x.float(), x.shape[-1:], p.scale.float(), p.bias.float(), eps).to(x.dtype)
    return layer_norm(x, p, eps)


def encode_block(
    model: Qwen3ASR,
    mel_block: torch.Tensor,    # [B, n_mels, 2*block_frames]
    cache: TowerCache,
    start_frame: torch.Tensor,  # [B] frame position where this block begins
    dims: Qwen3ASRDims,
    lanes: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, TowerCache]:
    """Encode ONE audio block causally: append its KV, attend over everything
    cached so far (block-causal: full attention within the block + all
    previous frames). Returns (block features [B, block_frames, D], cache).

    With ``lanes`` [B], ``cache`` is a lane pool [L, C, T, H, Dh]: batch row
    b reads and writes pool row ``lanes[b]``, one layer at a time
    (``llama.forward``'s rule)."""
    tw = model.tower
    B = mel_block.shape[0]
    Fr = dims.block_frames
    n_head = dims.audio_heads
    dh = dims.d_audio // n_head
    dev = mel_block.device

    x = mel_block.to(tw.conv1.weight.dtype)
    x = F.gelu(_conv1d(x, tw.conv1, 1))
    x = F.gelu(_conv1d(x, tw.conv2, 2))
    x = x.transpose(1, 2)  # [B, F, D]

    T_cache = cache.k.shape[2]  # KV timeline width (<= dims.max_frames)
    idx = torch.clamp(start_frame.long()[:, None] + torch.arange(Fr, device=dev)[None, :],
                      max=dims.max_frames - 1)
    x = x + tw.pos[idx].to(x.dtype)

    write_pos = torch.clamp(idx, max=T_cache - 1)  # [B, F]
    if lanes is None:
        write_rows = torch.arange(B, device=dev)[:, None]
    else:
        write_rows = lanes[:, None]
    # keys valid iff already cached (< start) or inside this block
    key_idx = torch.arange(T_cache, device=dev)[None, None, :]
    mask = torch.zeros((B, 1, T_cache), dtype=torch.float32, device=dev).masked_fill(
        key_idx >= (start_frame.long() + Fr)[:, None, None], float("-inf"))

    for li, bp in enumerate(tw.blocks):
        ck, cv = cache.k[li], cache.v[li]
        h = _layer_norm(x, bp.attn_ln)
        q = _dense(h, bp.q).reshape(B, Fr, n_head, dh)
        ck[write_rows, write_pos] = _dense(h, bp.k).reshape(B, Fr, n_head, dh).to(ck.dtype)
        cv[write_rows, write_pos] = _dense(h, bp.v).reshape(B, Fr, n_head, dh).to(cv.dtype)
        if lanes is not None:
            ck, cv = ck[lanes], cv[lanes]
        scores = torch.matmul(q.transpose(1, 2).float(), ck.permute(0, 2, 3, 1).float())  # [B,H,F,T]
        probs = torch.softmax(scores * (dh ** -0.5) + mask[:, None], dim=-1)
        attn = torch.matmul(probs.to(cv.dtype).float(), cv.transpose(1, 2).float())
        attn = attn.transpose(1, 2).to(x.dtype)                                             # [B,F,H,Dh]
        x = x + _dense(attn.reshape(B, Fr, dims.d_audio), bp.o)
        h = _layer_norm(x, bp.mlp_ln)
        x = x + _dense(F.gelu(_dense(h, bp.fc1)), bp.fc2)
    return _layer_norm(x, tw.ln_post), cache


def project_audio_tokens(model: Qwen3ASR, feats: torch.Tensor, dims: Qwen3ASRDims) -> torch.Tensor:
    """Group ``downsample`` encoder frames into one audio token embedding:
    [B, F, D] -> [B, F//downsample, text_hidden]. One linear (qwen3) or a
    gelu MLP when ``proj2`` is present (voxtral's multi_modal_projector)."""
    B, Fr, D = feats.shape
    grouped = feats.reshape(B, Fr // dims.downsample, dims.downsample * D)
    out = _dense(grouped, model.tower.proj)
    if model.tower.proj2 is not None:
        out = _dense(F.gelu(out), model.tower.proj2)
    return out


# ---------------------------------------------------------------------------
# Streaming entry points
# ---------------------------------------------------------------------------


@torch.no_grad()
def append_audio_block(
    model: Qwen3ASR,
    mel_block: torch.Tensor,    # [B, n_mels, 2*block_frames]
    tower_cache: TowerCache,
    text_cache: lm.LlamaCache,
    start_frame: torch.Tensor,  # [B] tower frame position
    text_pos: torch.Tensor,     # [B] decoder cache fill (audio prefix end)
    dims: Qwen3ASRDims,
    lanes: Optional[torch.Tensor] = None,
) -> Tuple[TowerCache, lm.LlamaCache, torch.Tensor]:
    """Encode one block causally and run its audio-token embeddings through
    the text decoder (appending decoder KV). Returns the caches (updated in
    place) and the decoder logits after the block [B, V]. With ``lanes``
    both caches are lane pools (``encode_block``)."""
    feats, tower_cache = encode_block(model, mel_block, tower_cache, start_frame, dims, lanes)
    embeds = project_audio_tokens(model, feats, dims)
    logits, text_cache = lm.forward(model.text, embeds, text_pos, text_cache, dims.text, last_only=True,
                                    lanes=lanes)
    return tower_cache, text_cache, logits[:, -1]


@torch.no_grad()
def decode_hypothesis(
    model: Qwen3ASR,
    text_cache: lm.LlamaCache,
    start_tokens: torch.Tensor,  # [B, S0] forced prefix (e.g. assistant header)
    text_pos: torch.Tensor,      # [B] position where the hypothesis starts
    eos_id: int,
    dims: Qwen3ASRDims,
    max_new: int = 48,
    step: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, lm.LlamaCache]:
    """Greedy hypothesis from the current audio prefix. The hypothesis KV is
    written AFTER the audio prefix and is deliberately disposable: the next
    audio block overwrites it (no cache copies per tick).

    Returns (tokens [B, max_new], n_valid [B], cache): ``n`` counts the steps
    before each lane's EOS, and the slots after it hold ``eos_id``. The
    loop stops once every lane is done; the step that would only feed the
    last token back (its logits unread) is not run.

    ``step``, where given, runs each greedy step after the start prefix:
    ``step(tok [B], pos [B]) -> logits [B, V]`` f32, the forward of one token
    a lane at ``pos`` into ``text_cache`` (the pooled service's CUDA graph,
    ``streaming/qwen3_batch.py`` ``DecodeGraphs``); the prefix's forward is
    this function's own. Without it each step is ``llama.forward``.

    Each iteration is a ``causal.decode_step`` span: the read of the lanes
    still active, which waits for the previous forward, and the enqueue of
    the next. Counters: ``causal.decode_steps`` (forwards of one token a
    lane), ``causal.decode_rows`` (rows those and the start prefix ran,
    padding included), ``causal.logits_rows``."""
    tp = model.text
    dev = start_tokens.device
    logits, text_cache = lm.forward(tp, lm.embed_tokens(tp, start_tokens), text_pos, text_cache,
                                    dims.text, last_only=True)
    logits = logits[:, -1]
    B = start_tokens.shape[0]
    TRACER.count("causal.decode_rows", B * start_tokens.shape[1])
    TRACER.count("causal.logits_rows", B)
    pos0 = text_pos.long() + start_tokens.shape[1]
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    tokens = torch.full((B, max_new), eos_id, dtype=torch.long, device=dev)
    n = torch.zeros(B, dtype=torch.long, device=dev)
    eos = torch.full((B,), eos_id, dtype=torch.long, device=dev)
    for k in range(max_new):
        with TRACER.span("causal.decode_step", lanes=B):
            tok = torch.argmax(logits, dim=-1)
            now_done = done | (tok == eos_id)
            tokens[:, k] = torch.where(done, eos, tok)
            n = torch.where(now_done, n, torch.full_like(n, k + 1))
            done = now_done
            if k + 1 == max_new or bool(done.all()):
                break
            if step is None:
                logits, text_cache = lm.forward(tp, lm.embed_tokens(tp, tok[:, None]), pos0 + k, text_cache,
                                                dims.text, last_only=True)
                logits = logits[:, -1]
            else:
                logits = step(tok, pos0 + k)
        TRACER.count("causal.decode_steps")
        TRACER.count("causal.decode_rows", B)
        TRACER.count("causal.logits_rows", B)
    return tokens, n, text_cache


# ---------------------------------------------------------------------------
# HF checkpoint conversion
# ---------------------------------------------------------------------------


def has_qk_norm(sd: Dict[str, torch.Tensor], text_prefix: str = "model.") -> bool:
    """Whether a checkpoint's text tower carries Qwen3's q/k norms (the HF
    config has no field for them)."""
    return f"{text_prefix}layers.0.self_attn.q_norm.weight" in sd


def convert_hf_state_dict(
    sd: Dict[str, torch.Tensor],
    dims: Qwen3ASRDims,
    dtype=torch.float32,
    text_prefix: str = "model.",
    device="cpu",
) -> Qwen3ASR:
    """Map a qwen3-asr HF checkpoint (audio_tower.* + model.* naming, e.g.
    qfuxa/qwen3-asr-0.6b-streaming; voxtral-realtime uses
    text_prefix="language_model.model.") into a ``Qwen3ASR``. Unmapped
    audio-tower keys raise so silent omissions cannot ship. A checkpoint
    with ``multi_modal_projector.linear_2.weight`` gets the gelu-MLP
    projector (``linear_1`` then ``linear_2``)."""
    used = set()

    def take(name) -> torch.Tensor:
        used.add(name)
        return sd[name].to(device=device, dtype=dtype)

    mlp = "multi_modal_projector.linear_2.weight" in sd
    head_prefix = text_prefix[: -len("model.")]
    model = Qwen3ASR(dims, proj2=mlp, lm_head=False)

    def lin(mod: Dense, prefix: str) -> None:
        mod.weight.data = take(f"{prefix}.weight")
        if mod.bias is not None:
            if f"{prefix}.bias" in sd:
                mod.bias.data = take(f"{prefix}.bias")
            else:
                mod.bias.data = torch.zeros(mod.bias.shape, dtype=dtype, device=device)

    def ln(mod: LayerNorm, prefix: str) -> None:
        mod.scale.data, mod.bias.data = take(f"{prefix}.weight"), take(f"{prefix}.bias")

    at = "audio_tower"
    tw = model.tower
    for i, blk in enumerate(tw.blocks):
        p = f"{at}.layers.{i}"
        ln(blk.attn_ln, f"{p}.self_attn_layer_norm")
        lin(blk.q, f"{p}.self_attn.q_proj")
        lin(blk.k, f"{p}.self_attn.k_proj")
        lin(blk.v, f"{p}.self_attn.v_proj")
        lin(blk.o, f"{p}.self_attn.out_proj")
        ln(blk.mlp_ln, f"{p}.final_layer_norm")
        lin(blk.fc1, f"{p}.fc1")
        lin(blk.fc2, f"{p}.fc2")
    for conv in ("conv1", "conv2"):
        getattr(tw, conv).weight.data = take(f"{at}.{conv}.weight")
        getattr(tw, conv).bias.data = take(f"{at}.{conv}.bias")
    ln(tw.ln_post, f"{at}.layer_norm")
    if mlp:
        tw.proj.weight.data = take("multi_modal_projector.linear_1.weight")
        tw.proj2.weight.data = take("multi_modal_projector.linear_2.weight")
    else:
        tw.proj.weight.data = take("multi_modal_projector.linear.weight")
    tw.pos = tw.pos.to(device)

    model.text = lm.convert_hf_state_dict(
        {k: v for k, v in sd.items() if k.startswith((text_prefix, head_prefix + "lm_head."))},
        dims.text, dtype=dtype, prefix=text_prefix, device=device,
    )
    leftover = [
        k for k in sd
        if k.startswith(at) and k not in used and "rotary" not in k and "position" not in k
    ]
    if leftover:
        raise ValueError(f"unmapped audio tower keys: {leftover[:8]} (+{max(len(leftover) - 8, 0)})")
    return model.requires_grad_(False)
