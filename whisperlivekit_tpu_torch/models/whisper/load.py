"""Weight loading: OpenAI .pt / HF safetensors / LoRA / native → ``Whisper``
(port of whisperlivekit_tpu/models/whisper/load.py).

The same formats, key mapping, dims inference and LoRA merge as the JAX
loader (reference whisper/__init__.py:397-637), re-targeted at the port's
``nn.Module`` (models/whisper/model.py): per-layer blocks, dense weights
[out, in] as the checkpoints store them, so nothing is transposed. Each
tensor is converted on its own, on the target device: widened to f32 (exact
from f16 and bf16), then rounded once to ``dtype``. That is the one rounding
the JAX loader makes through its f32 numpy copy of the whole checkpoint, so
the parameters equal ``params_from_jax_numpy`` of the JAX loader's output
bit for bit, without that copy on the host.

Where it differs from the JAX loader:

- ``torch.load(..., weights_only=True)``, memory-mapped for zip checkpoints;
- safetensors files are read directly (an 8-byte header length, a JSON
  header, raw little-endian buffers): the ``safetensors`` package is not
  needed;
- the native format is the port's own directory, ``dims.json`` plus
  ``params.pt`` (the module's state dict). The JAX package's orbax
  directories (``params/``) are refused with an error that says so.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import re
import zipfile
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from .dims import MODEL_DIMS, ModelDimensions
from .model import Attention, Block, Dense, LayerNorm, Whisper

logger = logging.getLogger(__name__)

NATIVE_PARAMS = "params.pt"


# ---------------------------------------------------------------------------
# Raw state-dict readers
# ---------------------------------------------------------------------------


_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def _read_safetensors_file(path: Path) -> Dict[str, torch.Tensor]:
    """One .safetensors file: an 8-byte little-endian header length, a JSON
    header ``{name: {dtype, shape, data_offsets}}`` (plus ``__metadata__``),
    then the raw buffers, offsets counted from the header's end. Each tensor
    is read into its own buffer."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = _SAFETENSORS_DTYPES[info["dtype"]]
            begin, end = info["data_offsets"]
            if end == begin:
                out[name] = torch.empty(info["shape"], dtype=dtype)
                continue
            buf = bytearray(end - begin)
            f.seek(8 + n + begin)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{path}: {name} runs past the end of the file")
            out[name] = torch.frombuffer(buf, dtype=dtype).reshape(info["shape"])
    return out


def _read_safetensors_dir(path: Path) -> Dict[str, torch.Tensor]:
    index = path / "model.safetensors.index.json"
    tensors: Dict[str, torch.Tensor] = {}
    if index.exists():
        shards = sorted(set(json.loads(index.read_text())["weight_map"].values()))
        for shard in shards:
            tensors.update(_read_safetensors_file(path / shard))
    else:
        files = sorted(path.glob("*.safetensors"))
        if not files:
            raise FileNotFoundError(f"no safetensors in {path}")
        for f in files:
            tensors.update(_read_safetensors_file(f))
    return tensors


def write_safetensors(path: Path, tensors: Dict[str, torch.Tensor]) -> int:
    """Write ``tensors`` as one .safetensors file (the layout
    ``_read_safetensors_file`` reads, the header padded with spaces to 8
    bytes as the ``safetensors`` package writes it), one tensor at a time
    through the host. Returns the file's size in bytes."""
    names = {v: k for k, v in _SAFETENSORS_DTYPES.items()}
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return 8 + len(blob) + offset


def _read_torch_pt(path: Path) -> Tuple[Dict[str, torch.Tensor], Optional[dict]]:
    # weights_only: a published {"dims": dict, "model_state_dict": ...}
    # checkpoint holds only tensors and plain containers
    ckpt = torch.load(path, map_location="cpu", weights_only=True, mmap=zipfile.is_zipfile(path))
    dims_cfg = ckpt.get("dims") if isinstance(ckpt, dict) else None
    sd = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}, dims_cfg


# ---------------------------------------------------------------------------
# Dims inference
# ---------------------------------------------------------------------------


def dims_from_hf_config(cfg: dict) -> ModelDimensions:
    """Build ModelDimensions from an HF whisper config.json (reference
    whisper/__init__.py `_infer_dims_from_config`)."""
    return ModelDimensions(
        n_mels=cfg.get("num_mel_bins", 80),
        n_audio_ctx=cfg.get("max_source_positions", 1500),
        n_audio_state=cfg["d_model"],
        n_audio_head=cfg["encoder_attention_heads"],
        n_audio_layer=cfg["encoder_layers"],
        n_vocab=cfg["vocab_size"],
        n_text_ctx=cfg.get("max_target_positions", 448),
        n_text_state=cfg["d_model"],
        n_text_head=cfg["decoder_attention_heads"],
        n_text_layer=cfg["decoder_layers"],
    )


def guess_size_name(dims: ModelDimensions) -> Optional[str]:
    for name, d in MODEL_DIMS.items():
        if d == dims:
            return name
    return None


# ---------------------------------------------------------------------------
# State dict → module
# ---------------------------------------------------------------------------


def _from_canonical(
    get: Callable[[str], Optional[torch.Tensor]], dims: ModelDimensions, dtype, device
) -> Whisper:
    """Build the module from a canonical accessor ``get(name) -> tensor``.

    Canonical names follow the OpenAI layout; format adapters below remap HF
    names onto it. The module is made on the meta device and each parameter
    is replaced by its converted tensor, so no full-size placeholder is
    allocated. Key projections have no bias (the checkpoint's is ignored, as
    the JAX loader does); another missing bias is zero, which is what the
    JAX tree's bias-free dense computes."""
    with torch.device("meta"):
        model = Whisper(dims)

    def put(mod: nn.Module, attr: str, name: str, required: bool = True) -> None:
        want = getattr(mod, attr).shape
        t = get(name)
        if t is None:
            if required:
                raise KeyError(f"checkpoint has no {name!r}")
            t = torch.zeros(want)
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, the model needs {tuple(want)}")
        # a copy even where nothing converts: the source may map the file
        t = t.to(device).to(torch.float32).to(dtype, copy=True).contiguous()
        setattr(mod, attr, nn.Parameter(t, requires_grad=False))

    def lin(mod: Dense, prefix: str) -> None:
        put(mod, "weight", f"{prefix}.weight")
        if mod.bias is not None:
            put(mod, "bias", f"{prefix}.bias", required=False)

    def ln(mod: LayerNorm, prefix: str) -> None:
        put(mod, "scale", f"{prefix}.weight")
        put(mod, "bias", f"{prefix}.bias")

    def attn(mod: Attention, prefix: str) -> None:
        for proj, name in (("q", "query"), ("k", "key"), ("v", "value"), ("o", "out")):
            lin(getattr(mod, proj), f"{prefix}.{name}")

    def block(blk: Block, prefix: str) -> None:
        ln(blk.attn_ln, f"{prefix}.attn_ln")
        attn(blk.attn, f"{prefix}.attn")
        if blk.cross is not None:
            ln(blk.cross_ln, f"{prefix}.cross_attn_ln")
            attn(blk.cross, f"{prefix}.cross_attn")
        ln(blk.mlp_ln, f"{prefix}.mlp_ln")
        lin(blk.fc1, f"{prefix}.mlp.0")
        lin(blk.fc2, f"{prefix}.mlp.2")

    enc, dec = model.encoder, model.decoder
    for conv in ("conv1", "conv2"):
        put(getattr(enc, conv), "weight", f"encoder.{conv}.weight")
        put(getattr(enc, conv), "bias", f"encoder.{conv}.bias")
    for i, blk in enumerate(enc.blocks):
        block(blk, f"encoder.blocks.{i}")
    ln(enc.ln_post, "encoder.ln_post")
    put(dec, "tok_emb", "decoder.token_embedding.weight")
    put(dec, "pos_emb", "decoder.positional_embedding")
    for i, blk in enumerate(dec.blocks):
        block(blk, f"decoder.blocks.{i}")
    ln(dec.ln, "decoder.ln")
    # the sinusoid buffer, in the parameters' dtype as init_params leaves it
    return model.to(device=device, dtype=dtype)


def convert_openai_state_dict(
    sd: Dict[str, torch.Tensor], dims: ModelDimensions, dtype=torch.float32, device="cpu"
) -> Whisper:
    return _from_canonical(sd.get, dims, dtype, device)


# HF → canonical key mapping (reference `_convert_hf_state_dict`,
# whisper/__init__.py).
_HF_PATTERNS = [
    (r"^model\.", ""),
    (r"^proj_out\.", "decoder.token_embedding."),
    (r"^encoder\.layers\.", "encoder.blocks."),
    (r"^decoder\.layers\.", "decoder.blocks."),
    (r"\.self_attn\.q_proj\.", ".attn.query."),
    (r"\.self_attn\.k_proj\.", ".attn.key."),
    (r"\.self_attn\.v_proj\.", ".attn.value."),
    (r"\.self_attn\.out_proj\.", ".attn.out."),
    (r"\.self_attn_layer_norm\.", ".attn_ln."),
    (r"\.encoder_attn\.q_proj\.", ".cross_attn.query."),
    (r"\.encoder_attn\.k_proj\.", ".cross_attn.key."),
    (r"\.encoder_attn\.v_proj\.", ".cross_attn.value."),
    (r"\.encoder_attn\.out_proj\.", ".cross_attn.out."),
    (r"\.encoder_attn_layer_norm\.", ".cross_attn_ln."),
    (r"\.fc1\.", ".mlp.0."),
    (r"\.fc2\.", ".mlp.2."),
    (r"(encoder|decoder)\.blocks\.(\d+)\.final_layer_norm\.", r"\1.blocks.\2.mlp_ln."),
    (r"^encoder\.layer_norm\.", "encoder.ln_post."),
    (r"^decoder\.layer_norm\.", "decoder.ln."),
    (r"^decoder\.embed_tokens\.", "decoder.token_embedding."),
    (r"^decoder\.embed_positions\.weight$", "decoder.positional_embedding"),
    (r"^encoder\.embed_positions\.weight$", "encoder.positional_embedding"),
]


def hf_key_to_canonical(key: str) -> str:
    for pat, repl in _HF_PATTERNS:
        key = re.sub(pat, repl, key)
    return key


def convert_hf_state_dict(
    sd: Dict[str, torch.Tensor], dims: ModelDimensions, dtype=torch.float32, device="cpu"
) -> Whisper:
    canon = {hf_key_to_canonical(k): v for k, v in sd.items()}
    return _from_canonical(canon.get, dims, dtype, device)


# ---------------------------------------------------------------------------
# LoRA merge (PEFT adapter format, reference whisper/__init__.py
# `_apply_lora_adapter`: W += B @ A * alpha / r)
# ---------------------------------------------------------------------------


def apply_lora(model: Whisper, lora_dir: str | Path) -> Whisper:
    """Merge a PEFT adapter into the attention projections in place; each
    sum is in the weight's own dtype, as the JAX loader's."""
    lora_dir = Path(lora_dir)
    cfg = json.loads((lora_dir / "adapter_config.json").read_text())
    scaling = cfg.get("lora_alpha", 16) / cfg.get("r", 16)
    sd = _read_safetensors_file(lora_dir / "adapter_model.safetensors")

    merged = 0
    for key in list(sd):
        if not key.endswith("lora_A.weight"):
            continue
        base_key = key.replace("base_model.model.", "").replace(".lora_A.weight", "")
        a, b = sd[key], sd[key.replace("lora_A", "lora_B")]
        # numpy's f32 product, as the JAX loader takes it: the same bits
        delta = (b.float().numpy() @ a.float().numpy()) * scaling
        canon = hf_key_to_canonical(base_key + ".weight")
        path = _canonical_to_pytree_path(canon)
        if path is None:
            logger.warning("LoRA key %s not mappable, skipped", key)
            continue
        w = _weight_at_path(model, path)
        with torch.no_grad():
            w.add_(torch.from_numpy(delta).to(device=w.device, dtype=w.dtype))
        merged += 1
    logger.info("merged %d LoRA matrices (scale %.3f)", merged, scaling)
    return model


def _canonical_to_pytree_path(canon: str):
    m = re.match(
        r"(encoder|decoder)\.blocks\.(\d+)\.(attn|cross_attn)\.(query|key|value|out)\.weight",
        canon,
    )
    if not m:
        return None
    tower, layer, which, proj = m.groups()
    attn_key = "attn" if which == "attn" else "cross"
    proj_key = {"query": "q", "key": "k", "value": "v", "out": "o"}[proj]
    return (tower, "blocks", attn_key, proj_key, "w", int(layer))


def _weight_at_path(model: Whisper, path) -> torch.Tensor:
    """The [out, in] weight a JAX pytree path names (its [in, out] leaf)."""
    tower, _, attn_key, proj_key, _, layer = path
    blk = getattr(model, tower).blocks[layer]
    return getattr(getattr(blk, attn_key), proj_key).weight


# ---------------------------------------------------------------------------
# Native checkpoint format — fast load path after one-time conversion
# ---------------------------------------------------------------------------


def save_native(model: Whisper, dims: ModelDimensions, path: str | Path) -> None:
    """Write the module's state dict (``params.pt``) and ``dims.json`` into
    the directory ``path`` (``cli.py convert``); loading it skips the key
    mapping. Converting twice to one destination replaces the first."""
    path = Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    sd = {k: v.detach().to("cpu").contiguous() for k, v in model.state_dict().items()}
    torch.save(sd, path / NATIVE_PARAMS)
    (path / "dims.json").write_text(json.dumps(dataclasses.asdict(dims)))


def load_native(path: str | Path, dtype=None, device="cpu") -> Tuple[Whisper, ModelDimensions]:
    path = Path(path).resolve()
    params = path / NATIVE_PARAMS
    if not params.is_file():
        if (path / "params").is_dir():
            raise ValueError(
                f"{path} is an orbax checkpoint of the JAX package (its `wlk convert`), "
                "which this package cannot read; convert the original .pt or HF checkpoint "
                "with `python -m whisperlivekit_tpu_torch.cli convert`"
            )
        raise FileNotFoundError(f"no {NATIVE_PARAMS} in {path}")
    dims = ModelDimensions(**json.loads((path / "dims.json").read_text()))
    sd = torch.load(params, map_location="cpu", weights_only=True)
    with torch.device("meta"):
        model = Whisper(dims)
    model.load_state_dict(sd, assign=True)
    model = model.to(device=device, dtype=dtype or model.dtype)
    return model.requires_grad_(False), dims


# ---------------------------------------------------------------------------
# Top-level loader
# ---------------------------------------------------------------------------


def detect_format(path: Path) -> str:
    """'openai' (.pt), 'native' (a dir with dims.json), 'hf' (safetensors
    dir), or 'unknown'.

    Mirrors the reference's format detection (model_paths.py:8-215) minus the
    CT2/MLX formats.
    """
    if path.is_file() and path.suffix in (".pt", ".bin", ".pth"):
        return "openai"
    if path.is_dir() and (path / "dims.json").exists():
        return "native"
    if path.is_dir():
        if (path / "config.json").exists() and (
            list(path.glob("*.safetensors")) or (path / "model.safetensors.index.json").exists()
        ):
            return "hf"
        if list(path.glob("*.pt")):
            return "openai"
    return "unknown"


def load_model(
    name_or_path: str,
    dtype=torch.bfloat16,
    lora_path: Optional[str] = None,
    cache_dir: Optional[str] = None,
    device=None,
) -> Tuple[Whisper, ModelDimensions, Optional[str]]:
    """Load weights by size name (resolved in local caches only) or path.
    ``device=None`` means the card (``engine.core.default_device``, which
    raises without CUDA).

    Returns (model, dims, size_name or None).
    """
    if device is None:
        from ...engine.core import default_device

        device = default_device()
    path = Path(name_or_path).expanduser()
    size_name: Optional[str] = None

    if not path.exists() and name_or_path in MODEL_DIMS:
        size_name = name_or_path
        resolved = _resolve_size_to_path(name_or_path, cache_dir)
        if resolved is None:
            raise FileNotFoundError(
                f"no local weights for '{name_or_path}'; run `python -m whisperlivekit_tpu_torch.cli "
                f"pull {name_or_path}` with network access, or pass --model-path"
            )
        path = resolved

    fmt = detect_format(path)
    if fmt == "native":
        model, dims = load_native(path, dtype=dtype, device=device)
        if lora_path:
            model = apply_lora(model, lora_path)
        return model, dims, guess_size_name(dims)
    if fmt == "openai":
        f = path if path.is_file() else next(iter(path.glob("*.pt")))
        sd, dims_cfg = _read_torch_pt(f)
        dims = ModelDimensions(**dims_cfg) if dims_cfg else _infer_dims_from_openai_sd(sd)
        model = convert_openai_state_dict(sd, dims, dtype, device)
    elif fmt == "hf":
        cfg = json.loads((path / "config.json").read_text())
        dims = dims_from_hf_config(cfg)
        sd = _read_safetensors_dir(path)
        model = convert_hf_state_dict(sd, dims, dtype, device)
    else:
        raise ValueError(f"unrecognized model format at {path}")

    if size_name is None:
        size_name = guess_size_name(dims)
    if lora_path:
        model = apply_lora(model, lora_path)
    return model, dims, size_name


def _resolve_size_to_path(size: str, cache_dir: Optional[str]) -> Optional[Path]:
    """Search local caches for weights of a named size (HF hub cache layout,
    then ``<root>/<size>.pt``). Never downloads."""
    from .dims import HF_REPOS

    roots = []
    if cache_dir:
        roots.append(Path(cache_dir))
    roots.append(Path.home() / ".cache" / "huggingface" / "hub")
    roots.append(Path.home() / ".cache" / "whisper")
    repo = HF_REPOS.get(size, f"openai/whisper-{size}")
    for root in roots:
        if not root.exists():
            continue
        hub_dir = root / f"models--{repo.replace('/', '--')}" / "snapshots"
        if hub_dir.exists():
            snaps = sorted(hub_dir.iterdir())
            if snaps:
                return snaps[-1]
        pt = root / f"{size}.pt"
        if pt.exists():
            return pt
    return None


def _infer_dims_from_openai_sd(sd: Dict[str, torch.Tensor]) -> ModelDimensions:
    n_mels = sd["encoder.conv1.weight"].shape[1]
    d = sd["encoder.conv1.weight"].shape[0]
    n_audio_layer = 1 + max(
        int(m.group(1)) for k in sd if (m := re.match(r"encoder\.blocks\.(\d+)\.", k))
    )
    n_text_layer = 1 + max(
        int(m.group(1)) for k in sd if (m := re.match(r"decoder\.blocks\.(\d+)\.", k))
    )
    n_vocab, _ = sd["decoder.token_embedding.weight"].shape
    n_text_ctx = sd["decoder.positional_embedding"].shape[0]
    head_dim = 64
    return ModelDimensions(
        n_mels=n_mels,
        n_audio_ctx=1500,
        n_audio_state=d,
        n_audio_head=d // head_dim,
        n_audio_layer=n_audio_layer,
        n_vocab=n_vocab,
        n_text_ctx=n_text_ctx,
        n_text_state=d,
        n_text_head=d // head_dim,
        n_text_layer=n_text_layer,
    )
