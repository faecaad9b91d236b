"""The port's checkpoint loader (whisperlivekit_tpu_torch/models/whisper/load.py)
against the JAX package's, on the CPU: both read the same files, written
in ``tmp_path`` by tests/torch_ckpt.py from seeded numpy arrays:

- an OpenAI ``.pt`` with ``dims`` (f16 tensors, as published) and one
  without (f32, dims inferred);
- an HF directory (``config.json`` + safetensors), as one file and sharded
  with an index;
- each of these with and without a PEFT LoRA adapter directory,

and the port's ``Whisper`` module must equal ``params_from_jax_numpy`` of
the JAX loader's tree bit for bit, in f32 and in bf16. Also: the format
helpers, the local size resolution over a fake cache tree, the port's own
native format (a bit-exact round trip; a JAX orbax directory is refused) and
the raw safetensors reader against the ``safetensors`` package.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperlivekit_tpu.models.whisper import load as JL
from whisperlivekit_tpu.models.whisper.dims import MODEL_DIMS
from whisperlivekit_tpu_torch.models.whisper import load as TL
from whisperlivekit_tpu_torch.models.whisper.dims import MODEL_DIMS as PORT_DIMS
from whisperlivekit_tpu_torch.models.whisper.model import params_from_jax_numpy, quantize_decoder_f8
from torch_ckpt import canonical_state_dict, hf_config, hf_name, write_hf, write_lora, write_openai

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

# dev-tiny widths with a 3-layer encoder, a 2-layer decoder and a small
# vocabulary: every key kind, a few MB per file
DIMS = dataclasses.replace(MODEL_DIMS["dev-tiny"], n_audio_layer=3, n_vocab=512, n_text_ctx=64)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    sd = canonical_state_dict(DIMS, seed=11)
    return {
        "openai_dims": write_openai(root / "dims.pt", sd, DIMS),
        "openai_nodims": write_openai(root / "nodims.pt", sd, None, np.float32),
        "hf_single": write_hf(root / "hf_single", sd, DIMS),
        "hf_sharded": write_hf(root / "hf_sharded", sd, DIMS, shards=3, dtype=np.float16),
        "lora": write_lora(root / "lora", DIMS, seed=12),
    }


def assert_same_module(got, want, buffers=True):
    """Every parameter (and buffer): same name, dtype, shape and bits."""
    g, w = dict(got.named_parameters()), dict(want.named_parameters())
    assert sorted(g) == sorted(w)
    gb, wb = (dict(got.named_buffers()), dict(want.named_buffers())) if buffers else ({}, {})
    assert sorted(gb) == sorted(wb)
    for name in sorted(g) + sorted(gb):
        a = g.get(name, gb.get(name))
        b = w.get(name, wb.get(name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
        assert torch.equal(a.detach().view(bits), b.detach().view(bits)), name


def bridged(tree, dims, dtype):
    return params_from_jax_numpy(jax.tree.map(np.asarray, tree), dims, dtype=dtype)


@pytest.mark.parametrize("lora", [False, True], ids=["plain", "lora"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["openai_dims", "openai_nodims", "hf_single", "hf_sharded"])
def test_load_model_matches_jax_bit_for_bit(files, fmt, dtype, lora):
    lora_path = str(files["lora"]) if lora else None
    jtree, jdims, jname = JL.load_model(str(files[fmt]), dtype=getattr(jnp, dtype), lora_path=lora_path)
    model, dims, name = TL.load_model(str(files[fmt]), dtype=getattr(torch, dtype), lora_path=lora_path,
                                      device="cpu")
    # without dims, both infer 64-wide heads from the width
    want = dataclasses.replace(DIMS, n_audio_head=1, n_text_head=1) if fmt == "openai_nodims" else DIMS
    assert dataclasses.asdict(dims) == dataclasses.asdict(jdims) == dataclasses.asdict(want)
    assert name == jname is None
    assert model.device.type == "cpu" and not any(p.requires_grad for p in model.parameters())
    assert model.encoder.blocks[0].attn.k.bias is None  # key projections carry no bias
    assert_same_module(model, bridged(jtree, jdims, getattr(torch, dtype)))


def test_lora_changes_exactly_the_mapped_projections(files):
    base, _, _ = TL.load_model(str(files["hf_single"]), dtype=torch.float32, device="cpu")
    merged, _, _ = TL.load_model(str(files["hf_single"]), dtype=torch.float32, device="cpu",
                                 lora_path=str(files["lora"]))
    changed = sorted(n for (n, a), (_, b) in zip(base.named_parameters(), merged.named_parameters())
                     if not torch.equal(a, b))
    assert changed == ["decoder.blocks.0.cross.o.weight", "decoder.blocks.1.attn.k.weight",
                       "encoder.blocks.0.attn.q.weight", "encoder.blocks.2.attn.v.weight"]


def test_format_helpers_match_jax(files, tmp_path):
    for key in ("openai_dims", "openai_nodims", "hf_single", "hf_sharded", "lora"):
        assert TL.detect_format(files[key]) == JL.detect_format(files[key])
    assert [TL.detect_format(files[k]) for k in ("openai_dims", "hf_single", "hf_sharded", "lora")] == [
        "openai", "hf", "hf", "unknown"]
    pt_dir = tmp_path / "pt_dir"
    pt_dir.mkdir()
    (pt_dir / "x.pt").write_bytes(b"")
    assert TL.detect_format(pt_dir) == JL.detect_format(pt_dir) == "openai"
    assert dataclasses.asdict(TL.dims_from_hf_config(hf_config(DIMS))) == dataclasses.asdict(
        JL.dims_from_hf_config(hf_config(DIMS)))
    for name, dims in MODEL_DIMS.items():
        assert TL.guess_size_name(PORT_DIMS[name]) == JL.guess_size_name(dims) is not None
    assert TL.guess_size_name(TL.dims_from_hf_config(hf_config(DIMS))) is JL.guess_size_name(DIMS) is None
    sd = canonical_state_dict(DIMS, seed=1)
    assert dataclasses.asdict(TL._infer_dims_from_openai_sd({k: torch.from_numpy(v) for k, v in sd.items()})) \
        == dataclasses.asdict(JL._infer_dims_from_openai_sd(sd))
    for k in sd:
        assert TL.hf_key_to_canonical(hf_name(k)) == JL.hf_key_to_canonical(hf_name(k)) == k
    for k in ("encoder.blocks.3.attn.query.weight", "decoder.blocks.0.cross_attn.value.weight",
              "decoder.blocks.1.mlp.0.weight"):
        assert TL._canonical_to_pytree_path(k) == JL._canonical_to_pytree_path(k)


def test_size_resolution_matches_jax_over_a_fake_cache(tmp_path, monkeypatch):
    home = tmp_path / "home"
    snap = home / ".cache" / "huggingface" / "hub" / "models--openai--whisper-tiny" / "snapshots"
    (snap / "aaa").mkdir(parents=True)
    (snap / "bbb").mkdir()
    (home / ".cache" / "whisper").mkdir(parents=True)
    (home / ".cache" / "whisper" / "base.pt").write_bytes(b"")
    extra = tmp_path / "extra"
    (extra / "models--openai--whisper-large-v3-turbo" / "snapshots" / "ccc").mkdir(parents=True)
    (extra / "small.pt").write_bytes(b"")
    monkeypatch.setenv("HOME", str(home))
    for size in ("tiny", "base", "small", "large-v3-turbo", "medium"):
        for cache in (None, str(extra)):
            assert TL._resolve_size_to_path(size, cache) == JL._resolve_size_to_path(size, cache), (size, cache)
    assert TL._resolve_size_to_path("tiny", None) == snap / "bbb"
    assert TL._resolve_size_to_path("small", str(extra)) == extra / "small.pt"
    with pytest.raises(FileNotFoundError, match="no local weights for 'medium'"):
        TL.load_model("medium", device="cpu")


def test_native_round_trip_is_bit_exact(files, tmp_path):
    for dtype in (torch.float32, torch.bfloat16):
        model, dims, _ = TL.load_model(str(files["openai_dims"]), dtype=dtype, device="cpu",
                                       lora_path=str(files["lora"]))
        out = tmp_path / f"native_{dtype}"
        TL.save_native(model, dims, out)
        assert TL.detect_format(out) == JL.detect_format(out) == "native"
        back, dims2, name = TL.load_model(str(out), dtype=dtype, device="cpu")
        assert dims2 == dims and name is None
        assert_same_module(back, model)
        TL.save_native(back, dims, out)  # converting twice to one destination replaces it
        again, _ = TL.load_native(out, device="cpu")
        assert_same_module(again, model)
    wide, _ = TL.load_native(out, dtype=torch.float32, device="cpu")
    assert_same_module(wide, model.float(), buffers=False)  # the sinusoids are made anew in f32


def test_jax_orbax_directory_is_refused(files, tmp_path):
    jtree, jdims, _ = JL.load_model(str(files["openai_dims"]), dtype=jnp.float32)
    out = tmp_path / "orbax"
    JL.save_native(jtree, jdims, out)
    assert TL.detect_format(out) == "native"
    with pytest.raises(ValueError, match="orbax checkpoint of the JAX package"):
        TL.load_model(str(out), device="cpu")


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.numpy import save_file as save_np
    from safetensors.torch import load_file as load_torch, save_file as save_torch

    rng = np.random.default_rng(5)
    arrays = {"f32": rng.standard_normal((3, 5)).astype(np.float32),
              "f16": rng.standard_normal((7,)).astype(np.float16),
              "i64": rng.integers(-9, 9, (2, 2, 2)), "u8": rng.integers(0, 255, (5,), dtype=np.uint8),
              "scalar": np.array(2.5, np.float32), "empty": np.zeros((0, 4), np.float32)}
    save_np(arrays, str(tmp_path / "a.safetensors"), metadata={"format": "np"})
    got = TL._read_safetensors_file(tmp_path / "a.safetensors")
    assert sorted(got) == sorted(arrays)
    for k, v in arrays.items():
        assert got[k].shape == v.shape and np.array_equal(got[k].numpy(), v), k
    bf = {"bf16": torch.randn(4, 6, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)}
    save_torch(bf, str(tmp_path / "b.safetensors"))
    got = TL._read_safetensors_file(tmp_path / "b.safetensors")
    want = load_torch(str(tmp_path / "b.safetensors"))
    assert got["bf16"].dtype == torch.bfloat16 and torch.equal(got["bf16"], want["bf16"])


def test_engine_serves_a_checkpoint_and_random_weights(files):
    from whisperlivekit_tpu_torch.config import WLKConfig
    from whisperlivekit_tpu_torch.engine import core

    config = WLKConfig(model_path=str(files["hf_sharded"]), lora_path=str(files["lora"]),
                       param_dtype="float32", lan="en", vac=False)
    model, dims, name = core.load_whisper_params(config, device="cpu")
    want, _, _ = TL.load_model(str(files["hf_sharded"]), dtype=torch.float32, device="cpu",
                               lora_path=str(files["lora"]))
    assert dataclasses.asdict(dims) == dataclasses.asdict(DIMS) and name is None
    assert_same_module(model, want)
    model, dims, name = core.load_whisper_params(
        WLKConfig(model_size="random:dev-tiny", param_dtype="float32"), device="cpu")
    assert name == "dev-tiny" and dims == PORT_DIMS["dev-tiny"]
    # decoder_dtype="f8" quantizes the loaded checkpoint's decoder linears
    model, _, _ = core.load_whisper_params(
        WLKConfig(model_path=str(files["openai_dims"]), decoder_dtype="f8"), device="cpu")
    plain, _, _ = core.load_whisper_params(
        WLKConfig(model_path=str(files["openai_dims"])), device="cpu")
    want = quantize_decoder_f8(plain)
    fc1, ref = model.decoder.blocks[0].fc1, want.decoder.blocks[0].fc1
    assert fc1.weight.dtype == torch.float8_e4m3fn and fc1.w_scale.dtype == torch.float32
    assert torch.equal(fc1.weight.view(torch.uint8), ref.weight.view(torch.uint8))
    assert model.decoder.blocks[0].cross.k.weight.dtype == model.dtype
