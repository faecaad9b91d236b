"""Port parity for the f8 serving path of whisperlivekit_tpu_torch against the
JAX package, at dev-tiny size with JAX weights bridged through numpy and
inputs made from numpy seeds:

- ``ops/f8.to_e4m3fn`` gives ``astype(float8_e4m3fn)``'s bytes from f32 and
  bf16 (random values over the whole range, random bit patterns, and the
  edges: 448, the 464 tie, overflow, +-inf, NaN, subnormals, -0), where
  ``Tensor.to`` saturates;
- ``quantize_decoder_f8`` gives JAX's f8 bytes and f32 scales, bit for bit,
  from f32 and bf16 weights; the bridge carries JAX's quantized pytree
  across, and module-wide casts leave the f8 weights and scales as they are;
- ``dense`` with an f8 weight within 2e-5 in f32 and 2e-2 in bf16, and the
  decoder's prefill and steps with quantized weights within the f32 bar of
  tests/test_torch_model.py (1e-4);
- ``load_whisper_params(decoder_dtype="f8")`` quantizes, and the engine's
  model keeps its f8 linears.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperlivekit_tpu.models.whisper import model as JM
from whisperlivekit_tpu.models.whisper.dims import MODEL_DIMS
from whisperlivekit_tpu_torch.models.whisper import model as TM
from whisperlivekit_tpu_torch.ops.f8 import F8, as_bytes, to_e4m3fn, write_cast

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

DIMS = MODEL_DIMS["dev-tiny"]
ALIGN_PAIRS = [(1, 0), (1, 2), (0, 3)]
LINEARS = (("attn", "q"), ("attn", "k"), ("attn", "v"), ("attn", "o"),
           ("cross", "q"), ("cross", "o"), ("mlp", "fc1"), ("mlp", "fc2"))
EDGES = np.array(
    [447.9, 448.0, 449.0, 460.0, 463.9, 464.0, 464.1, 470.0, 480.0, 500.0, 1e4, 3e38,
     np.inf, -np.inf, np.nan, -0.0, 0.0, -447.9, -464.0, -464.1, -1e4,
     2.0 ** -6, 2.0 ** -6 * (1 - 2.0 ** -5), 2.0 ** -6 * (1 - 2.0 ** -6), 2.0 ** -10,
     2.0 ** -10 * 1.0001, 2.0 ** -9 * 1.5, 2.0 ** -9 * 2.5, -2.0 ** -9 * 3.5, 1e-45, -1e-45],
    np.float32,
)
NEG_NAN = np.array([0xFFC00000], np.uint32).view(np.float32)


def _jax_bytes(x) -> np.ndarray:
    return np.asarray(x).view(np.uint8)


def _torch_bytes(x: torch.Tensor) -> np.ndarray:
    assert x.dtype == F8
    return x.view(torch.uint8).numpy()


def _jax_linear(tree, group, name):
    blocks = tree["decoder"]["blocks"]
    return blocks[group][name]


def _torch_linear(model, layer, group, name):
    blk = model.decoder.blocks[layer]
    return getattr(blk, name) if group == "mlp" else getattr(getattr(blk, group), name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_to_e4m3fn_matches_jax_bytes(dtype):
    """Every byte equal to ml_dtypes' cast; -inf and -NaN keep the sign
    (0xFF), 464 rounds to even (448) and 464.1 overflows to NaN, where
    ``Tensor.to`` saturates to 448."""
    rng = np.random.default_rng(0)
    n = 100_000
    values = np.concatenate([
        (rng.standard_normal(n) * 10.0 ** rng.uniform(-12, 4, n)).astype(np.float32),
        rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32).view(np.float32),
        EDGES, NEG_NAN,
    ])
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jx = jnp.asarray(values).astype(jdt)
    want = _jax_bytes(jx.astype(jnp.float8_e4m3fn))
    tx = torch.from_numpy(values)
    if dtype == "bfloat16":  # JAX's own bf16 bits, so both cast the same inputs
        tx = torch.from_numpy(np.asarray(jx).view(np.int16).copy()).view(torch.bfloat16)
    got = _torch_bytes(to_e4m3fn(tx))
    np.testing.assert_array_equal(got, want)
    edge = dict(zip(EDGES.tolist(), got[2 * n: 2 * n + len(EDGES)].tolist()))
    assert edge[float("-inf")] == 0xFF and got[-1] == 0xFF          # -inf, -NaN
    assert edge[448.0] == edge[464.0] == 0x7E and edge[-464.0] == 0xFE
    if dtype == "float32":
        assert edge[np.float32(464.1).item()] == 0x7F
        assert torch.tensor([464.1, 1e4]).to(F8).view(torch.uint8).tolist() == [0x7E, 0x7E]


def test_byte_views_round_trip():
    x = to_e4m3fn(torch.linspace(-500, 500, 64))
    b = as_bytes(x)
    assert b.dtype == torch.uint8 and b.data_ptr() == x.data_ptr()
    np.testing.assert_array_equal(_torch_bytes(b.view(F8)), b.numpy())
    y = torch.ones(3)
    assert as_bytes(y) is y
    # write_cast: indexed writes into a float8 tensor, cast as JAX casts
    src = torch.tensor([[1.0, 470.0, -1e4], [float("nan"), 2.0 ** -10, -0.0]])
    dst = to_e4m3fn(torch.full((4, 3), 3.0))
    before = _torch_bytes(dst).copy()
    write_cast(dst, torch.tensor([2, 0]), src)
    want = before.copy()
    want[[2, 0]] = _torch_bytes(to_e4m3fn(src))
    np.testing.assert_array_equal(_torch_bytes(dst), want)
    write_cast(dst, (slice(None), 1), 0, keep=torch.tensor([True, False, True, False]))
    want[[0, 2], 1] = 0
    np.testing.assert_array_equal(_torch_bytes(dst), want)
    f = torch.ones(2, 2)
    write_cast(f, 0, torch.tensor([0.5, 2.0], dtype=torch.bfloat16))
    assert f.tolist() == [[0.5, 2.0], [1.0, 1.0]]


@pytest.fixture(scope="module")
def weights():
    jp = JM.init_params(DIMS, jax.random.PRNGKey(0), jnp.float32)
    return jp, jax.tree.map(np.asarray, jp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_decoder_f8_matches_jax(weights, dtype):
    """f8 bytes and f32 scales bit-equal to JAX's for the eight decoder-block
    linears of every layer; cross k/v, the embeddings and the encoder keep
    their dtype."""
    jp, tree = weights
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jq = JM.quantize_decoder_f8(jax.tree.map(lambda a: a.astype(jdt), jp))
    tm = TM.quantize_decoder_f8(TM.params_from_jax_numpy(tree, DIMS, dtype=tdt))
    for layer in range(DIMS.n_text_layer):
        for group, name in LINEARS:
            jl, tl = _jax_linear(jq, group, name), _torch_linear(tm, layer, group, name)
            assert tl.weight.dtype == F8 and tl.w_scale.dtype == torch.float32
            np.testing.assert_array_equal(_torch_bytes(tl.weight), _jax_bytes(jl["w"][layer]).T)
            np.testing.assert_array_equal(tl.w_scale.numpy(), np.asarray(jl["w_scale"][layer]))
        blk = tm.decoder.blocks[layer]
        assert blk.cross.k.weight.dtype == blk.cross.v.weight.dtype == tdt
    assert tm.decoder.tok_emb.dtype == tdt and tm.encoder.blocks[0].fc1.weight.dtype == tdt


def test_bridge_carries_f8_and_casts_keep_it(weights):
    """``params_from_jax_numpy`` reads JAX's quantized pytree (float8 through
    uint8) into the same bytes and scales the port's quantizer makes; the
    bridge's own ``.to(dtype)`` and later module-wide casts widen nothing."""
    jp, tree = weights
    jq = jax.tree.map(np.asarray, JM.quantize_decoder_f8(jp))
    bridged = TM.params_from_jax_numpy(jq, DIMS, dtype=torch.bfloat16)
    own = TM.quantize_decoder_f8(TM.params_from_jax_numpy(tree, DIMS))
    for model in (bridged, bridged.to(dtype=torch.float32), bridged.half().to("cpu")):
        for layer in range(DIMS.n_text_layer):
            for group, name in LINEARS:
                got, want = _torch_linear(model, layer, group, name), _torch_linear(own, layer, group, name)
                assert got.weight.dtype == F8 and not got.weight.requires_grad
                np.testing.assert_array_equal(_torch_bytes(got.weight), _torch_bytes(want.weight))
                assert got.w_scale.dtype == torch.float32
                np.testing.assert_array_equal(got.w_scale.numpy(), want.w_scale.numpy())
    assert bridged.decoder.blocks[0].fc1.bias.dtype == torch.float16  # the rest did follow


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_dense_f8_matches_jax(dtype, tol):
    """The weight widened to x's dtype, an f32 product, the channel scale,
    then the bias and one rounding, as JAX's ``dense``."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 20, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 384)) / 16).astype(np.float32)
    b = rng.standard_normal(384).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    tree = {"decoder": {"blocks": {"attn": {"q": {"w": jnp.asarray(w)[None], "b": jnp.asarray(b)[None]}},
                                   "cross": {}, "mlp": {}}}}
    jq = JM.quantize_decoder_f8(tree)["decoder"]["blocks"]["attn"]["q"]
    jlin = {"w": jq["w"][0], "w_scale": jq["w_scale"][0], "b": jq["b"][0].astype(jdt)}
    want = JM.dense(jnp.asarray(x).astype(jdt), jlin)
    d = TM.Dense(256, 384).requires_grad_(False)
    d.weight = torch.nn.Parameter(
        torch.from_numpy(_jax_bytes(jlin["w"]).T.copy()).view(F8), requires_grad=False)
    d.w_scale = torch.from_numpy(np.array(jlin["w_scale"]))
    d.bias.data = torch.from_numpy(b).to(tdt)
    got = TM.dense(torch.from_numpy(x).to(tdt), d)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=tol)


def test_decode_with_f8_weights_matches_jax(weights):
    """Prefill with the in-loop alignment reductions, then S=1 steps, with
    the quantized decoder on both sides (f32 activations): logits, the
    statistics, the probability rows and the cache within 1e-4."""
    jp, _ = weights
    jq = JM.quantize_decoder_f8(jp)
    tq = TM.params_from_jax_numpy(jax.tree.map(np.asarray, jq), DIMS)
    rng = np.random.default_rng(9)
    enc = rng.standard_normal((2, 192, DIMS.n_audio_state)).astype(np.float32)
    jx = JM.cross_kv(jq, jnp.asarray(enc), DIMS, transposed=True)
    tx = TM.cross_kv(tq, torch.from_numpy(enc), DIMS, transposed=True)
    B, P, W = 2, 8, 16
    prefix = rng.integers(0, 50000, (B, P)).astype(np.int32)
    plen = np.array([5, 8])
    row_mask = (np.arange(P)[None] < plen[:, None]).astype(np.float32)
    last = (np.arange(P)[None] == (plen - 1)[:, None]).astype(np.float32)
    jal, tal = JM.AlignSpec.from_pairs(ALIGN_PAIRS), TM.AlignSpec.from_pairs(ALIGN_PAIRS)
    jl, jstats, jc = JM.decode(
        jq, jnp.asarray(prefix), jnp.zeros(B, jnp.int32), jx, JM.init_cache(DIMS, B, width=W), DIMS,
        align=jal, align_reduce=(jnp.asarray(row_mask), jnp.asarray(last)), xkv_transposed=True)
    tl, tstats, tc = TM.decode(
        tq, torch.from_numpy(prefix), torch.zeros(B, dtype=torch.int32), tx,
        TM.init_cache(DIMS, B, width=W), DIMS,
        align=tal, align_reduce=(torch.from_numpy(row_mask), torch.from_numpy(last)),
        xkv_transposed=True)
    close = lambda a, b: np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4)  # noqa: E731
    close(tl, jl)
    for a, b in zip(tstats, jstats):
        close(a, b)
    pos = plen.astype(np.int32)
    for step in range(3):
        tok = rng.integers(0, 50000, (B, 1)).astype(np.int32)
        jl, jprobs, jc = JM.decode(jq, jnp.asarray(tok), jnp.asarray(pos + step), jx, jc, DIMS,
                                   align=jal, xkv_transposed=True)
        tl, tprobs, tc = TM.decode(tq, torch.from_numpy(tok), torch.from_numpy(pos + step), tx, tc,
                                   DIMS, align=tal, xkv_transposed=True)
        close(tl, jl)
        close(tprobs, jprobs)
    close(tc.k, jc.k)
    close(tc.v, jc.v)


def test_engine_model_keeps_f8_linears(tmp_path, monkeypatch):
    """``decoder_dtype="f8"`` quantizes after the load (random weights here),
    and the model the engine serves keeps f8 linears with f32 scales after
    a module-wide cast; what it quantized equals quantizing the same load."""
    from whisperlivekit_tpu_torch.config import WLKConfig
    from whisperlivekit_tpu_torch.engine import core
    from whisperlivekit_tpu_torch.harness.vocab import install_standin_vocab

    install_standin_vocab(tmp_path)
    monkeypatch.setenv("WLK_TPU_ASSET_DIR", str(tmp_path))
    config = WLKConfig(model_size="random:dev-tiny", param_dtype="bfloat16", decoder_dtype="f8",
                       lan="en", vac=False, xkv_cache_dtype="f8", xkv_cache="on")
    model, dims, name = core.load_whisper_params(config, device="cpu")
    plain, _, _ = core.load_whisper_params(
        WLKConfig(model_size="random:dev-tiny", param_dtype="bfloat16"), device="cpu")
    want = TM.quantize_decoder_f8(plain)
    asr = core.SimulStreamingASR(config, model.to(dtype=torch.bfloat16), dims, name)
    served = asr.engine.model
    assert served is model and asr.engine.cfg.xkv_cache_dtype == "f8"
    for layer in range(dims.n_text_layer):
        for group, lin in LINEARS:
            got, ref = _torch_linear(served, layer, group, lin), _torch_linear(want, layer, group, lin)
            assert got.weight.dtype == F8 and got.w_scale.dtype == torch.float32
            np.testing.assert_array_equal(_torch_bytes(got.weight), _torch_bytes(ref.weight))
    assert served.dtype == torch.bfloat16


@pytest.mark.cuda
def test_f8_path_on_gpu_matches_cpu(weights):
    """On the card: ``to_e4m3fn`` gives the CPU's bytes (random bit
    patterns and the edges), a module moved there keeps its f8 weights and
    f32 scales, quantizing there gives the CPU's bytes, and the f8 ``dense``
    (bf16) agrees with the CPU's within the bf16 bar."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2 ** 32, 1 << 20, dtype=np.uint64).astype(np.uint32).view(np.float32)
    x = torch.from_numpy(np.concatenate([bits, EDGES, NEG_NAN]))
    for dt in (torch.float32, torch.bfloat16):
        want = _torch_bytes(to_e4m3fn(x.to(dt)))
        np.testing.assert_array_equal(_torch_bytes(to_e4m3fn(x.to(dt).cuda()).cpu()), want)
    _, tree = weights
    cpu = TM.quantize_decoder_f8(TM.params_from_jax_numpy(tree, DIMS, dtype=torch.bfloat16))
    moved = TM.params_from_jax_numpy(tree, DIMS, dtype=torch.bfloat16)
    moved = TM.quantize_decoder_f8(moved).to("cuda")
    on_card = TM.quantize_decoder_f8(TM.params_from_jax_numpy(tree, DIMS, dtype=torch.bfloat16, device="cuda"))
    for model in (moved, on_card):
        for layer in range(DIMS.n_text_layer):
            for group, name in LINEARS:
                got, want = _torch_linear(model, layer, group, name), _torch_linear(cpu, layer, group, name)
                assert got.weight.is_cuda and got.weight.dtype == F8 and got.w_scale.dtype == torch.float32
                np.testing.assert_array_equal(_torch_bytes(got.weight.cpu()), _torch_bytes(want.weight))
                np.testing.assert_array_equal(got.w_scale.cpu().numpy(), want.w_scale.numpy())
    h = torch.from_numpy(rng.standard_normal((4, 24, DIMS.n_text_state)).astype(np.float32)).to(torch.bfloat16)
    fc1 = cpu.decoder.blocks[0].fc1
    want = TM.dense(h, fc1).float()
    got = TM.dense(h.cuda(), on_card.decoder.blocks[0].fc1).float().cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-2)
