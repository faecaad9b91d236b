"""The port's NLLB (translation/nllb_model.py, nllb.py) against the JAX
package's on the CPU, at ``NLLB_SIZES["dev-tiny"]``, on the same weights
(the JAX pytree bridged through ``nllb_params_from_jax``) and numpy-seeded
inputs: ``encode``, ``decode`` logits and the padded-source mask in f32
(2e-5) and bf16 (2e-2); ``greedy_translate`` tokens exact at several
source lengths and pad buckets, with ``max_len`` reached and with an early
end-of-text; the HF M2M100 converter on a synthetic state dict (its key
names written out); ``NLLBModel.translate`` and ``NLLBOnlineTranslation``
with the stand-in tokenizer in both packages; ``load_nllb`` from an HF
cache snapshot, and its failures."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperlivekit_tpu.timed import ASRToken as JToken
from whisperlivekit_tpu.translation import nllb as JL
from whisperlivekit_tpu.translation import nllb_model as JN
from whisperlivekit_tpu_torch.harness.vocab import StandinNLLBTokenizer
from whisperlivekit_tpu_torch.timed import ASRToken as TToken
from whisperlivekit_tpu_torch.translation import nllb as TL
from whisperlivekit_tpu_torch.translation import nllb_model as TN

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

DIMS = TN.NLLB_SIZES["dev-tiny"]
JDIMS = JN.NLLB_SIZES["dev-tiny"]
DTYPES = {"float32": (jnp.float32, torch.float32, dict(rtol=2e-5, atol=2e-5)),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, dict(rtol=2e-2, atol=2e-2))}


def _np(tree):
    """The pytree as writable numpy copies (bf16 leaves widened to f32,
    exactly)."""
    return jax.tree.map(lambda a: np.array(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a), tree)


@pytest.fixture(scope="module", params=sorted(DTYPES))
def pair(request):
    jdt, tdt, tol = DTYPES[request.param]
    jp = JN.init_params(JDIMS, jax.random.PRNGKey(0), jdt)
    return jp, TN.nllb_params_from_jax(_np(jp), DIMS, dtype=tdt), tol


def _f32(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) else x.float().numpy()


def test_sinusoidal_table_matches_jax():
    np.testing.assert_array_equal(TN.sinusoidal_table(DIMS), JN.sinusoidal_table(JDIMS))
    assert not TN.sinusoidal_table(DIMS)[DIMS.pad_token_id].any()


def test_encode_matches_jax_with_padded_source(pair):
    jp, tm, tol = pair
    rng = np.random.default_rng(0)
    src = rng.integers(3, 500, (2, 16))
    mask = np.ones((2, 16), bool)
    mask[1, 9:] = False
    src[1, 9:] = DIMS.pad_token_id
    want = JN.encode(jp, jnp.asarray(src, jnp.int32), JDIMS, pad_mask=jnp.asarray(mask))
    got = TN.encode(tm, torch.from_numpy(src), DIMS, pad_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    # the padded row's real positions equal the unpadded encoding
    alone = TN.encode(tm, torch.from_numpy(src[1:, :9]), DIMS, pad_mask=torch.ones((1, 9), dtype=torch.bool))
    np.testing.assert_allclose(_f32(got)[1, :9], _f32(alone)[0], **tol)


def test_decode_logits_match_jax(pair):
    jp, tm, tol = pair
    rng = np.random.default_rng(1)
    src = rng.integers(3, 500, (2, 7))
    dec = rng.integers(3, 500, (2, 5))
    mask = np.ones((2, 7), bool)
    mask[0, 5:] = False
    jenc = JN.encode(jp, jnp.asarray(src, jnp.int32), JDIMS, pad_mask=jnp.asarray(mask))
    jxk, jxv = JN.cross_kv(jp, jenc, JDIMS)
    jcache = JN.init_cache(JDIMS, 2, 16, dtype=jp["emb"].dtype)
    want, jcache = JN.decode(jp, jnp.asarray(dec, jnp.int32), jnp.asarray([0, 3], jnp.int32), jxk, jxv, jcache,
                             JDIMS, enc_pad_mask=jnp.asarray(mask))
    tenc = TN.encode(tm, torch.from_numpy(src), DIMS, pad_mask=torch.from_numpy(mask))
    txk, txv = TN.cross_kv(tm, tenc, DIMS)
    tcache = TN.init_cache(DIMS, 2, 16, dtype=tm.dtype)
    got, tcache = TN.decode(tm, torch.from_numpy(dec), torch.tensor([0, 3]), txk, txv, tcache, DIMS,
                            enc_pad_mask=torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (2, 5, DIMS.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(_f32(tcache.k), _f32(jcache.k), **tol)
    np.testing.assert_allclose(_f32(tcache.v), _f32(jcache.v), **tol)


@pytest.mark.parametrize("S,max_len", [(5, 12), (11, 12), (16, 40), (30, 40), (45, 9), (150, 6)])
def test_greedy_translate_tokens_match_jax(pair, S, max_len):
    """Source lengths in the 16- to 256-wide pad buckets (past dev-tiny's
    130 position rows, where JAX's gather clamps); random weights never end
    early, so every call reaches ``max_len``."""
    jp, tm, _ = pair
    rng = np.random.default_rng(S)
    bucket = 1 << max(4, (S - 1).bit_length())
    src = np.full((2, bucket), DIMS.pad_token_id)
    src[:, :S] = rng.integers(3, 500, (2, S))
    mask = np.zeros((2, bucket), bool)
    mask[:, :S] = True
    mask[1, S - 2:] = False
    want = JN.greedy_translate(jp, jnp.asarray(src, jnp.int32), jnp.asarray(mask), jnp.asarray([100, 101], jnp.int32),
                               2, JDIMS, max_len)
    got = TN.greedy_translate(tm, torch.from_numpy(src), torch.from_numpy(mask), torch.tensor([100, 101]), 2, DIMS,
                              max_len)
    assert got.tolist() == np.asarray(want).tolist()
    assert got.shape == (2, max_len) and (got[:, -1] != 2).any()  # a lane ran to max_len


def test_greedy_translate_stops_at_eos_like_jax():
    """Plant end-of-text: the decoder's final LayerNorm bias along the eos
    embedding row makes eos the argmax after a few steps on one lane."""
    jp = JN.init_params(JDIMS, jax.random.PRNGKey(1), jnp.float32)
    tree = _np(jp)
    rng = np.random.default_rng(3)
    direction = rng.standard_normal(DIMS.d_model).astype(np.float32)
    tree["decoder"]["ln"]["bias"] = 0.35 * direction
    tree["emb"][2] = direction
    jp = jax.tree.map(jnp.asarray, tree)
    tm = TN.nllb_params_from_jax(tree, DIMS)
    src = rng.integers(3, 500, (3, 16))
    mask = np.ones((3, 16), bool)
    bos = np.array([100, 101, 102])
    want = np.asarray(JN.greedy_translate(jp, jnp.asarray(src, jnp.int32), jnp.asarray(mask),
                                          jnp.asarray(bos, jnp.int32), 2, JDIMS, 24))
    got = TN.greedy_translate(tm, torch.from_numpy(src), torch.from_numpy(mask), torch.from_numpy(bos), 2, DIMS, 24)
    assert got.tolist() == want.tolist()
    assert (want[:, 1:] == 2).any(axis=1).all(), "every lane must end before max_len in this case"


def hf_state_dict(dims, seed=0):
    """An HF M2M100ForConditionalGeneration state dict's keys and shapes
    (torch Linear [out, in]), random f32 values from ``seed``."""
    rng = np.random.default_rng(seed)
    sd = {}
    d, f = dims.d_model, dims.ffn_dim

    def put(name, *shape):
        sd[name] = (rng.standard_normal(shape) * 0.05).astype(np.float32)

    put("model.shared.weight", dims.vocab_size, d)
    sd["model.encoder.embed_tokens.weight"] = sd["model.shared.weight"]
    sd["model.decoder.embed_tokens.weight"] = sd["model.shared.weight"]
    sd["lm_head.weight"] = sd["model.shared.weight"]
    for side, n, cross in (("encoder", dims.encoder_layers, False), ("decoder", dims.decoder_layers, True)):
        for i in range(n):
            p = f"model.{side}.layers.{i}"
            attns = ("self_attn", "encoder_attn") if cross else ("self_attn",)
            for a in attns:
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    put(f"{p}.{a}.{proj}.weight", d, d)
                    put(f"{p}.{a}.{proj}.bias", d)
                put(f"{p}.{a}_layer_norm.weight", d)
                put(f"{p}.{a}_layer_norm.bias", d)
            put(f"{p}.fc1.weight", f, d)
            put(f"{p}.fc1.bias", f)
            put(f"{p}.fc2.weight", d, f)
            put(f"{p}.fc2.bias", d)
            put(f"{p}.final_layer_norm.weight", d)
            put(f"{p}.final_layer_norm.bias", d)
        put(f"model.{side}.layer_norm.weight", d)
        put(f"model.{side}.layer_norm.bias", d)
    return sd


def hf_config(dims):
    return {"vocab_size": dims.vocab_size, "d_model": dims.d_model, "encoder_layers": dims.encoder_layers,
            "decoder_layers": dims.decoder_layers, "encoder_attention_heads": dims.heads,
            "decoder_attention_heads": dims.heads, "encoder_ffn_dim": dims.ffn_dim,
            "decoder_ffn_dim": dims.ffn_dim, "max_position_embeddings": dims.max_positions,
            "pad_token_id": dims.pad_token_id}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_convert_hf_state_dict_matches_jax_bridged(dtype):
    jdt, tdt, _ = DTYPES[dtype]
    sd = hf_state_dict(DIMS)
    cfg = hf_config(DIMS)
    assert TL.dims_from_hf_config(cfg) == DIMS and JL.dims_from_hf_config(cfg) == JDIMS
    want = TN.nllb_params_from_jax(_np(JL.convert_hf_state_dict(sd, JDIMS, dtype=jdt)), DIMS, dtype=tdt)
    got = TL.convert_hf_state_dict(sd, DIMS, dtype=tdt)
    ws, gs = want.state_dict(), got.state_dict()
    assert sorted(gs) == sorted(ws)
    for k in ws:
        assert torch.equal(gs[k], ws[k]), k
    torch_sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    assert all(torch.equal(TL.convert_hf_state_dict(torch_sd, DIMS, dtype=tdt).state_dict()[k], gs[k]) for k in gs)


def test_convert_hf_state_dict_refuses_missing_and_misshapen_keys():
    sd = hf_state_dict(DIMS)
    del sd["model.decoder.layers.1.fc2.bias"]
    with pytest.raises(KeyError):
        TL.convert_hf_state_dict(sd, DIMS)
    sd = hf_state_dict(DIMS)
    sd["model.encoder.layers.0.fc1.weight"] = sd["model.encoder.layers.0.fc1.weight"].T.copy()
    with pytest.raises(ValueError, match="shape"):
        TL.convert_hf_state_dict(sd, DIMS)


@pytest.fixture(scope="module")
def models():
    """Both packages' NLLBModel on one dev-tiny f32 weight set and the
    stand-in tokenizer."""
    tok = StandinNLLBTokenizer()
    jp = JN.init_params(JDIMS, jax.random.PRNGKey(2), jnp.float32)
    return (JL.NLLBModel(jp, JDIMS, tok), TL.NLLBModel(TN.nllb_params_from_jax(_np(jp), DIMS), DIMS, tok))


@pytest.mark.parametrize("text", ["hello world.", "", "   ",
                                  "a longer sentence with many more words in it, to reach a wider pad bucket"])
@pytest.mark.parametrize("tgt", ["fr", "deu_Latn"])
def test_nllb_model_translate_matches_jax(models, text, tgt):
    jm, tm = models
    want = jm.translate(text, "en", tgt, max_len=24)
    got = tm.translate(text, "en", tgt, max_len=24)
    assert got == want
    assert bool(got) == bool(text.strip())


def test_translate_refuses_unknown_languages(models):
    _, tm = models
    with pytest.raises(ValueError, match="FLORES"):
        tm.translate("x", "en", "xx")
    with pytest.raises(ValueError, match="language token"):
        tm.translate("x", "en", "zzz_Latn")


def _drive(mod, token_cls, model):
    sess = mod.NLLBOnlineTranslation(model, "en", "fr")
    out = []
    words = [(" hello", 0.0, 0.5), (" there", 0.5, 1.0), (" world.", 1.0, 1.5), (" and", 1.6, 2.0),
             (" more", 2.0, 2.4)]
    for text, s, e in words:
        sess.insert_tokens([token_cls(start=s, end=e, text=text)])
        tr, buf = sess.process()
        out.append((None if tr is None else (tr.start, tr.end, tr.text), buf.text))
    tr, buf = sess.validate_buffer_and_reset()
    out.append(((tr.start, tr.end, tr.text), buf.text))
    out.append(sess.validate_buffer_and_reset()[0])
    return out


def test_online_translation_matches_jax(models):
    jm, tm = models
    want = _drive(JL, JToken, jm)
    got = _drive(TL, TToken, tm)
    assert got == want
    assert got[2][0] is not None and got[0][0] is None and got[0][1]  # a draft, then a final
    assert got[-1] is None


def test_nllb_language_codes_match_jax():
    assert TL.FLORES == JL.FLORES
    for code in ("en", "FR", "fra_Latn"):
        assert TL._nllb_language_code(code) == JL._nllb_language_code(code)


def _snapshot(home, sd, dims):
    from safetensors.numpy import save_file

    snap = home / ".cache" / "huggingface" / "hub" / "models--facebook--nllb-200-distilled-600M" / "snapshots" / "abc"
    snap.mkdir(parents=True)
    (snap / "config.json").write_text(json.dumps(hf_config(dims)))
    save_file({k: v for k, v in sd.items() if k not in ("lm_head.weight",) and "embed_tokens" not in k},
              str(snap / "model.safetensors"))
    return snap


def test_load_nllb_reads_an_hf_snapshot(tmp_path, monkeypatch):
    from types import SimpleNamespace

    monkeypatch.setenv("HOME", str(tmp_path))
    cfg = SimpleNamespace(nllb_size="600M")
    with pytest.raises(FileNotFoundError):
        TL.load_nllb(cfg, device="cpu")
    sd = hf_state_dict(DIMS, seed=4)
    snap = _snapshot(tmp_path, sd, DIMS)
    monkeypatch.setitem(__import__("sys").modules, "tokenizers", None)  # weights present, tokenizers absent
    with pytest.raises(ImportError):
        TL.load_nllb(cfg, device="cpu")
    monkeypatch.delitem(__import__("sys").modules, "tokenizers")
    pytest.importorskip("tokenizers")
    from tokenizers import Tokenizer, models as tmodels

    Tokenizer(tmodels.WordLevel({"<pad>": 1, "fra_Latn": 300, "eng_Latn": 301, "hi": 7}, unk_token="<pad>")).save(
        str(snap / "tokenizer.json"))
    model = TL.load_nllb(cfg, device="cpu")
    assert model.params.dtype == torch.bfloat16 and model.dims == DIMS
    want = TL.convert_hf_state_dict(sd, DIMS, dtype=torch.bfloat16).state_dict()
    assert all(torch.equal(model.params.state_dict()[k], want[k]) for k in want)
    assert model._lang_id("fra_Latn") == 300
