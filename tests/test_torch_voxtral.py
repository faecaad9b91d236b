"""The port's Voxtral offline model and backend (models/voxtral.py,
models/voxtral_backend.py) and Voxtral realtime (streaming/voxtral_realtime.py)
against the JAX package's, on the CPU at tiny widths.

The same weights (the JAX ``init_params`` pytree bridged by
``voxtral_params_from_jax``, or one seeded checkpoint directory read by
both packages' loaders) and the same inputs (numpy seeds): f32 features and
logits within 2e-5, greedy tokens, converted parameters and committed words
exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperlivekit_tpu.config import WLKConfig as JConfig
from whisperlivekit_tpu.models import llama as JL
from whisperlivekit_tpu.models import voxtral as JV
from whisperlivekit_tpu.models import voxtral_backend as JVB
from whisperlivekit_tpu.models.whisper.dims import ModelDimensions as JMD
from whisperlivekit_tpu.streaming import voxtral_realtime as JR
from whisperlivekit_tpu.streaming import windowed as JW
from whisperlivekit_tpu_torch.config import WLKConfig as TConfig
from whisperlivekit_tpu_torch.harness import llm_checkpoints as CK
from whisperlivekit_tpu_torch.models import llama as TL
from whisperlivekit_tpu_torch.models import qwen3_asr as TQ
from whisperlivekit_tpu_torch.models import voxtral as TV
from whisperlivekit_tpu_torch.models import voxtral_backend as TVB
from whisperlivekit_tpu_torch.models.whisper.dims import ModelDimensions as TMD
from whisperlivekit_tpu_torch.streaming import voxtral_realtime as TR
from whisperlivekit_tpu_torch.streaming import windowed as TW

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

AUDIO = dict(n_mels=32, n_audio_ctx=20, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
             n_vocab=51866, n_text_ctx=1, n_text_state=64, n_text_head=4, n_text_layer=1)
TEXT = dict(vocab_size=256, hidden_size=64, n_layers=2, n_heads=4, n_kv_heads=2, intermediate_size=128,
            head_dim=16, rope_theta=1e8, max_positions=256)
JDIMS = JV.VoxtralDims(audio=JMD(**AUDIO), text=JL.LlamaDims(**TEXT), audio_token_id=7)
TDIMS = TV.VoxtralDims(audio=TMD(**AUDIO), text=TL.LlamaDims(**TEXT), audio_token_id=7)


class StandinText:
    """Stands in for tokenizer.json: id N decodes to "tN"."""

    def decode(self, ids):
        return " ".join(f"t{i}" for i in ids)


@pytest.fixture(scope="module")
def weights():
    jp = JV.init_params(JDIMS, jax.random.PRNGKey(0))
    # a larger token embedding, so fed-back tokens steer the random model
    jp["text"]["tok_emb"] = jp["text"]["tok_emb"] * 50
    return jp, TV.voxtral_params_from_jax(jax.tree.map(np.asarray, jp), TDIMS)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, 32, 40)).astype(np.float32)
    prompt = np.array([[1] + [7] * 5 + [30, 31, 32], [1] + [7] * 5 + [40, 41, 42]])
    return mel, prompt


def test_audio_features_match_jax(weights, inputs):
    jp, tm = weights
    mel, _ = inputs
    want = JV.audio_features(jp, jnp.asarray(mel), JDIMS)
    got = TV.audio_features(tm, torch.from_numpy(mel), TDIMS)
    assert tuple(got.shape) == (2, 5, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_forward_logits_and_splice_match_jax(weights, inputs):
    jp, tm = weights
    mel, prompt = inputs
    jl, jc = JV.forward(jp, jnp.asarray(prompt, jnp.int32), jnp.asarray(mel), jnp.zeros((2,), jnp.int32),
                        JL.init_cache(JDIMS.text, 2, 16), JDIMS)
    tl, tc = TV.forward(tm, torch.from_numpy(prompt), torch.from_numpy(mel), torch.zeros(2, dtype=torch.long),
                        TL.init_cache(TDIMS.text, 2, 16), TDIMS)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=2e-5, rtol=2e-5)


def test_greedy_generate_matches_jax(weights, inputs):
    """Greedy tokens with an EOS one lane reaches early: the first token from
    the prefill, eos after each lane's end."""
    jp, tm = weights
    mel, prompt = inputs
    want = np.asarray(JV.greedy_generate(jp, jnp.asarray(prompt, jnp.int32), jnp.asarray(mel), 0, JDIMS, 12))
    eos = next(int(t) for k, t in enumerate(want[0]) if k >= 2 and t not in want[0, :k] and t not in want[1])
    want = np.asarray(JV.greedy_generate(jp, jnp.asarray(prompt, jnp.int32), jnp.asarray(mel), eos, JDIMS, 12))
    got = TV.greedy_generate(tm, torch.from_numpy(prompt), torch.from_numpy(mel), eos, TDIMS, 12)
    assert got.tolist() == want.tolist()
    assert eos in want[0] and eos not in want[1]


@pytest.fixture(scope="module")
def voxtral_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("voxtral_ckpt")
    CK.write_checkpoint(d, "voxtral", TDIMS, seed=6)
    return str(d)


def test_load_voxtral_bit_equal_to_jax(voxtral_dir):
    """One directory through both loaders (f32): every parameter bit for
    bit; no tokenizer.json, so no text tokenizer on either side."""
    jp, jdims, jtok = JVB.load_voxtral(voxtral_dir, dtype=jnp.float32)
    tm, tdims, ttok = TVB.load_voxtral(voxtral_dir, dtype=torch.float32, device="cpu")
    assert jtok is None and ttok is None
    assert tdims.text == TL.LlamaDims(**TEXT) and tdims.audio == TMD(**AUDIO)
    back = TV.voxtral_params_from_jax(jax.tree.map(np.asarray, jp), tdims)
    got, want = tm.state_dict(), back.state_dict()
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_tokenizer_json_without_tokenizers_raises(voxtral_dir, tmp_path, monkeypatch):
    import shutil
    import sys

    d = tmp_path / "with_tok"
    shutil.copytree(voxtral_dir, d)
    (d / "tokenizer.json").write_text("{}")
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    with pytest.raises(ImportError, match="tokenizers"):
        TVB.load_voxtral(str(d), dtype=torch.float32, device="cpu")


def test_engine_asks_for_local_voxtral_weights(tmp_path, monkeypatch):
    """No model path and no cached weights: the windowed Voxtral backend
    raises, as the JAX engine does."""
    from whisperlivekit_tpu_torch.engine.core import TranscriptionEngine

    monkeypatch.setenv("HOME", str(tmp_path))
    TranscriptionEngine.reset()
    try:
        with pytest.raises(FileNotFoundError, match="no local Voxtral weights"):
            TranscriptionEngine(TConfig(backend="voxtral", backend_policy="localagreement", lan="en", vac=False,
                                        param_dtype="float32", log_level="ERROR"), device="cpu")
    finally:
        TranscriptionEngine.reset()


@pytest.mark.parametrize("load", [
    lambda d: TVB.load_voxtral(d),
    lambda d: TR.load_voxtral_realtime(TConfig(backend="voxtral", backend_policy="causal", model_path=d,
                                               log_level="ERROR")),
], ids=["offline", "realtime"])
def test_loader_without_cuda_raises_not_falls_back(voxtral_dir, load, monkeypatch):
    """With no device given each loader asks for the card: without CUDA it
    raises rather than load the model on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        load(voxtral_dir)

def _windowed_words(W, asr, seconds=4):
    """The windowed policy over a backend, 1 s chunks: committed words with
    their times, then the final flush's."""
    from test_torch_qwen3 import audio_seconds

    proc = W.WindowedStreamingProcessor(asr)
    out = []
    for i in range(seconds):
        proc.insert_audio_chunk(audio_seconds(1, seed=30 + i), float(i + 1))
        out += [(t.text, t.start, t.end) for t in proc.process_iter()[0]]
    out += [(t.text, t.start, t.end) for t in proc.finish()[0]]
    return out


def test_transcribe_and_windowed_words_match_jax(voxtral_dir):
    """``VoxtralASR.transcribe`` token ids, and the windowed policy's
    committed words over 4 s, exactly JAX's (the stand-in text tokenizer on
    both sides, 16 new tokens a call)."""
    jp, jdims, _ = JVB.load_voxtral(voxtral_dir, dtype=jnp.float32)
    tm, tdims, _ = TVB.load_voxtral(voxtral_dir, dtype=torch.float32, device="cpu")
    jasr, tasr = JVB.VoxtralASR(jp, jdims, StandinText()), TVB.VoxtralASR(tm, tdims, StandinText())
    jasr.max_new_tokens = tasr.max_new_tokens = 16
    from test_torch_qwen3 import audio_seconds

    a = audio_seconds(2, seed=3)
    assert tasr.transcribe(a) == jasr.transcribe(a)
    got, want = _windowed_words(TW, tasr), _windowed_words(JW, jasr)
    assert got == want and want


def test_engine_serves_voxtral_windowed(voxtral_dir):
    from whisperlivekit_tpu_torch.engine.core import TranscriptionEngine, VoxtralHolder, online_factory

    TranscriptionEngine.reset()
    try:
        cfg = TConfig(backend="voxtral", backend_policy="localagreement", model_path=voxtral_dir, lan="en",
                      vac=False, pcm_input=True, param_dtype="float32", log_level="ERROR")
        engine = TranscriptionEngine(cfg, device="cpu")
        assert isinstance(engine.asr, VoxtralHolder) and engine.asr.sep == ""
        engine.asr.asr.text_tokenizer, engine.asr.asr.max_new_tokens = StandinText(), 8
        proc = online_factory(cfg, engine.asr)
        assert type(proc) is TW.WindowedStreamingProcessor
        from test_torch_qwen3 import audio_seconds

        proc.insert_audio_chunk(audio_seconds(2), 2.0)
        proc.process_iter()
        assert proc.finish()[0]
    finally:
        TranscriptionEngine.reset()


# ---------------------------------------------------------------------------
# Voxtral realtime: the causal machinery with the gelu-MLP projector
# ---------------------------------------------------------------------------


RT_DIMS = TQ.Qwen3ASRDims(text=TL.LlamaDims(**TEXT), n_mels=80, d_audio=64, audio_heads=4, audio_layers=2,
                          audio_ff=128)


@pytest.fixture(scope="module")
def realtime_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("voxtral_rt_ckpt")
    CK.write_checkpoint(d, "voxtral_realtime", RT_DIMS, seed=8)
    return str(d)


def test_voxtral_realtime_loads_the_projector_mlp_and_streams_as_jax(realtime_dir, monkeypatch):
    """``load_voxtral_realtime`` on a checkpoint with the gelu-MLP projector
    (linear_1, linear_2): the same parameters as JAX's converter, the
    projector changes the audio tokens, and the realtime processor commits
    JAX's words over 5 s (2 s blocks)."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    jh = JR.load_voxtral_realtime(JConfig(backend="voxtral", backend_policy="causal", model_path=realtime_dir,
                                          log_level="ERROR"))
    th = TR.load_voxtral_realtime(TConfig(backend="voxtral", backend_policy="causal", model_path=realtime_dir,
                                          log_level="ERROR"), device="cpu")
    assert th.sep == "" and th.dims.block_frames == 100 and th.params.tower.proj2 is not None
    back = TQ.qwen3_params_from_jax(jax.tree.map(np.asarray, jh.params), th.dims)
    got, want = th.params.state_dict(), back.state_dict()
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)

    feats = torch.ones(1, 8, 64)
    single = TQ.project_audio_tokens(th.params, feats, th.dims)
    proj2, th.params.tower.proj2 = th.params.tower.proj2, None
    try:
        assert not torch.allclose(TQ.project_audio_tokens(th.params, feats, th.dims), single)
    finally:
        th.params.tower.proj2 = proj2

    from test_torch_qwen3 import audio_seconds

    def stream(R, holder):
        proc = R.VoxtralRealtimeProcessor(holder)
        out = []
        for i in range(5):
            proc.insert_audio_chunk(audio_seconds(1, seed=40 + i), float(i + 1))
            out += [(t.text, t.start, t.end) for t in proc.process_iter()[0]]
        out += [(t.text, t.start, t.end) for t in proc.finish()[0]]
        return out

    assert stream(TR, th) == stream(JR, jh)


def test_engine_routes_voxtral_realtime_before_its_base():
    from whisperlivekit_tpu_torch.engine.core import TranscriptionEngine, online_factory
    from whisperlivekit_tpu_torch.streaming.qwen3_batch import CausalBatchService

    TranscriptionEngine.reset()
    try:
        cfg = TConfig(backend="voxtral", backend_policy="causal", model_size="random:dev-tiny", lan="en",
                      vac=False, pcm_input=True, scheduler=True, max_batch_sessions=64, param_dtype="float32",
                      log_level="ERROR")
        engine = TranscriptionEngine(cfg, device="cpu")
        assert isinstance(engine.asr, TR.VoxtralRealtimeASR)
        assert isinstance(engine.scheduler, CausalBatchService) and len(engine.scheduler.pools._free) == 16
        proc = online_factory(cfg, engine.asr)
        assert type(proc) is TR.VoxtralRealtimeProcessor
        from test_torch_qwen3 import audio_seconds

        proc.insert_audio_chunk(audio_seconds(1), 1.0)
        tokens, upto = proc.process_iter(is_last=True)
        assert upto > 0
    finally:
        TranscriptionEngine.reset()
