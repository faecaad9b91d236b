"""The port's Llama/Qwen3 text tower, Qwen3-ASR causal model and streaming
policy against the JAX package's, on the CPU at DEV_TINY widths.

The same weights (the JAX ``init_params`` pytree, bridged by
``qwen3_params_from_jax``, or one checkpoint directory read by both
loaders) and the same inputs (numpy seeds) go through both packages:
f32 logits and features within 2e-5, bf16 within 2e-2, tokens,
hypothesis lengths, converted parameters and committed words with their
timestamps exactly equal.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisperlivekit_tpu import timed as JT
from whisperlivekit_tpu.config import WLKConfig as JConfig
from whisperlivekit_tpu.models import llama as JL
from whisperlivekit_tpu.models import qwen3_asr as JQ
from whisperlivekit_tpu.streaming import qwen3_causal as JC
from whisperlivekit_tpu_torch import timed as TT
from whisperlivekit_tpu_torch.config import WLKConfig as TConfig
from whisperlivekit_tpu_torch.harness import llm_checkpoints as CK
from whisperlivekit_tpu_torch.models import llama as TL
from whisperlivekit_tpu_torch.models import qwen3_asr as TQ
from whisperlivekit_tpu_torch.streaming import qwen3_causal as TC

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def weights():
    """JAX DEV_TINY params and the same numbers as the port's module."""
    jp = JQ.init_params(JQ.DEV_TINY, jax.random.PRNGKey(0))
    return jp, TQ.qwen3_params_from_jax(jax.tree.map(np.asarray, jp), TQ.DEV_TINY)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def audio_seconds(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * n)) / 16000
    return (0.3 * np.sin(2 * np.pi * 200 * t) + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# The Llama / Qwen3 text tower
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qk_norm", [True, False], ids=["qwen3", "llama"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_llama_forward_matches_jax(qk_norm, dtype):
    """Prefill then single steps, per-lane positions, GQA with 4 query heads
    over 2 KV heads whose weights differ (query head h reads KV head h // 2):
    logits and the cache."""
    dims = dataclasses.replace(JL.LlamaDims(
        vocab_size=96, hidden_size=64, n_layers=2, n_heads=4, n_kv_heads=2,
        intermediate_size=128, head_dim=16, rope_theta=1e6, rms_eps=1e-6), qk_norm=qk_norm)
    tdims = TL.LlamaDims(**dataclasses.asdict(dims))
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = JL.init_params(dims, jax.random.PRNGKey(3), dtype=jnp.float32)
    if qk_norm:  # non-trivial norms, so a dropped or swapped norm shows
        rng = np.random.default_rng(1)
        for name in ("q_norm", "k_norm"):
            jp["blocks"][name] = jnp.asarray(1 + 0.2 * rng.standard_normal(jp["blocks"][name].shape), jnp.float32)
    jp = jax.tree.map(lambda a: a.astype(jdtype), jp)
    tm = TL.llama_params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), jp), tdims).to(dtype)
    ids = np.random.default_rng(0).integers(0, 96, (2, 7))
    pos = np.array([0, 5])

    jc = JL.init_cache(dims, 2, 24, dtype=jdtype)
    tc = TL.init_cache(tdims, 2, 24, dtype=dtype)
    jl, jc = JL.forward(jp, JL.embed_tokens(jp, jnp.asarray(ids, jnp.int32)), jnp.asarray(pos, jnp.int32), jc, dims)
    tl, tc = TL.forward(tm, TL.embed_tokens(tm, torch.from_numpy(ids)), torch.from_numpy(pos), tc, tdims)
    _close_scaled(tl, jl, dtype)
    for s in range(3):
        step = ids[:, s : s + 1]
        at = pos + 7 + s
        jl, jc = JL.forward(jp, JL.embed_tokens(jp, jnp.asarray(step, jnp.int32)), jnp.asarray(at, jnp.int32), jc, dims)
        tl, tc = TL.forward(tm, TL.embed_tokens(tm, torch.from_numpy(step)), torch.from_numpy(at), tc, tdims)
        _close_scaled(tl, jl, dtype)
    _close_scaled(tc.k, jc.k, dtype)
    _close_scaled(tc.v, jc.v, dtype)


def _close_scaled(got, want, dtype):
    """Within the dtype's bar in units of the output's scale (|x| up to ~4
    here: a bf16 step at 2 is 0.0156, and both sides sum in f32 in other
    orders, so a value may round to the neighbouring step); in bf16 each
    logit row's argmax is JAX's, or within two bars of JAX's best."""
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * max(1.0, np.abs(want).max()))
    if dtype == torch.bfloat16 and got.ndim == 3:  # the port's pick is JAX's best or a near tie
        picked = np.take_along_axis(want, got.argmax(-1)[..., None], -1)[..., 0]
        assert (picked >= want.max(-1) - 2 * TOL[dtype]).all()


def test_gqa_reads_kv_head_h_over_rep():
    """Query head h attends with KV head h // (H // KV), as ``jnp.repeat``
    along heads: against an explicit repeat_interleave."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((2, 3, 8, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 5, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 5, 2, 16)).astype(np.float32))
    mask = torch.zeros(2, 3, 5)
    mask[0, :, 4] = float("-inf")
    got = TL.gqa_attend(q, k, v, mask)
    kk, vv = k.repeat_interleave(4, dim=2), v.repeat_interleave(4, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, kk) * 16 ** -0.5 + mask[:, None]
    want = torch.einsum("bhst,bthd->bshd", torch.softmax(scores, -1), vv)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("theta", [1e4, 1e6, 1e8])
@pytest.mark.parametrize("dh", [16, 64, 128])
def test_rope_frequencies_match_jax(theta, dh):
    """RoPE's inverse frequencies in f32 from ``theta ** (arange/dh)``, as
    JAX computes them: within one f32 ulp of XLA's power (at theta 1e6 and
    1e8 a few entries differ by one ulp; f64-then-cast differs more)."""
    want = np.asarray(1.0 / (theta ** (jnp.arange(0, dh, 2, dtype=jnp.float32) / dh)))
    np.testing.assert_array_max_ulp(TL._inv_freq(dh, theta).numpy(), want, maxulp=1)


# ---------------------------------------------------------------------------
# The block-causal tower, append and the disposable hypothesis
# ---------------------------------------------------------------------------


def _mel(dims, seed, batch=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, dims.n_mels, 2 * dims.block_frames)).astype(np.float32)


def test_encode_block_matches_jax_block_by_block(weights):
    """Three blocks on two lanes at different frame positions, the tower
    cache carried through: each block's features and the cache."""
    jp, tm = weights
    jd, td = JQ.DEV_TINY, TQ.DEV_TINY
    jc, tc = JQ.init_tower_cache(jd, 2), TQ.init_tower_cache(td, 2)
    for b in range(3):
        mel = _mel(jd, 10 + b, batch=2)
        start = np.array([b * 20, 40 + b * 20])
        jf, jc = JQ.encode_block(jp, jnp.asarray(mel), jc, jnp.asarray(start, jnp.int32), jd)
        tf, tc = TQ.encode_block(tm, torch.from_numpy(mel), tc, torch.from_numpy(start), td)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=2e-5, rtol=2e-5)


def test_encode_block_is_block_causal(weights):
    """A block's features do not change when later blocks are appended (bit
    for bit), and a later block sees the earlier ones."""
    _, tm = weights
    td = TQ.DEV_TINY

    def run(blocks):
        cache, feats = TQ.init_tower_cache(td, 1), []
        for i, seed in enumerate(blocks):
            f, cache = TQ.encode_block(tm, torch.from_numpy(_mel(td, seed)), cache, torch.tensor([i * 20]), td)
            feats.append(f)
        return feats

    short, full = run([0, 1]), run([0, 1, 2, 3])
    assert torch.equal(short[0], full[0]) and torch.equal(short[1], full[1])
    assert not torch.equal(run([7, 1])[1], short[1])


def test_append_and_decode_match_jax(weights):
    """``append_audio_block`` (logits after the block) and
    ``decode_hypothesis`` on two lanes: tokens and ``n`` exact, with an EOS
    that ends one lane early (its later slots hold eos, ``n`` counts the
    steps before it) while the other runs on. The token embedding is
    scaled up so the fed-back tokens steer the random model (at the init's
    0.02 every step repeats one token)."""
    jp, _ = weights
    jp = {**jp, "text": {**jp["text"], "tok_emb": jp["text"]["tok_emb"] * 50}}
    tm = TQ.qwen3_params_from_jax(jax.tree.map(np.asarray, jp), TQ.DEV_TINY)
    jd, td = JQ.DEV_TINY, TQ.DEV_TINY
    jt, jx = JQ.init_tower_cache(jd, 2), JL.init_cache(jd.text, 2, 64)
    tt, tx = TQ.init_tower_cache(td, 2), TL.init_cache(td.text, 2, 64)
    tpos = np.array([3, 3])
    for b in range(2):
        mel = _mel(jd, 20 + b, batch=2)
        start = np.array([b * 20, b * 20])
        jt, jx, jlog = JQ.append_audio_block(jp, jnp.asarray(mel), jt, jx, jnp.asarray(start, jnp.int32),
                                             jnp.asarray(tpos, jnp.int32), jd)
        tt, tx, tlog = TQ.append_audio_block(tm, torch.from_numpy(mel), tt, tx, torch.from_numpy(start),
                                             torch.from_numpy(tpos), td)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=2e-5, rtol=2e-5)
        tpos = tpos + jd.block_tokens
    start_tok = np.array([[4], [4]])

    def jdecode(eos):  # decode_hypothesis donates its cache: decode a copy
        out = JQ.decode_hypothesis(jp, jax.tree.map(jnp.copy, jx), jnp.asarray(start_tok, jnp.int32),
                                   jnp.asarray(tpos, jnp.int32), eos, jd, max_new=8)
        return np.asarray(out[0]), np.asarray(out[1])

    jtok, _ = jdecode(0)
    # an EOS id that one lane first emits at step 1 or later and the other never
    lane, step, eos = next((b, k, int(t)) for b in (0, 1) for k, t in enumerate(jtok[b])
                           if k >= 1 and t not in jtok[b, :k] and t not in jtok[1 - b])
    jtok, jn = jdecode(eos)
    ttok, tn, _ = TQ.decode_hypothesis(tm, tx, torch.from_numpy(start_tok), torch.from_numpy(tpos), eos, td, max_new=8)
    assert ttok.tolist() == jtok.tolist() and tn.tolist() == jn.tolist()
    assert tn.tolist()[lane] == step and tn.tolist()[1 - lane] == 8
    assert set(ttok[lane, step:].tolist()) == {eos}


def test_hypothesis_kv_is_disposable(weights):
    """Audio, hypothesis, audio gives the same next hypothesis as audio,
    audio: the hypothesis region is overwritten, never copied."""
    _, tm = weights
    td = TQ.DEV_TINY

    def run(decode_between):
        tc, xc = TQ.init_tower_cache(td, 1), TL.init_cache(td.text, 1, 96)
        TL.forward(tm.text, TL.embed_tokens(tm.text, torch.tensor([[1, 2, 3]])), torch.tensor([0]), xc, td.text)
        pos = 3
        for b in range(2):
            TQ.append_audio_block(tm, torch.from_numpy(_mel(td, b)), tc, xc, torch.tensor([b * 20]),
                                  torch.tensor([pos]), td)
            pos += td.block_tokens
            if decode_between and b == 0:
                TQ.decode_hypothesis(tm, xc, torch.tensor([[4]]), torch.tensor([pos]), 0, td, max_new=8)
        return TQ.decode_hypothesis(tm, xc, torch.tensor([[4]]), torch.tensor([pos]), 0, td, max_new=8)[:2]

    (ta, na), (tb, nb) = run(True), run(False)
    assert torch.equal(ta, tb) and torch.equal(na, nb)


# ---------------------------------------------------------------------------
# HF checkpoints and the qk_norm loader fault
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen3_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("qwen3_ckpt")
    CK.write_checkpoint(d, "qwen3", TQ.DEV_TINY, seed=5)
    return str(d)


@pytest.fixture()
def offline_hf(monkeypatch):
    """transformers may look a tokenizer up: keep it on the disk."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")


def test_hf_conversion_bit_equal_to_jax(qwen3_dir):
    """One directory converted by both packages (the JAX loader's reader
    and converter with the norms requested, the port's with its own reader):
    every parameter bit for bit."""
    from pathlib import Path

    from whisperlivekit_tpu.models.whisper.load import _read_safetensors_dir as jread
    from whisperlivekit_tpu_torch.models.whisper.load import _read_safetensors_dir as tread

    jparams = JQ.convert_hf_state_dict(jread(Path(qwen3_dir)), JQ.DEV_TINY)
    tm = TQ.convert_hf_state_dict(tread(Path(qwen3_dir)), TQ.DEV_TINY)
    back = TQ.qwen3_params_from_jax(jax.tree.map(np.asarray, jparams), TQ.DEV_TINY)
    got, want = tm.state_dict(), back.state_dict()
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_qk_norm_loader_fault_jax_drops_the_port_keeps(qwen3_dir, offline_hf):
    """The JAX loader builds its text dims from config.json, which has no
    q/k-norm field, so a Qwen3 checkpoint's ``self_attn.q_norm`` and
    ``k_norm`` never reach its params. The port's loader sets ``qk_norm``
    from the checkpoint and keeps them: its forward equals the JAX forward
    with ``qk_norm`` forced on the same weights."""
    jh = JC.load_qwen3_causal(JConfig(backend="qwen3", model_path=qwen3_dir, log_level="ERROR"))
    assert not jh.dims.text.qk_norm and "q_norm" not in jh.params["text"]["blocks"]
    th = TC.load_qwen3_causal(TConfig(backend="qwen3", model_path=qwen3_dir, log_level="ERROR"), device="cpu")
    assert th.dims.text.qk_norm
    assert isinstance(th.tokenizer, TC.DebugWordTokenizer)  # no tokenizer files: the debug one

    from pathlib import Path

    from whisperlivekit_tpu.models.whisper.load import _read_safetensors_dir as jread

    sd = jread(Path(qwen3_dir))
    np.testing.assert_array_equal(th.params.text.blocks[1].k_norm.numpy(), sd["model.layers.1.self_attn.k_norm.weight"])
    forced = dataclasses.replace(jh.dims, text=dataclasses.replace(jh.dims.text, qk_norm=True))
    jp = JQ.convert_hf_state_dict(sd, forced)
    ids = np.random.default_rng(4).integers(0, 512, (1, 6))
    jl, _ = JL.forward(jp["text"], JL.embed_tokens(jp["text"], jnp.asarray(ids, jnp.int32)),
                       jnp.zeros((1,), jnp.int32), JL.init_cache(forced.text, 1, 8), forced.text)
    tl, _ = TL.forward(th.params.text, TL.embed_tokens(th.params.text, torch.from_numpy(ids)), torch.tensor([0]),
                       TL.init_cache(th.dims.text, 1, 8), th.dims.text)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5, rtol=2e-5)
    dropped, _ = JL.forward(jh.params["text"], JL.embed_tokens(jh.params["text"], jnp.asarray(ids, jnp.int32)),
                            jnp.zeros((1,), jnp.int32), JL.init_cache(jh.dims.text, 1, 8), jh.dims.text)
    assert np.abs(np.asarray(dropped) - np.asarray(jl)).max() > 1e-3  # the norms matter


def test_tokenizer_files_without_transformers_raise(qwen3_dir, tmp_path, monkeypatch):
    """Only absent tokenizer files fall back to the debug tokenizer; files
    present while the library is missing raise."""
    import shutil
    import sys

    d = tmp_path / "with_tok"
    shutil.copytree(qwen3_dir, d)
    (d / "tokenizer.json").write_text("{}")
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        TC.load_qwen3_causal(TConfig(backend="qwen3", model_path=str(d), log_level="ERROR"), device="cpu")


# ---------------------------------------------------------------------------
# The streaming policy: committed words and timestamps exactly JAX's
# ---------------------------------------------------------------------------


class PunctTokenizer:
    """A hypothesis holding a sentence end and frontier words."""

    eos_id = 0

    def decode(self, ids):
        return "alpha beta. gamma delta"[: 6 + 7 * len(ids)]

    def encode(self, text):
        return []


SCENARIOS = {
    # window resets (2 s windows of 0.4 s blocks) over 6 s, then finish
    "window": dict(knobs=dict(window_s=2.0, max_new=8), chunks=6),
    # a sentence boundary commits the held-back frontier and resets
    "sentence": dict(knobs=dict(window_s=30.0, hold_back_words=2, max_new=8), chunks=4, tok=PunctTokenizer),
    # segment_max_steps flushes every decode, carrying words into the prime
    "carry": dict(knobs=dict(window_s=30.0, max_new=8, segment_max_steps=1, segment_keep_tail_steps=2,
                             prompt_context_words=2), chunks=4),
    # static context joins the shared prompt
    "context": dict(knobs=dict(window_s=2.0, max_new=8, context="t7 t8"), chunks=4),
    # a long silence (segment reset, time offset), then a speaker change
    "silence_speaker": dict(knobs=dict(window_s=4.0, max_new=8), chunks=2, events=True),
}


def _run_scenario(C, T, holder, sc):
    proc = C.Qwen3CausalProcessor(holder)
    out, t = [], 0.0

    def keep(tokens):
        out.extend((tok.text, tok.start, tok.end, tok.speaker) for tok in tokens)

    for i in range(sc["chunks"]):
        t += 1.0
        proc.insert_audio_chunk(audio_seconds(1, seed=i), t)
        keep(proc.process_iter()[0])
    if sc.get("events"):
        proc.end_silence(7.0, t)
        proc.insert_audio_chunk(audio_seconds(1, seed=9), t + 8.0)
        keep(proc.process_iter(is_last=True)[0])
        keep(proc.new_speaker(T.ChangeSpeaker(speaker=1, start=t + 8.5)))
        proc.insert_audio_chunk(audio_seconds(1.3, seed=11), t + 9.8)
        keep(proc.process_iter()[0])
    keep(proc.finish()[0])
    buf = proc.get_buffer()
    return out, proc.n_blocks_encoded, proc._carry_ids, (buf.start, buf.end, buf.text)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_processor_commits_exactly_jax(weights, name):
    jp, tm = weights
    sc = SCENARIOS[name]
    tok = sc.get("tok")
    jh = JC.Qwen3CausalASR(jp, JQ.DEV_TINY, tokenizer=tok and tok(), **sc["knobs"])
    th = TC.Qwen3CausalASR(tm, TQ.DEV_TINY, tokenizer=tok and tok(), **sc["knobs"])
    assert th.text_cache_len == jh.text_cache_len and th.prompt_ids == jh.prompt_ids
    want = _run_scenario(JC, JT, jh, sc)
    got = _run_scenario(TC, TT, th, sc)
    assert got == want
    assert want[0], "the scenario committed nothing"


@pytest.mark.parametrize("model_path", ["random:dev-tiny", "checkpoint"])
def test_loader_without_cuda_raises_not_falls_back(qwen3_dir, model_path, monkeypatch):
    """With no device given the loader asks for the card: without CUDA it
    raises rather than load the model on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = qwen3_dir if model_path == "checkpoint" else model_path
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TC.load_qwen3_causal(TConfig(backend="qwen3", model_path=path, log_level="ERROR"))


# ---------------------------------------------------------------------------
# The engine and the TestHarness
# ---------------------------------------------------------------------------


def test_engine_routes_qwen3_and_cloud():
    from whisperlivekit_tpu_torch.engine.core import CloudASRHolder, TranscriptionEngine, online_factory
    from whisperlivekit_tpu_torch.streaming.local_agreement import OnlineASRProcessor

    TranscriptionEngine.reset()
    try:
        cfg = TConfig(backend="qwen3", backend_policy="causal", model_size="random:dev-tiny", lan="en",
                      vac=False, pcm_input=True, scheduler=False, param_dtype="float32", log_level="ERROR")
        engine = TranscriptionEngine(cfg, device="cpu")
        assert engine.asr.device.type == "cpu" and engine.asr.params.dtype == torch.float32
        proc = online_factory(cfg, engine.asr)
        assert type(proc) is TC.Qwen3CausalProcessor
        proc.insert_audio_chunk(audio_seconds(1), 1.0)
        tokens, upto = proc.process_iter(is_last=True)
        assert upto > 0 and tokens
        TranscriptionEngine.reset()
        cfg = TConfig(backend="openai-api", lan="en", vac=False, pcm_input=True, log_level="ERROR",
                      openai_base_url="http://127.0.0.1:9/v1")
        engine = TranscriptionEngine(cfg, device="cpu")
        assert isinstance(engine.asr, CloudASRHolder) and engine.asr.asr.base_url == "http://127.0.0.1:9/v1"
        assert isinstance(online_factory(cfg, engine.asr), OnlineASRProcessor)
    finally:
        TranscriptionEngine.reset()


def test_harness_streams_a_qwen3_checkpoint(qwen3_dir, offline_hf):
    """The whole session pipeline (AudioProcessor through the TestHarness)
    on a Qwen3 checkpoint, local caches: words after the final flush, in
    the debug tokenizer's vocabulary."""
    from whisperlivekit_tpu_torch.harness import harness as TH

    async def main():
        async with TH.TestHarness(backend="qwen3", backend_policy="causal", model_path=qwen3_dir, lan="en",
                                  vac=False, pcm_input=True, scheduler=False, param_dtype="float32",
                                  log_level="ERROR", device="cpu") as h:
            pcm = (np.clip(audio_seconds(3), -1, 1) * 32767).astype("<i2").tobytes()
            await h.feed_pcm(pcm, speed=0)
            await h.drain(0.5)
            return await h.finish(timeout=120), type(h._processor.transcription).__name__

    try:
        state, proc = asyncio.run(main())
    finally:
        TH.reset_engine_cache()
    words = state.text.split()
    assert proc == "Qwen3CausalProcessor" and words
    assert all(w.startswith("t") and w[1:].isdigit() for w in words)
