"""Uni-MoE-2.0-Omni on the port's causal path, on the CPU at a tiny size.

The expert layer (``models/llama.py``: ``route``, ``moe_ffn``) against
planted router rows and an explicit per-token loop; the pooled service
(``streaming/qwen3_batch.py``: prime, append and decode) against the plain
reference ``benchmark/reference/unimoe_ref.py`` (loaded by path) on the
weights the benchmark's family draws for ``benchmark/tests/tiny_unimoe.json``;
three faults (top-2 routing that ignores top-p, the shared experts left
out, the routed experts' weights rounded through float8_e4m3) caught by the
same comparison; the in-place append bit for bit against a gathered copy;
the loader's sizes and configurations.

Both sides run float32 with sums in another order (the port caches,
batches lanes and runs each expert stack as one product; the reference runs
one token's experts at a time over the whole sequence), so their logits
agree to about 1e-6 for values of order 1: the tolerance is 1e-4. Each
fault moves some logit by more than 1e-2.
"""

from __future__ import annotations

import asyncio
import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from whisperlivekit_tpu_torch.audio.mel import log_mel_spectrogram
from whisperlivekit_tpu_torch.engine.trace import TRACER
from whisperlivekit_tpu_torch.models import llama as lm
from whisperlivekit_tpu_torch.models import qwen3_asr as qm
from whisperlivekit_tpu_torch.streaming import qwen3_batch as TB
from whisperlivekit_tpu_torch.streaming import qwen3_causal as TC

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
TOL = 1e-4


def _bench(name: str):
    """A module of the benchmark (``reference.unimoe_ref``, ``families.*``)
    by its path under ``benchmark/``."""
    if str(BENCH) not in sys.path:
        sys.path.append(str(BENCH))
    return importlib.import_module(name)


def _bench_tests(name: str):
    """A test module of ``benchmark/tests/`` by its path."""
    key = f"bench_tests_{name}"
    if key not in sys.modules:
        if str(BENCH / "tests") not in sys.path:
            sys.path.append(str(BENCH / "tests"))  # its ``harness``
        spec = importlib.util.spec_from_file_location(key, BENCH / "tests" / f"{name}.py")
        sys.modules[key] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[key])
    return sys.modules[key]


@pytest.fixture(scope="module")
def tiny():
    cfg = json.loads((BENCH / "tests" / "tiny_unimoe.json").read_text())
    fam = _bench("families.grin_qwen2_vl")
    sd = fam.draw(cfg, 3_000_000_019, "cpu", torch.float32)
    return cfg, sd, fam.port_dims(cfg)


# ---------------------------------------------------------------------------
# The expert layer
# ---------------------------------------------------------------------------

PLANTED = [  # router probabilities over 4 routed experts and the null one -> outputs taken
    ([0.80, 0.05, 0.05, 0.05, 0.05], [0]),        # one expert reaches 0.7
    ([0.10, 0.50, 0.30, 0.05, 0.05], [1, 2]),     # two, under the cap
    ([0.10, 0.05, 0.20, 0.05, 0.60], [4, 2]),     # the null expert first, then a routed one
    ([0.05, 0.05, 0.05, 0.05, 0.80], [4]),        # the null expert alone: no routed expert
    ([0.30, 0.30, 0.30, 0.05, 0.05], [0, 1]),     # a three-way tie: the lower indices
    ([0.40, 0.20, 0.20, 0.10, 0.10], [0, 1]),     # a tie at the cap: the lower index
]


def _dims(**kw) -> lm.MoEDims:
    base = dict(vocab_size=64, hidden_size=16, n_layers=1, n_heads=2, n_kv_heads=1, intermediate_size=24,
                head_dim=8, qkv_bias=True, n_routed_experts=4, n_null_experts=1, n_shared_experts=2,
                shared_expert_size=8, moe_top_p=0.7, moe_top_k=2)
    return lm.MoEDims(**{**base, **kw})


def test_route_takes_the_top_p_set_of_planted_rows():
    """Rows of h are unit vectors and the router's columns the logs of the
    planted probabilities, so softmax(W_r h) is each planted row (ties
    exactly)."""
    d = _dims()
    probs = torch.tensor([p for p, _ in PLANTED])
    router = lm.Dense(d.hidden_size, 5, bias=False)
    router.weight.data = torch.zeros(5, d.hidden_size)
    router.weight.data[:, : len(PLANTED)] = torch.log(probs).T
    h = torch.eye(d.hidden_size)[: len(PLANTED)]
    p, chosen = lm.route(h, router, d)
    assert torch.allclose(p, probs, atol=1e-6)
    U = _bench("reference.unimoe_ref")
    for i, (_, want) in enumerate(PLANTED):
        assert sorted(torch.nonzero(chosen[i]).flatten().tolist()) == sorted(want), i
        assert U.top_p_set(p[i].tolist(), 0.7, 2) == want, i


def _loop_ffn(h, ex, d):
    """The expert layer one token at a time, from its definition."""
    U = _bench("reference.unimoe_ref")

    def swiglu(x, g, u, dn):
        return (torch.nn.functional.silu(x @ g.T) * (x @ u.T)) @ dn

    out, took = [], torch.zeros(2, 5, dtype=torch.long)
    for row in h:
        p = torch.softmax(ex.router.weight @ row, dim=-1)
        chosen = U.top_p_set(p.tolist(), d.moe_top_p, d.moe_top_k)
        y = sum(swiglu(row, ex.shared_gate[s], ex.shared_up[s], ex.shared_down[s]) for s in range(2))
        for e in chosen:
            took[0, e] += 1
            if e < d.n_routed_experts:
                y = y + p[e] * swiglu(row, ex.gate[e], ex.up[e], ex.down[e])
        out.append(y)
    took[1] = (took[0] > 0).long()
    return torch.stack(out), took


def test_expert_layer_matches_a_per_token_loop():
    d = _dims()
    model = lm.init_params(d, torch.Generator().manual_seed(5))
    ex = model.blocks[0].experts
    ex.router.weight.data *= 2.0  # a share of rows reaches top-p with one expert
    h = torch.randn(24, d.hidden_size, generator=torch.Generator().manual_seed(6))
    counts = torch.zeros(2, 5, dtype=torch.long)
    y = lm.moe_ffn(h, ex, d, counts)
    want, took = _loop_ffn(h, ex, d)
    assert torch.allclose(y, want, atol=1e-5)
    assert torch.equal(counts, took)
    assert 0 < int(took[0, :4].sum()) < 2 * len(h)  # both one- and two-expert rows


# ---------------------------------------------------------------------------
# The pooled service against the reference
# ---------------------------------------------------------------------------


def _served_logits(cfg, sd, dims, monkeypatch):
    """Three lanes (a batch of 3, padded to 4) primed, fed 3, 2 and 1 blocks
    through the service's runners, then decoded: the logits after each
    append and at each decode step, per lane, with the tokens served."""
    serving = cfg["serving"]
    params = qm.convert_hf_state_dict(sd, dims)
    holder = TC.Qwen3CausalASR(params, dims, prompt_ids=serving["prompt_ids"], hyp_start_ids=serving["hyp_start_ids"],
                               eos_id=cfg["eos_token_id"], window_s=serving["window_s"], max_new=5)
    svc = TB.CausalBatchService(holder, capacity=4)
    seen = []
    forward, append = lm.forward, qm.append_audio_block

    def fwd(*a, **kw):
        out = forward(*a, **kw)
        seen.append(out[0][:, -1])
        return out

    def app(*a, **kw):
        out = append(*a, **kw)
        seen.append(out[2])
        return out

    monkeypatch.setattr(lm, "forward", fwd)
    monkeypatch.setattr(qm, "append_audio_block", app)
    rng = np.random.default_rng(7)
    bs, P = dims.block_samples, len(serving["prompt_ids"])
    tokens = [TB.LaneToken(svc.pools.acquire()) for _ in range(3)]
    audio = [[(0.1 * rng.standard_normal(bs)).astype(np.float32) for _ in range(3 - i)] for i in range(3)]
    svc._run_prime([(t, []) for t in tokens])
    after_append = [[] for _ in tokens]
    for b in range(3):
        rows = [i for i in range(3) if b < len(audio[i])]
        seen.clear()
        svc._run_append([(tokens[i], audio[i][b], b * dims.block_frames, P + b * dims.block_tokens) for i in rows])
        for r, i in enumerate(rows):
            after_append[i].append(seen[-1][r])
    seen.clear()
    ids = svc._run_decode([(t, P + len(a) * dims.block_tokens) for t, a in zip(tokens, audio)])
    steps = [[seen[k][i] for k in range(len(ids[i]) + (len(ids[i]) < 5))] for i in range(3)]
    return audio, after_append, ids, steps


def _reference_gaps(cfg, sd, audio, after_append, ids, steps):
    """The largest |port - reference| over every logit compared."""
    U = _bench("reference.unimoe_ref")
    ref = U.UniMoE(sd, U.dims(cfg), "cpu")
    serving = cfg["serving"]
    prompt, start = serving["prompt_ids"], serving["hyp_start_ids"]
    worst = 0.0
    for i in range(3):
        blocks = torch.from_numpy(np.stack(audio[i]))
        toks = ref.audio_tokens(blocks)
        n = toks.shape[0] // len(audio[i])
        lg = ref.text_logits(torch.cat([ref.embed(prompt), toks, ref.embed(start + ids[i])]))
        for b, got in enumerate(after_append[i]):
            worst = max(worst, float((got - lg[len(prompt) + (b + 1) * n - 1]).abs().max()))
        first = len(prompt) + toks.shape[0] + len(start) - 1
        for k, got in enumerate(steps[i]):
            worst = max(worst, float((got - lg[first + k]).abs().max()))
    return worst


def test_pooled_prime_append_decode_match_the_reference(tiny, monkeypatch):
    cfg, sd, dims = tiny
    out = _served_logits(cfg, sd, dims, monkeypatch)
    assert all(len(s) for s in out[3])
    assert _reference_gaps(cfg, sd, *out) < TOL


@pytest.mark.parametrize("fault", ["top2_only", "no_shared", "f8_routed"])
def test_each_fault_is_caught(tiny, monkeypatch, fault):
    """The faults are the benchmark's controls (``FAULTS`` of
    ``benchmark/tests/test_bench_unimoe.py``)."""
    cfg, sd, dims = tiny
    _bench_tests("test_bench_unimoe").FAULTS[fault](monkeypatch)
    assert _reference_gaps(cfg, sd, *_served_logits(cfg, sd, dims, monkeypatch)) > 100 * TOL


def test_service_counts_spans_and_routing(tiny):
    """The pooled ops' spans and counters, and the routing counts read with
    the decode's tokens."""
    cfg, sd, dims = tiny
    serving = cfg["serving"]
    holder = TC.Qwen3CausalASR(qm.convert_hf_state_dict(sd, dims), dims, prompt_ids=serving["prompt_ids"],
                               hyp_start_ids=serving["hyp_start_ids"], eos_id=cfg["eos_token_id"],
                               window_s=serving["window_s"], max_new=4)
    svc = TB.CausalBatchService(holder, capacity=4)
    toks = [TB.LaneToken(svc.pools.acquire()) for _ in range(3)]
    TRACER.reset()
    svc._run_prime([(t, []) for t in toks])
    svc._run_append([(t, np.zeros(dims.block_samples, np.float32), 0, 3) for t in toks])
    ids = svc._run_decode([(t, 3 + dims.block_tokens) for t in toks])
    c, s = TRACER.counters, TRACER.spans
    steps = max(len(x) for x in ids) - (max(len(x) for x in ids) == 4)
    assert [s[k][0] for k in ("causal.prime", "causal.append", "causal.decode")] == [1, 1, 1]
    assert s["causal.decode"][2] == 3 and s["causal.decode_step"][0] == steps + 1
    assert c["causal.append_rows"] == 4 and c["causal.decode_steps"] == steps
    assert c["causal.decode_rows"] == 4 * (1 + steps) and c["causal.logits_rows"] == 4 * (3 + steps)
    text_rows = 4 * (3 + dims.block_tokens + 1 + steps)  # prompt, audio tokens, start, steps
    assert c["moe.calls"] == 2 * (3 + steps) and c["moe.rows"] == 2 * text_rows
    assert c["moe.pairs"] + c["moe.null"] <= 2 * c["moe.rows"] and c["moe.pairs"] > 0
    assert 0 < c["moe.hit"] <= 4 * c["moe.calls"]
    assert int(holder.params.text.moe_counts.sum()) == 0  # zeroed by the read


def test_op_batcher_takes_the_ops_that_queued_behind_another_type():
    """Two ops of one type, the second submitted while a long op of another
    type holds the device, run as one batch when the lock frees."""
    import time

    from whisperlivekit_tpu_torch.engine.op_batcher import OpBatcher

    batcher, calls = OpBatcher(window_s=0.01), []

    def runner(payloads):
        calls.append(list(payloads))
        time.sleep(0.3 if payloads[0] == "long" else 0.0)
        return payloads

    batcher.register("decode", runner)
    batcher.register("append", runner)

    async def main():
        long = asyncio.ensure_future(batcher.submit("decode", "long"))
        await asyncio.sleep(0.05)
        first = asyncio.ensure_future(batcher.submit("append", 1))
        await asyncio.sleep(0.1)  # the first append's batch is waiting for the lock
        second = asyncio.ensure_future(batcher.submit("append", 2))
        return await asyncio.gather(long, first, second)

    assert asyncio.run(main()) == ["long", 1, 2]
    assert calls == [["long"], [1, 2]]
    assert batcher.stats()["append"] == {"batches": 1, "ops": 2, "avg_ops_per_batch": 2.0}


def test_op_batcher_runs_a_decode_after_the_pending_appends():
    """As the causal service registers them: a session that flushed asks for
    a decode while three others append; the decode waits for the appends,
    and then takes their decodes too, in one call."""
    from whisperlivekit_tpu_torch.engine.op_batcher import OpBatcher

    batcher, calls = OpBatcher(window_s=0.01), []
    for op, priority in (("append", 1), ("decode", 0)):
        batcher.register(op, lambda payloads, op=op: calls.append((op, list(payloads))) or payloads, priority)

    async def tick(i):
        await batcher.submit("append", i)
        return await batcher.submit("decode", i)

    async def main():
        return await asyncio.gather(batcher.submit("decode", "flush"), *(tick(i) for i in range(3)))

    assert asyncio.run(main()) == ["flush", 0, 1, 2]
    assert calls == [("append", [0, 1, 2]), ("decode", ["flush", 0, 1, 2])]


def test_op_batcher_holds_a_decode_for_two_ops_a_session():
    """A session that joins with a backlog sends one append after another;
    the waiting decode takes the other sessions after two of its appends,
    not after all five, and a flushed session's prime and append (two ops)
    still make the decode."""
    from whisperlivekit_tpu_torch.engine.op_batcher import OpBatcher

    batcher, calls = OpBatcher(window_s=0.01), []
    for op, priority in (("prime", 1), ("append", 1), ("decode", 0)):
        batcher.register(op, lambda payloads, op=op: calls.append((op, list(payloads))) or payloads, priority)

    async def tick(i):
        await batcher.submit("append", i, key=i)
        return await batcher.submit("decode", i)

    async def flushed():
        await batcher.submit("prime", "f", key="f")
        await batcher.submit("append", "f", key="f")
        return await batcher.submit("decode", "f")

    async def backlog():
        for b in range(5):
            await batcher.submit("append", ("late", b), key="late")
        return await batcher.submit("decode", "late")

    async def main():
        return await asyncio.gather(batcher.submit("decode", "first"), flushed(), backlog(),
                                    *(tick(i) for i in range(2)))

    assert asyncio.run(main()) == ["first", "f", "late", 0, 1]
    decodes = [i for i, (op, _) in enumerate(calls) if op == "decode"]
    assert calls[decodes[0]] == ("decode", ["first", 0, 1, "f"])
    late = [i for i, (_, p) in enumerate(calls) if ("late", 4) in p or ("late", 2) in p]
    assert decodes[0] < late[0]  # the decode did not wait for the backlog's third append
    assert calls[-1] == ("decode", ["late"])


# ---------------------------------------------------------------------------
# The in-place append, bit for bit
# ---------------------------------------------------------------------------


def _append_gathered(model, pools, lanes, audio, start, text_pos, dims):
    """The append as it ran before: a gathered copy of the lanes' rows of
    both pools, the block run there, the rows scattered back."""
    mel = log_mel_spectrogram(audio, n_mels=dims.n_mels)
    tc = qm.TowerCache(pools.tower_k[:, lanes], pools.tower_v[:, lanes])
    xc = lm.LlamaCache(pools.text_k[:, lanes], pools.text_v[:, lanes])
    qm.append_audio_block(model, mel, tc, xc, start, text_pos, dims)
    for pool, new in ((pools.tower_k, tc.k), (pools.tower_v, tc.v), (pools.text_k, xc.k), (pools.text_v, xc.v)):
        pool[:, lanes] = new


@pytest.mark.parametrize("which", ["qwen3", "unimoe"])
def test_in_place_append_equals_the_gathered_copy(tiny, which):
    if which == "qwen3":
        dims = qm.DEV_TINY
        model = qm.init_params(dims, torch.Generator().manual_seed(0))
    else:
        _, sd, dims = tiny
        model = qm.convert_hf_state_dict(sd, dims)
    pools = [TB.CausalPools(dims, 4, 40, tower_frames=3 * dims.block_frames) for _ in range(2)]
    rng = np.random.default_rng(3)
    lanes = torch.tensor([2, 4, 0, 0])  # two live lanes, two padding rows on the scratch row
    for b in range(2):
        audio = torch.from_numpy((0.1 * rng.standard_normal((4, dims.block_samples))).astype(np.float32))
        start = torch.full((4,), b * dims.block_frames)
        tpos = torch.full((4,), 3 + b * dims.block_tokens)
        TB._append_pooled(model, pools[0], lanes, audio, start, tpos, dims)
        _append_gathered(model, pools[1], lanes, audio, start, tpos, dims)
    for name in ("tower_k", "tower_v", "text_k", "text_v"):
        a, b = getattr(pools[0], name), getattr(pools[1], name)
        assert torch.equal(a[:, 1:], b[:, 1:]), name  # every row but the scratch row
        assert a[:, 2].abs().sum() > 0


# ---------------------------------------------------------------------------
# Sizes and the loader
# ---------------------------------------------------------------------------


def _catalog_config() -> dict:
    return json.loads((BENCH / "configs" / "uni-moe-2.0-omni.json").read_text())


def test_published_widths_from_the_size_and_the_config():
    d = qm.UNIMOE_2_OMNI
    t = d.text
    assert (t.n_layers, t.hidden_size, t.n_heads, t.n_kv_heads, t.head_dim) == (28, 3584, 28, 4, 128)
    assert (t.vocab_size, t.tie_embeddings, t.qkv_bias, t.qk_norm) == (152064, False, True, False)
    assert (t.n_routed_experts, t.n_null_experts, t.n_shared_experts) == (4, 1, 2)
    assert (t.intermediate_size, t.shared_expert_size, t.moe_top_p, t.moe_top_k) == (18944, 2368, 0.7, 2)
    assert (t.rope_theta, t.rms_eps) == (1e6, 1e-6)
    assert (d.audio_layers, d.d_audio, d.audio_heads, d.audio_ff, d.n_mels, d.downsample) == (32, 1280, 20, 5120, 128, 5)
    cfg = _catalog_config()
    assert qm.dims_from_grin_qwen2_vl(cfg) == d
    assert qm.dims_from_grin_qwen2_vl(cfg, cfg["audio_config"]) == d
    with torch.device("meta"):
        model = qm.Qwen3ASR(d, lm_head=True)
    text = sum(p.numel() for p in model.text.parameters())
    experts = sum(p.numel() for n, p in model.text.named_parameters() if ".experts." in n and "router" not in n)
    assert 26.1e9 < text < 26.2e9 and 24.2e9 < experts < 24.3e9  # 22.81 B routed + 1.43 B shared


def test_random_size_builds_the_published_dims(monkeypatch):
    """``random:uni-moe-2.0-omni`` draws the published widths (the draw is
    replaced here: 26.8 B parameters do not fit this test)."""
    got, init = {}, qm.init_params

    def fake(dims, gen, dtype=torch.float32, device="cpu"):
        got.update(dims=dims, dtype=dtype)
        return init(qm.DEV_TINY, gen, dtype=dtype, device=device)

    monkeypatch.setattr(qm, "init_params", fake)
    cfg = dataclasses.make_dataclass("C", [("model_path", str), ("model_size", str)])(
        "random:uni-moe-2.0-omni", "")
    holder = TC.load_qwen3_causal(cfg, device="cpu", dtype=torch.bfloat16)
    assert got == {"dims": qm.UNIMOE_2_OMNI, "dtype": torch.bfloat16}
    assert holder.dims == qm.UNIMOE_2_OMNI


def _write_dir(path: Path, config: dict, sd=None) -> Path:
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(config))
    if sd is not None:
        from safetensors.torch import save_file

        save_file({k: v.contiguous() for k, v in sd.items()}, str(path / "model.safetensors"))
    return path


def test_grin_config_directory_loads_its_dims_and_weights(tiny, tmp_path):
    cfg, sd, dims = tiny
    conf = dataclasses.make_dataclass("C", [("model_path", str), ("model_size", str)])
    with pytest.raises(FileNotFoundError):  # no weights: no random stand-in
        TC.load_qwen3_causal(conf(str(_write_dir(tmp_path / "bare", cfg)), ""), device="cpu")
    full = TC.load_qwen3_causal(conf(str(_write_dir(tmp_path / "full", cfg, sd)), ""), device="cpu")
    assert full.dims == dims
    assert torch.equal(full.params.text.blocks[1].experts.down, sd["model.layers.1.mlp.experts.down_proj"])
    assert torch.equal(full.params.text.blocks[0].wk.bias, sd["model.layers.0.self_attn.k_proj.bias"])


def test_checkpoint_audio_config_sets_the_tower_blocks(tmp_path):
    """A Qwen3-ASR checkpoint's ``audio_config`` may set ``downsample``,
    ``block_frames`` and ``max_frames``."""
    fam = _bench("families.qwen3_causal")
    cfg = json.loads((BENCH / "tests" / "tiny_causal.json").read_text())
    cfg["audio_config"].update(downsample=5, block_frames=25, max_frames=250)
    sd = fam.draw(cfg, 1, "cpu", torch.float32)
    conf = dataclasses.make_dataclass("C", [("model_path", str), ("model_size", str)])
    holder = TC.load_qwen3_causal(conf(str(_write_dir(tmp_path / "q", cfg, sd)), ""), device="cpu")
    d = holder.dims
    assert (d.downsample, d.block_frames, d.max_frames) == (5, 25, 250)
    assert holder.params.tower.proj.weight.shape[1] == 5 * d.d_audio


def test_engine_serves_a_grin_config_through_the_batch_service(tiny, tmp_path):
    from whisperlivekit_tpu_torch.config import WLKConfig
    from whisperlivekit_tpu_torch.engine.core import TranscriptionEngine, online_factory

    cfg, sd, dims = tiny
    path = _write_dir(tmp_path / "grin", cfg, sd)
    TranscriptionEngine.reset()
    try:
        conf = WLKConfig(backend="qwen3", backend_policy="causal", model_path=str(path), lan="en", vac=False,
                         pcm_input=True, scheduler=True, max_batch_sessions=2, param_dtype="float32",
                         log_level="ERROR")
        engine = TranscriptionEngine(conf, device="cpu")
        assert isinstance(engine.scheduler, TB.CausalBatchService)
        assert engine.asr.dims == dims
        engine.warmup_synthetic()
        proc = online_factory(conf, engine.asr, scheduler=engine.scheduler)

        async def one():
            proc.insert_audio_chunk(np.zeros(2 * dims.block_samples, np.float32), 0.8)
            await proc.process_iter_async()
            proc.close()

        asyncio.run(one())
        assert engine.scheduler.stats()["decode"]["ops"] >= 2
    finally:
        TranscriptionEngine.reset()
