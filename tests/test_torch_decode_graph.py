"""The pooled causal decode's static state and step graphs
(``streaming/qwen3_batch.py`` ``DecodeGraphs``), on an expert model
(``benchmark/tests/tiny_unimoe.json``: Uni-MoE-2.0-Omni's layer at 64 wide)
and a dense one (``tiny_causal.json``: the port's DEV_TINY Qwen3), with the
weights the benchmark's families draw.

On the CPU nothing is captured: the static-buffer runner steps eagerly, and
it must give today's loop (a fresh gathered copy, ``decode_hypothesis``
without a step) bit for bit: tokens, lengths, every tracer counter and the
routing accumulator; a later op on other lanes, or at another batch, reads
its own rows from the refilled static cache. On a CUDA device (the tests
marked ``cuda``, which skip here) the captured graph's replays against the
eager loop: the tokens, lengths and counters equal and the logits compared
bit for bit, at B = 4 and 64 and for two batches in one service; one capture
a batch; a capture while another thread copies to the card.
"""

from __future__ import annotations

import importlib
import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from whisperlivekit_tpu_torch.engine.trace import TRACER
from whisperlivekit_tpu_torch.models import llama as lm
from whisperlivekit_tpu_torch.models import qwen3_asr as qm
from whisperlivekit_tpu_torch.streaming import qwen3_batch as TB
from whisperlivekit_tpu_torch.streaming import qwen3_causal as TC

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
SEED = 3_000_000_019
CONFIGS = ["tiny_unimoe.json", "tiny_causal.json"]


def _family(model_type: str):
    if str(BENCH) not in sys.path:
        sys.path.append(str(BENCH))
    return importlib.import_module(f"families.{model_type}")


def _service(name: str, capacity: int = 4, device="cpu", dtype=torch.float32, max_new: int = 6):
    cfg = json.loads((BENCH / "tests" / name).read_text())
    fam = _family(cfg["model_type"])
    dims = fam.port_dims(cfg)
    params = qm.convert_hf_state_dict(fam.draw(cfg, SEED, device, dtype), dims, dtype=dtype, device=device)
    s = cfg["serving"]
    holder = TC.Qwen3CausalASR(params, dims, prompt_ids=s["prompt_ids"], hyp_start_ids=s["hyp_start_ids"],
                               eos_id=cfg["eos_token_id"], window_s=s["window_s"], max_new=max_new)
    return TB.CausalBatchService(holder, capacity=capacity)


def _fill(svc, n: int, seed: int, blocks: int = 2):
    """``n`` lanes primed and fed ``blocks`` blocks of noise drawn from
    ``seed``; their lanes and the text position after the audio."""
    d, P = svc.dims, len(svc.holder.prompt_ids)
    rng = np.random.default_rng(seed)
    toks = [TB.LaneToken(svc.pools.acquire()) for _ in range(n)]
    svc._run_prime([(t, []) for t in toks])
    for b in range(blocks):
        svc._run_append([(t, (0.1 * rng.standard_normal(d.block_samples)).astype(np.float32), b * d.block_frames,
                          P + b * d.block_tokens) for t in toks])
    return [t.lane for t in toks], P + blocks * d.block_tokens


def _decode(svc, lanes, tpos: int, graphs, eos=None):
    """``_decode_pooled`` for ``lanes`` (padded with the scratch row to a
    power of two): (tokens, n, the tracer's counters, the routing
    accumulator), the tracer and the accumulator zeroed first."""
    h, dev = svc.holder, svc.pools.text_k.device
    B = svc._pad(len(lanes))
    lanes = list(lanes) + [TB.CausalPools.SCRATCH] * (B - len(lanes))
    TRACER.reset()
    acc = h.params.text.moe_counts
    if acc is not None:
        acc.zero_()
    tokens, n = TB._decode_pooled(
        h.params, svc.pools, torch.tensor(lanes, device=dev), torch.tensor([h.hyp_start_ids] * B, device=dev),
        torch.full((B,), tpos, device=dev), svc.dims, h.eos_id if eos is None else eos, h.max_new, graphs=graphs)
    acc = h.params.text.moe_counts
    return tokens.cpu(), n.cpu(), dict(TRACER.counters), None if acc is None else acc.cpu().clone()


GRAPH_COUNTERS = ("causal.graph_captures", "causal.graph_replays")


def _assert_same(got, want):
    """Tokens, lengths, counters (less the graph's own) and accumulator."""
    tokens, n, counters, acc = got
    assert torch.equal(tokens, want[0]) and torch.equal(n, want[1])
    assert {k: v for k, v in counters.items() if k not in GRAPH_COUNTERS} == want[2]
    assert (acc is None and want[3] is None) or torch.equal(acc, want[3])


# ---------------------------------------------------------------------------
# The CPU: the static-buffer runner, eager
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CONFIGS)
def test_static_runner_equals_the_eager_loop(name):
    svc = _service(name)
    assert svc.graphs is None  # off CUDA the service keeps today's gathered copy
    lanes, tpos = _fill(svc, 3, seed=1)
    pools = (svc.pools.text_k.clone(), svc.pools.text_v.clone())
    want = _decode(svc, lanes, tpos, None)
    graphs = TB.DecodeGraphs(svc.pools, 4)
    got = _decode(svc, lanes, tpos, graphs)
    _assert_same(got, want)
    c = got[2]
    assert c["causal.decode_steps"] == svc.holder.max_new - 1 and not set(GRAPH_COUNTERS) & c.keys()
    assert c["causal.decode_rows"] == 4 * (len(svc.holder.hyp_start_ids) + c["causal.decode_steps"])
    if svc.dims.text.moe:
        L = svc.dims.text.n_layers
        assert c["moe.calls"] == L * (1 + c["causal.decode_steps"]) and c["moe.rows"] == L * c["causal.decode_rows"]
        assert int(got[3].sum()) > 0
    # lanes that stop at different steps: the end token is one lane 0 chose
    eos = int(want[0][0, 2])
    want = _decode(svc, lanes, tpos, None, eos=eos)
    assert int(want[1].min()) < svc.holder.max_new
    _assert_same(_decode(svc, lanes, tpos, graphs, eos=eos), want)
    assert torch.equal(svc.pools.text_k, pools[0]) and torch.equal(svc.pools.text_v, pools[1])


@pytest.mark.parametrize("name", CONFIGS)
def test_static_cache_is_refilled_for_other_lanes_and_batches(name):
    svc = _service(name)
    first, tpos = _fill(svc, 2, seed=1)
    other, tpos_other = _fill(svc, 2, seed=2, blocks=3)
    graphs = TB.DecodeGraphs(svc.pools, 4)
    a = _decode(svc, first, tpos, graphs)
    b = _decode(svc, other, tpos_other, graphs)
    want = _decode(svc, other, tpos_other, None)
    _assert_same(b, want)
    assert not torch.equal(a[0][:2], b[0][:2])  # the two ops' rows differ
    one = _decode(svc, other[1:], tpos_other, graphs)  # another batch (B = 1) after B = 2
    _assert_same(one, _decode(svc, other[1:], tpos_other, None))
    assert torch.equal(one[0][0], want[0][1])


def test_service_decodes_through_installed_graphs_and_close_drops_them():
    svc = _service(CONFIGS[0])
    lanes, tpos = _fill(svc, 3, seed=1)
    items = [(TB.LaneToken(lane), tpos) for lane in lanes]
    want = svc._run_decode(items)
    svc.graphs = TB.DecodeGraphs(svc.pools, 4)
    assert svc._run_decode(items) == want
    assert svc.graphs.graphs == {}  # nothing captured on the CPU
    svc.close()
    assert svc.graphs is None and svc._run_decode(items) == want


def test_diverted_counts_go_to_the_block_only():
    TRACER.reset()
    TRACER.count("a")
    with TRACER.diverted() as outer:
        TRACER.count("a", 2)
        with TRACER.diverted() as inner:
            TRACER.count("b", 3)
        TRACER.count("c")
        other = threading.Thread(target=TRACER.count, args=("d", 5))
        other.start()
        other.join()
    TRACER.count("a", 10)
    assert outer == {"a": 2, "c": 1} and inner == {"b": 3}
    assert TRACER.counters == {"a": 11, "d": 5}
    TRACER.reset()


def test_rope_tables_take_the_frequencies_once_per_device():
    pos = torch.arange(6).view(2, 3)
    cos, sin = lm.rope_tables(pos, 16, 1e4)
    inv = lm._inv_freq(16, 1e4)
    assert lm._inv_freq_on(16, 1e4, pos.device) is lm._inv_freq_on(16, 1e4, pos.device)
    assert torch.equal(lm._inv_freq_on(16, 1e4, pos.device), inv)
    ang = pos.float()[:, :, None] * inv
    assert torch.equal(cos, torch.cos(ang)[:, :, None]) and torch.equal(sin, torch.sin(ang)[:, :, None])


# ---------------------------------------------------------------------------
# The card: captured graphs against the eager loop
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")


def _logits(svc, lanes, tpos: int, graphs):
    """Each greedy step's logits [B, V] (f32, on the host) of one decode,
    through ``graphs``' runner or, without it, the eager step on a gathered
    copy; with the tokens and lengths."""
    h, dev, dims = svc.holder, svc.pools.text_k.device, svc.dims
    B = svc._pad(len(lanes))
    lanes_t = torch.tensor(list(lanes) + [TB.CausalPools.SCRATCH] * (B - len(lanes)), device=dev)
    text = h.params.text
    if graphs is None:
        cache = lm.LlamaCache(svc.pools.text_k[:, lanes_t], svc.pools.text_v[:, lanes_t])

        def step(t, p):
            return lm.forward(text, lm.embed_tokens(text, t[:, None]), p, cache, dims.text, last_only=True)[0][:, -1]
    else:
        cache, step = graphs.load(svc.pools, lanes_t), graphs.runner(h.params, dims, B)
    seen = []

    def recorded(t, p):
        out = step(t, p)
        seen.append(out.float().cpu())
        return out

    tokens, n, _ = qm.decode_hypothesis(h.params, cache, torch.tensor([h.hyp_start_ids] * B, device=dev),
                                        torch.full((B,), tpos, device=dev), h.eos_id, dims, max_new=h.max_new,
                                        step=recorded)
    return tokens.cpu(), n.cpu(), torch.stack(seen)


def _compare_logits(got, want, what: str):
    """Tokens and lengths equal; the logits bit for bit, or else the
    largest difference reported (cuBLAS may pick another algorithm under
    capture) and the tokens still equal."""
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), what
    gap = float((got[2] - want[2]).abs().max())
    print(f"{what}: logits {'bit for bit' if torch.equal(got[2], want[2]) else f'differ by up to {gap:.3e}'}")
    assert gap < 1e-2, what


@pytest.mark.cuda
@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("B", [4, 64])
def test_graph_replay_equals_the_eager_loop_on_gpu(name, B):
    _need_cuda()
    svc = _service(name, capacity=B, device="cuda", dtype=torch.bfloat16, max_new=12)
    assert svc.graphs is not None and svc.graphs.rows == B
    lanes, tpos = _fill(svc, B - 1, seed=1)  # padded with the scratch row to B
    want = _decode(svc, lanes, tpos, None)
    first = _decode(svc, lanes, tpos, svc.graphs)  # the capture
    again = _decode(svc, lanes, tpos, svc.graphs)  # every step replayed
    _assert_same(first, want)
    _assert_same(again, want)
    steps = want[2]["causal.decode_steps"]
    assert first[2]["causal.graph_captures"] == 1 and first[2]["causal.graph_replays"] == steps - 1
    assert "causal.graph_captures" not in again[2] and again[2]["causal.graph_replays"] == steps
    _compare_logits(_logits(svc, lanes, tpos, svc.graphs), _logits(svc, lanes, tpos, None), f"{name} B={B}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CONFIGS)
def test_two_batches_in_one_service_capture_once_each_on_gpu(name):
    _need_cuda()
    svc = _service(name, capacity=64, device="cuda", dtype=torch.bfloat16, max_new=12)
    wide, tpos = _fill(svc, 64, seed=1)
    narrow = wide[5:8]  # B = 4 with the scratch row
    captures = replays = steps = 0
    for lanes in (wide, narrow, wide, narrow):
        got = _decode(svc, lanes, tpos, svc.graphs)
        _assert_same(got, _decode(svc, lanes, tpos, None))
        captures += got[2].get("causal.graph_captures", 0)
        replays += got[2].get("causal.graph_replays", 0)
        steps += got[2]["causal.decode_steps"]
    assert sorted(svc.graphs.graphs) == [4, 64]
    assert captures == 2 and replays == steps - 2
    for lanes in (narrow, wide):
        _compare_logits(_logits(svc, lanes, tpos, svc.graphs), _logits(svc, lanes, tpos, None),
                        f"{name} B={svc._pad(len(lanes))} of two")


@pytest.mark.cuda
def test_capture_while_another_thread_copies_to_the_card_on_gpu():
    _need_cuda()
    svc = _service(CONFIGS[0], capacity=8, device="cuda", dtype=torch.bfloat16, max_new=12)
    lanes, tpos = _fill(svc, 7, seed=1)
    want = _decode(svc, lanes, tpos, None)
    stop = threading.Event()
    copies = [0]

    def copy_loop():
        x = np.ones((256, 1024), np.float32)
        while not stop.is_set():
            torch.from_numpy(x).to("cuda")
            copies[0] += 1

    other = threading.Thread(target=copy_loop)
    other.start()
    try:
        got = _decode(svc, lanes, tpos, svc.graphs)
    finally:
        stop.set()
        other.join()
    assert got[2]["causal.graph_captures"] == 1 and copies[0] > 0
    _assert_same(got, want)
