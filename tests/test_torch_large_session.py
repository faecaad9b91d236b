"""Session-level tests of the port's large form on the CPU, with the stand-in
vocabulary (harness/vocab.py) in place of the unvendored BPE ranks:

- both packages' AlignAttSessions, wired to an XKVAllocator and driven
  through run_tick_batch, commit identical token ids on every tick across a
  session join (chunked anchor), slim and full self-KV refresh plans and an
  epoch-synchronized whole-group anchor;
- slot overflow falls to the EncPool path, and a mixed batch (pooled,
  EncPool and legacy lanes) returns every lane's outputs in order;
- a pooled program that raises is contained: the group's pools are zeroed,
  its generation bumped, its lanes served by the legacy program, the
  recovery counted and logged, and the sessions re-anchor;
- a kernel that fails to launch is not contained: the tick fails;
- the refresh decode (inc_skv) decides like the full-prefix prefill
  (inc_pooled) right after an anchor;
- the whole-group anchor's guard, and the scheduler's allocator.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperlivekit_tpu.models.whisper import model as JM
from whisperlivekit_tpu.models.whisper.dims import MODEL_DIMS
from whisperlivekit_tpu.models.whisper.tokenizer import get_tokenizer
from whisperlivekit_tpu.streaming import alignatt as JA
from whisperlivekit_tpu_torch.harness.vocab import write_standin_vocab
from whisperlivekit_tpu_torch.models.whisper import model as TM
from whisperlivekit_tpu_torch.streaming import alignatt as TA

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

DIMS = MODEL_DIMS["dev-tiny"]
CFG = dict(language="en", max_steps=4, audio_max_len=16.0, enc_tail_frames=384,
           enc_rewrite_margin=16, xkv_cache=True)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    path = write_standin_vocab(tmp_path_factory.mktemp("vocab"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WLK_TPU_ASSET_DIR", str(path.parent))
        tok = get_tokenizer(True, language="en", task="transcribe")
    jp = JM.init_params(DIMS, jax.random.PRNGKey(0), jnp.float32)
    tm = TM.params_from_jax_numpy(jax.tree.map(np.asarray, jp), DIMS)
    return (JA.AlignAttEngine(jp, DIMS, tok, JA.AlignAttConfig(**CFG)),
            TA.AlignAttEngine(tm, DIMS, tok, TA.AlignAttConfig(**CFG)), tok)


def chunk(seed, seconds=1.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    return (0.3 * np.sin(2 * np.pi * (150 + 35 * seed) * t)
            + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)


def _wire(mod, engine, n, group_width, epoch_period=50, enc_cap=8, f8=False):
    """n sessions sharing one audio pool, one f32 encoder pool and one
    allocator of f32 groups (``f8``: the allocator's own float8 groups)."""
    torch_side = mod is TA
    pool = mod.AudioPool(capacity=2 * n + 2)
    enc_pool = mod.EncPool(enc_cap, DIMS, dtype=torch.float32 if torch_side else jnp.float32)
    kw = {} if f8 else dict(dtype=torch.float32 if torch_side else jnp.float32)
    xkv = mod.XKVAllocator.for_engine(engine, group_width, epoch_period=epoch_period, **kw)
    sessions = []
    for _ in range(n):
        s = mod.AlignAttSession(engine)
        s.pool, s.enc_pool, s.xkv_alloc = pool, enc_pool, xkv
        sessions.append(s)
    return pool, enc_pool, xkv, sessions


def _count_programs(monkeypatch):
    """Wrap the port's pooled programs on the facade (as the dispatch looks
    them up there) and count their calls."""
    calls = {}
    for name in ("alignatt_tick_anchor_pooled", "alignatt_tick_anchor_group",
                 "alignatt_tick_inc_skv"):
        real = getattr(TA, name)

        def wrapped(*a, _real=real, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(TA, name, wrapped)
    return calls


def test_xkv_sessions_commit_identical_tokens(engines, monkeypatch):
    """Session 0 starts alone; session 1 joins at tick 1 (a one-lane
    chunked anchor beside session 0's pooled inc tick); at tick 3 session
    0's committed window is replaced on both sides, shifting the prefix
    head past the slim refresh reach (a full-width refresh plan); every 3
    group inc ticks an epoch passes and both sessions re-anchor in one
    whole-group program. After every tick both packages hold the same
    committed token ids."""
    _commit_identical_tokens(*engines, monkeypatch)


def test_f8_sessions_commit_identical_tokens(engines, monkeypatch):
    """The same drive in the f8 large form: both packages' decoders
    quantized by JAX's ``quantize_decoder_f8`` (bridged), and
    ``xkv_cache_dtype="f8"``, so the allocators make float8_e4m3fn pools;
    every tick both hold the same committed token ids."""
    _, _, tok = engines
    jq = JM.quantize_decoder_f8(JM.init_params(DIMS, jax.random.PRNGKey(0), jnp.float32))
    tq = TM.params_from_jax_numpy(jax.tree.map(np.asarray, jq), DIMS)
    cfg = dict(CFG, xkv_cache_dtype="f8")
    je = JA.AlignAttEngine(jq, DIMS, tok, JA.AlignAttConfig(**cfg))
    te = TA.AlignAttEngine(tq, DIMS, tok, TA.AlignAttConfig(**cfg))
    xkv = _commit_identical_tokens(je, te, tok, monkeypatch, f8=True)
    assert xkv.dtype == torch.float8_e4m3fn and xkv.groups[0].k.dtype == torch.float8_e4m3fn


def _commit_identical_tokens(je, te, tok, monkeypatch, f8=False):
    """Returns the port's allocator."""
    calls = _count_programs(monkeypatch)
    from whisperlivekit_tpu.streaming.dispatch import run_tick_batch as jax_run
    from whisperlivekit_tpu_torch.streaming.dispatch import run_tick_batch as torch_run

    sides = [(je, jax_run, *_wire(JA, je, 2, 2, epoch_period=3, f8=f8)),
             (te, torch_run, *_wire(TA, te, 2, 2, epoch_period=3, f8=f8))]
    modes, refresh_rows = [], []
    for tick in range(9):
        committed = []
        for eng, run, pool, enc_pool, xkv, sessions in sides:
            tis, live = [], []
            for j, s in enumerate(sessions):
                if j == 1 and tick < 1:
                    continue
                s.insert_audio(chunk(10 * j + tick, seconds=6.0 if not s.segments else 1.0))
                if tick == 3 and j == 0:
                    s.committed_tokens = [[700 + i for i in range(3 * TA.SKV_REFRESH_ROWS)]]
                tis.append(s.prepare_tick(False))
                live.append(s)
            outs = run(eng, tis, tok, pool=pool, enc_pool=enc_pool, xkv=xkv)
            for s, ti, o in zip(live, tis, outs):
                s.finish_tick(ti, o)
            committed.append([[list(c) for c in s.committed_tokens] for s in sessions])
        modes.append(tuple(ti.enc_mode for ti in tis))
        refresh_rows.append(tuple(
            len(ti.skv_refresh_tokens) if ti.skv_refresh_tokens is not None else 0 for ti in tis))
        assert committed[0] == committed[1], f"tick {tick}: {modes}"
    assert modes[0] == ("anchor",) and modes[1] == ("inc", "anchor"), modes
    assert any(r > TA.SKV_REFRESH_ROWS for r in refresh_rows[3]), refresh_rows
    assert ("anchor", "anchor") in modes[2:], modes
    assert calls.get("alignatt_tick_anchor_pooled", 0) >= 2, calls
    assert calls.get("alignatt_tick_anchor_group", 0) >= 1, calls
    assert calls.get("alignatt_tick_inc_skv", 0) >= 4, calls
    assert sides[1][4].groups[0].sub_epoch >= 1
    assert any(sum(len(c) for c in s.committed_tokens) for s in sides[1][5])
    return sides[1][4]



def test_auto_language_pooled_sessions_match_jax(engines, monkeypatch, tmp_path):
    """language="auto" on the pooled routes: when a session detects its
    language, the reset mirror (skv_tokens = None) turns that very tick
    into an anchor on both packages, and both commit identical token ids
    and detect the same language at the same tick."""
    monkeypatch.setenv("WLK_TPU_ASSET_DIR", str(write_standin_vocab(tmp_path).parent))
    _, _, tok = engines
    from whisperlivekit_tpu.streaming.dispatch import run_tick_batch as jax_run
    from whisperlivekit_tpu_torch.models.whisper.tokenizer import get_tokenizer as port_get
    from whisperlivekit_tpu_torch.streaming.dispatch import run_tick_batch as torch_run

    jp = JM.init_params(DIMS, jax.random.PRNGKey(0), jnp.float32)
    tm = TM.params_from_jax_numpy(jax.tree.map(np.asarray, jp), DIMS)
    cfg = dict(CFG, language="auto")
    je = JA.AlignAttEngine(jp, DIMS, tok, JA.AlignAttConfig(**cfg))
    te = TA.AlignAttEngine(tm, DIMS, port_get(True, language="en", task="transcribe"),
                           TA.AlignAttConfig(**cfg))
    sides = [(je, jax_run, *_wire(JA, je, 2, 2)), (te, torch_run, *_wire(TA, te, 2, 2))]
    detect_ticks = [[], []]
    for tick in range(10):
        state = []
        for side, (eng, run, pool, enc_pool, xkv, sessions) in enumerate(sides):
            tis = []
            for j, s in enumerate(sessions):
                s.insert_audio(chunk(30 + 10 * j + tick, seconds=3.0 if not s.segments else 1.0))
                before = s.detected_language
                tis.append(s.prepare_tick(False))
                if before is None and s.detected_language is not None:
                    detect_ticks[side].append((tick, j, tis[-1].enc_mode))
            outs = run(eng, tis, eng.tokenizer, pool=pool, enc_pool=enc_pool, xkv=xkv)
            for s, ti, o in zip(sessions, tis, outs):
                s.finish_tick(ti, o)
            state.append([(s.detected_language, [list(c) for c in s.committed_tokens],
                           ti.enc_mode) for s, ti in zip(sessions, tis)])
        assert state[0] == state[1], f"tick {tick}"
    assert detect_ticks[0] == detect_ticks[1] and len(detect_ticks[1]) == 2, detect_ticks
    assert all(mode == "anchor" for _, _, mode in detect_ticks[1]), detect_ticks

def test_slot_overflow_and_mixed_batch(engines):
    """A second session finds no free slot and takes the EncPool path; a
    batch mixing that lane, a pooled lane and a pool-less (legacy) lane
    returns each lane's outputs in input order, the legacy lane's equal to
    its solo run."""
    _, te, tok = engines
    from whisperlivekit_tpu_torch.streaming.dispatch import run_tick_batch

    pool, enc_pool, xkv, (s1, s2) = _wire(TA, te, 2, 1)
    xkv.max_groups = 1  # one 1-wide group: the second session cannot get a slot
    s_leg = TA.AlignAttSession(te)
    for i, s in enumerate((s1, s2, s_leg)):
        s.insert_audio(chunk(4 + i))
    t1, t2, t3 = (s.prepare_tick(False) for s in (s1, s2, s_leg))
    assert t1.xkv_slot is not None
    assert t2.xkv_slot is None and t2.enc_lane is not None  # EncPool fallback
    assert t3.enc_mode is None
    TA.TICK_PHASE_STATS.clear()
    batch = run_tick_batch(te, [t3, t1, t2], tok, pool=pool, enc_pool=enc_pool, xkv=xkv)
    solo = run_tick_batch(te, [t3], tok)
    assert batch[0].new_tokens == solo[0].new_tokens
    assert all(o is not None for o in batch)
    assert {"legacy", "anchor_xkv", "anchor"} <= set(TA.TICK_PHASE_STATS)
    s1.release_pool_lane()
    assert xkv.groups[0].occupancy == 0 and s1.xkv_slot is None


def test_pooled_failure_recovers_and_serves(engines, monkeypatch, caplog):
    """alignatt_tick_inc_skv raises (as a CUDA out-of-memory error would) on
    the facade: the tick still returns every lane's outputs, the group's
    pools are zeroed with their shapes kept, both generations bump,
    ``pool_recovery`` is counted and the failure logged at ERROR; the next
    tick re-anchors and the one after is back on the pooled inc path."""
    _, te, tok = engines
    from whisperlivekit_tpu_torch.streaming.dispatch import run_tick_batch

    pool, enc_pool, xkv, sessions = _wire(TA, te, 2, 2)

    def tick():
        tis = []
        for i, s in enumerate(sessions):
            s.insert_audio(chunk(i))
            tis.append(s.prepare_tick(False))
        outs = run_tick_batch(te, tis, tok, pool=pool, enc_pool=enc_pool, xkv=xkv)
        for s, ti, o in zip(sessions, tis, outs):
            s.finish_tick(ti, o)
        return tis, outs

    tick()  # anchors seed the pools
    tis, _ = tick()
    assert all(t.enc_mode == "inc" for t in tis)
    real = TA.alignatt_tick_inc_skv
    calls = {"n": 0}

    def dying(*a, **k):
        calls["n"] += 1
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")

    monkeypatch.setattr(TA, "alignatt_tick_inc_skv", dying)
    TA.TICK_PHASE_STATS.clear()
    g = xkv.groups[0]
    k_before = g.k
    with caplog.at_level(logging.ERROR):
        tis, outs = tick()
    assert calls["n"] == 1
    assert len(outs) == 2 and all(o is not None for o in outs)
    assert g.generation == 1 and enc_pool.generation == 1
    assert g.k is k_before and not g.k.any() and not g.skv_k.any() and not g.tok.any()
    assert TA.TICK_PHASE_STATS["pool_recovery"][0] == 1
    assert any("pooled inc_skv program failed" in r.getMessage() for r in caplog.records)

    monkeypatch.setattr(TA, "alignatt_tick_inc_skv", real)
    tis, outs = tick()
    assert all(t.enc_mode == "anchor" for t in tis) and all(o is not None for o in outs)
    tis, outs = tick()
    assert all(t.enc_mode == "inc" for t in tis) and all(o is not None for o in outs)


def test_whole_group_anchor_budget_guard(engines):
    """On the CPU neither package has memory statistics, so both guards
    take the JAX package's fallback: whole-group anchors only while one
    group is resident, and a memoized failure blocks them on that group for
    good. Both packages' guards take the same arguments and give the same
    answers."""
    je, te, tok = engines
    from whisperlivekit_tpu.streaming.dispatch import _whole_group_anchor_fits as jax_fits
    from whisperlivekit_tpu_torch.streaming.dispatch import _whole_group_anchor_fits

    allocs = [_wire(TA, te, 1, 1)[2], _wire(JA, je, 1, 1)[2]]
    answers = []
    for x in allocs:
        assert x.acquire() == (0, 0)
    answers.append([_whole_group_anchor_fits(te, allocs[0], 0, 1, 64), jax_fits(je, allocs[1], 0, 1, 64)])
    for x in allocs:
        x.acquire()
        assert len(x.groups) == 2
    answers.append([_whole_group_anchor_fits(te, allocs[0], 0, 1, 64), jax_fits(je, allocs[1], 0, 1, 64)])
    for x in allocs:
        x.groups.pop()
        x.groups[0].whole_anchor_blocked = True
    answers.append([_whole_group_anchor_fits(te, allocs[0], 0, 1, 64), jax_fits(je, allocs[1], 0, 1, 64)])
    assert answers == [[True, True], [False, False], [False, False]]


def test_kernel_failure_fails_the_tick(engines, monkeypatch, caplog):
    """K2 failing to launch inside the pooled inc program (a KernelError,
    which is not a RuntimeError) is not contained: the legacy program would
    serve the lanes without K2 and hide the fault. The scheduler's tick
    fails and is counted, no group recovers, and the group's pools keep
    their generation."""
    import asyncio

    _, te, tok = engines
    from whisperlivekit_tpu_torch.engine.scheduler import BatchScheduler
    from whisperlivekit_tpu_torch.ops import xkv_merge
    from whisperlivekit_tpu_torch.ops.cuda_build import KernelError

    assert not issubclass(KernelError, RuntimeError)
    sched = BatchScheduler(te, max_lanes=2, window_s=0.01)
    sessions = []
    for _ in range(2):
        s = TA.AlignAttSession(te)
        s.pool, s.enc_pool, s.xkv_alloc = sched.pool, sched.enc_pool, sched.xkv
        sessions.append(s)

    def broken_launch(*a, **k):
        raise KernelError("xkv_splice launch failed (700): injected")

    async def tick(seed):
        tis = []
        for i, s in enumerate(sessions):
            s.insert_audio(chunk(seed + i))
            tis.append(s.prepare_tick(False))
        res = await asyncio.gather(*(sched.submit(s, ti) for s, ti in zip(sessions, tis)),
                                   return_exceptions=True)
        return [ti.enc_mode for ti in tis], res

    async def main():
        first = await tick(0)
        monkeypatch.setattr(xkv_merge, "xkv_splice", broken_launch)
        return first, await tick(2)

    with caplog.at_level(logging.ERROR):
        (modes0, res0), (modes1, res1) = asyncio.run(main())
    assert modes0 == ["anchor", "anchor"] and not any(isinstance(r, Exception) for r in res0)
    assert modes1 == ["inc", "inc"]
    assert all(isinstance(r, KernelError) for r in res1), res1
    stats = sched.stats()
    assert stats["n_failed_ticks"] >= 1 and stats["n_ticks"] >= 1
    assert "pool_recovery" not in stats["tick_phases"] and "pool_recovery" not in TA.TICK_PHASE_STATS
    assert sched.xkv.groups[0].generation == 0 and not sched.xkv.groups[0].whole_anchor_blocked
    assert any("batch tick failed" in r.getMessage() for r in caplog.records)
    assert not any("pooled" in r.getMessage() for r in caplog.records)


def test_skv_tick_matches_inc_pooled_after_anchor(engines):
    """The refresh path against the full-prefix prefill path, as the JAX
    suite pins it: right after an anchor, an inc tick over the same window
    (no new audio) through ``alignatt_tick_inc_skv`` makes the same token
    decisions as ``alignatt_tick_inc_pooled`` over the same pools, since
    the pooled self-KV rows are the anchor prefill's rows."""
    _, te, tok = engines
    from whisperlivekit_tpu_torch.streaming.dispatch import run_tick_batch

    pool, enc_pool, xkv, sessions = _wire(TA, te, 2, 2)
    tis = []
    for i, s in enumerate(sessions):
        s.insert_audio(chunk(30 + i, seconds=3.0))
        tis.append(s.prepare_tick(False))
    for s, ti, o in zip(sessions, tis, run_tick_batch(te, tis, tok, pool=pool, enc_pool=enc_pool, xkv=xkv)):
        s.finish_tick(ti, o)
    tis = [s.prepare_tick(False) for s in sessions]
    assert all(t is not None and t.enc_mode == "inc" and t.skv_refresh_pos is not None for t in tis)
    g = xkv.groups[0]
    pools = (g.k, g.v, g.skv_k, g.skv_v, g.asum, g.asq, g.alast, g.acount, g.tok, enc_pool.pool)
    snap = [t.clone() for t in pools]
    TA.TICK_PHASE_STATS.clear()
    outs_skv = run_tick_batch(te, tis, tok, pool=pool, enc_pool=enc_pool, xkv=xkv)
    assert "inc_xkv" in TA.TICK_PHASE_STATS

    for t, s in zip(pools, snap):  # the same tick again, from the same pools
        t.copy_(s)
    G = g.group_width
    p_max = max(te.bucket_for(len(t.prefix_ids)) for t in tis)
    arr = TA._collect_lane_arrays(te, tis, tok, G, p_max)
    lanes = lambda f: torch.tensor([f(t) for t in tis], dtype=torch.long)  # noqa: E731
    args, statics = TA._core_device_args(te, arr, tok, p_max)
    raw = TA.alignatt_tick_inc_pooled(
        te.model, pool.pool, g.k, g.v, enc_pool.pool,
        lanes(lambda t: t.pool_lane), lanes(lambda t: t.enc_lane),
        lanes(lambda t: t.tail_start), lanes(lambda t: t.content_frames),
        lanes(lambda t: t.write_start), *args, **statics, tail_frames=te.cfg.enc_tail_frames,
    )
    outs_ref = TA._scatter_outputs(raw[0], len(tis), te.cfg.max_steps)
    for got, want in zip(outs_skv, outs_ref):
        # the gate frames may differ by design: the carried stats include
        # the rows decoded before, a fresh prefill only the prefix
        assert got.new_tokens[: got.n_keep] == want.new_tokens[: want.n_keep]
        assert (got.n_keep, got.reason) == (want.n_keep, want.reason)
        np.testing.assert_allclose(got.no_speech_p, want.no_speech_p, rtol=0, atol=1e-5)


def test_scheduler_creates_allocator(engines):
    """The large form's scheduler owns an allocator of its lane width on the
    engine's device, sized like the JAX one; the base form and a scheduler
    without incremental encoding have none."""
    je, te, tok = engines
    from whisperlivekit_tpu.streaming.pools import XKVAllocator as JAlloc
    from whisperlivekit_tpu_torch.engine.scheduler import BatchScheduler

    sched = BatchScheduler(te, max_lanes=4, incremental_encode=True)
    assert sched.xkv is not None and sched.xkv.group_width == 4
    assert sched.xkv.device == te.device and sched.xkv.dtype == te.model.dtype
    want = JAlloc.for_engine(je, 4, epoch_period=8)
    assert (sched.xkv.skv_width, sched.xkv.epoch_period, sched.xkv.max_groups) == (
        want.skv_width, want.epoch_period, want.max_groups)
    assert sched.stats()["xkv"]["n_groups"] == 0
    assert BatchScheduler(te, max_lanes=4, incremental_encode=False).xkv is None
    base = TA.AlignAttEngine(te.model, DIMS, tok, TA.AlignAttConfig(language="en"))
    assert BatchScheduler(base, max_lanes=4).xkv is None
