"""The large form's memory planning in the port against the JAX package, on
the CPU at dev-tiny widths with the stand-in vocabulary, both packages on
the same seeded weights:

- the whole-group anchor's budget guard answers like JAX's under the same
  stubbed free and transient bytes (fits at the margin, one byte short,
  blocked, no memory statistics, no measured transient);
- with two groups resident, both packages' anchor dispatch takes the
  whole-group program when the stub fits (equal packed outputs, the other
  group's pools untouched) and the chunked program one byte short;
- off CUDA nothing is measured and the scheduler starts no warm pass;
- the warm pass runs every serving program on scratch pools and leaves a
  live group's pools bit for bit as they were.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperlivekit_tpu.models.whisper import model as JM
from whisperlivekit_tpu.models.whisper.dims import MODEL_DIMS
from whisperlivekit_tpu.models.whisper.tokenizer import get_tokenizer
from whisperlivekit_tpu.streaming import alignatt as JA
from whisperlivekit_tpu.streaming.dispatch import run_tick_batch as jax_run
from whisperlivekit_tpu_torch.harness.vocab import write_standin_vocab
from whisperlivekit_tpu_torch.models.whisper import model as TM
from whisperlivekit_tpu_torch.streaming import alignatt as TA
from whisperlivekit_tpu_torch.streaming import dispatch as TD
from whisperlivekit_tpu_torch.streaming.dispatch import run_tick_batch as torch_run

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

DIMS = MODEL_DIMS["dev-tiny"]
CFG = dict(language="en", max_steps=4, audio_max_len=16.0, enc_tail_frames=384,
           enc_rewrite_margin=16, xkv_cache=True)
GIB = 1 << 30
POOLS = ("k", "v", "skv_k", "skv_v", "asum", "asq", "alast", "acount", "tok")


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


def _wire(mod, engine, n, group_width):
    """n sessions sharing one audio pool, one f32 encoder pool and one
    allocator of f32 groups."""
    torch_side = mod is TA
    f32 = torch.float32 if torch_side else jnp.float32
    pool = mod.AudioPool(capacity=2 * n + 2)
    enc_pool = mod.EncPool(2 * n + 2, DIMS, dtype=f32)
    xkv = mod.XKVAllocator.for_engine(engine, group_width, dtype=f32)
    sessions = []
    for _ in range(n):
        s = mod.AlignAttSession(engine)
        s.pool, s.enc_pool, s.xkv_alloc = pool, enc_pool, xkv
        sessions.append(s)
    return pool, enc_pool, xkv, sessions


def _stub_budget(monkeypatch, free, temp):
    """Both packages' free and transient bytes, as each guard reads them."""
    monkeypatch.setattr(JA, "_device_free_bytes", lambda: free)
    monkeypatch.setattr(JA, "_anchor_group_temp_bytes", lambda *a: temp)
    monkeypatch.setattr(TA, "_device_free_bytes", lambda *a: free)
    monkeypatch.setattr(TA, "_anchor_group_temp_bytes", lambda *a: temp)


def _pool_bits(group) -> dict:
    """Every pool of a group (either package) as numpy, floats by their bits."""
    out = {}
    for n in POOLS:
        a = getattr(group, n)
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        out[n] = a.view(np.int32) if a.dtype == np.float32 else a.copy()
    return out


MARGIN = TA._ANCHOR_HBM_MARGIN
GUARD_CASES = {  # name: (free, temp, resident groups, blocked, expected)
    "fits_at_the_margin": (GIB + MARGIN, GIB, 2, False, True),
    "one_byte_short": (GIB + MARGIN - 1, GIB, 2, False, False),
    "blocked": (1 << 40, GIB, 1, True, False),
    "free_none_one_group": (None, GIB, 1, False, True),
    "free_none_two_groups": (None, GIB, 2, False, False),
    "temp_none_one_group": (1 << 40, None, 1, False, True),
    "temp_none_two_groups": (1 << 40, None, 2, False, False),
}


@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_guard_answers_like_jax(engines, monkeypatch, case):
    """Both packages' _whole_group_anchor_fits, in JAX's signature, under
    the same stubbed free and transient bytes (tests/test_pool_recovery.py
    holds JAX's): the budget decides while both figures are known, the
    one-group proxy while either is not, and a blocked group never runs the
    whole-group anchor."""
    je, te, _ = engines
    from whisperlivekit_tpu.streaming.dispatch import _whole_group_anchor_fits as jax_fits

    free, temp, n_groups, blocked, want = GUARD_CASES[case]
    assert TA._ANCHOR_HBM_MARGIN == JA._ANCHOR_HBM_MARGIN
    allocs = [TA.XKVAllocator.for_engine(te, 1, dtype=torch.float32),
              JA.XKVAllocator.for_engine(je, 1, dtype=jnp.float32)]
    for x in allocs:
        for _ in range(n_groups):
            x.acquire()
        assert len(x.groups) == n_groups
        x.groups[0].whole_anchor_blocked = blocked
    _stub_budget(monkeypatch, free, temp)
    got = [TD._whole_group_anchor_fits(te, allocs[0], 0, 1, 64), jax_fits(je, allocs[1], 0, 1, 64)]
    assert got == [want, want]


def _count_and_capture(monkeypatch, mod, calls):
    """Wrap both anchor programs on a package's alignatt module (the
    dispatch looks them up there): count their calls and keep the packed
    outputs as numpy."""
    for name in ("alignatt_tick_anchor_group", "alignatt_tick_anchor_pooled"):
        real = getattr(mod, name)

        def wrapped(*a, _real=real, _name=name, **k):
            out = _real(*a, **k)
            packed = out[0]
            calls.setdefault(_name, []).append(
                packed.numpy().copy() if isinstance(packed, torch.Tensor) else np.asarray(packed))
            return out

        monkeypatch.setattr(mod, name, wrapped)


def _packed_equal(to, jo, what):
    assert to.dtype == np.int32 and to.shape == jo.shape
    np.testing.assert_array_equal(to[:, :-1], jo[:, :-1], err_msg=what)
    np.testing.assert_allclose(to[:, -1].view(np.float32), jo[:, -1].view(np.float32),
                               rtol=0, atol=1e-5, err_msg=what)


def test_dispatch_routes_match_jax_with_two_groups(engines, monkeypatch):
    """Four sessions in two 2-wide groups. Group 1's sessions lose their
    self-KV mirrors and anchor together while group 0 stays resident: under
    a budget that fits exactly, both packages run the whole-group program,
    with equal packed outputs and group 0's pools untouched on both sides;
    one byte short, both run the chunked program, again with equal
    outputs. Every session commits the same tokens in both packages."""
    je, te, tok = engines
    sides = [(je, jax_run, *_wire(JA, je, 4, 2)), (te, torch_run, *_wire(TA, te, 4, 2))]
    calls = [{}, {}]
    _count_and_capture(monkeypatch, JA, calls[0])
    _count_and_capture(monkeypatch, TA, calls[1])

    def tick(tick_no, only_group=None):
        committed = []
        for eng, run, pool, enc_pool, xkv, sessions in sides:
            live = [s for s in sessions if only_group is None or s.xkv_gi == only_group]
            tis = []
            for j, s in enumerate(live):
                if only_group is not None:
                    s.skv_tokens = None  # a lost mirror: the next tick anchors
                s.insert_audio(chunk(10 * j + tick_no, seconds=4.0 if not s.segments else 1.0))
                tis.append(s.prepare_tick(False))
            outs = run(eng, tis, tok, pool=pool, enc_pool=enc_pool, xkv=xkv)
            for s, ti, o in zip(live, tis, outs):
                s.finish_tick(ti, o)
            assert all(t.enc_mode == "anchor" for t in tis) or only_group is None
            committed.append([[list(c) for c in s.committed_tokens] for s in sessions])
        assert committed[0] == committed[1], f"tick {tick_no}"

    tick(0)  # seeds both groups (two resident on the CPU: the chunked proxy)
    tick(1)
    for c in calls:
        assert "alignatt_tick_anchor_group" not in c and len(c["alignatt_tick_anchor_pooled"]) >= 2
        c.clear()
    assert [len(side[4].groups) for side in sides] == [2, 2]

    for step, (free, route) in enumerate(((GIB + MARGIN, "alignatt_tick_anchor_group"),
                                          (GIB + MARGIN - 1, "alignatt_tick_anchor_pooled"))):
        _stub_budget(monkeypatch, free, GIB)
        before = [_pool_bits(side[4].groups[0]) for side in sides]
        tick(2 + step, only_group=1)
        assert [sorted(c) for c in calls] == [[route], [route]], calls
        assert len(calls[0][route]) == len(calls[1][route])
        for jo, to in zip(calls[0][route], calls[1][route]):
            _packed_equal(to, jo, route)
        for side, want in zip(sides, before):
            got = _pool_bits(side[4].groups[0])
            for n in POOLS:
                np.testing.assert_array_equal(got[n], want[n], err_msg=f"{route}: group 0 {n}")
        for c in calls:
            c.clear()


def test_off_cuda_nothing_is_measured_and_no_warm_pass(engines, monkeypatch):
    """The CPU has no memory statistics: no free bytes, no measured
    transient, and the large form's scheduler starts no warm pass (so its
    guard keeps the one-group proxy, as JAX's does off the TPU)."""
    _, te, _ = engines
    from whisperlivekit_tpu_torch.engine.scheduler import BatchScheduler

    assert te.device.type == "cpu"
    assert TA._device_free_bytes(te.device) is None and TA._device_free_bytes("cpu") is None
    xkv = TA.XKVAllocator.for_engine(te, 2, dtype=torch.float32)
    assert TA._anchor_group_temp_bytes(te, xkv, 2, 32) is None

    def no_warm_pass(*a, **k):
        raise AssertionError("the warm pass started off CUDA")

    monkeypatch.setattr(TD, "precompile_serving_programs", no_warm_pass)
    sched = BatchScheduler(te, max_lanes=2)
    assert sched.xkv is not None and sched.warm_times is None


def test_measured_transient_lookup(engines, monkeypatch):
    """_anchor_group_temp_bytes reads the warm pass's figures by JAX's key
    (G, p_max, pool dtype, self-KV dtype, self-KV width): a bucket
    narrower than every measured one takes the nearest wider bucket's
    figure; a wider bucket, another width or another dtype was never
    measured (None)."""
    _, te, _ = engines
    xkv = TA.XKVAllocator.for_engine(te, 2, dtype=torch.float32)
    key = lambda G, p: (G, p, str(xkv.dtype), str(xkv.skv_dtype), xkv.skv_width)  # noqa: E731
    monkeypatch.setattr(te, "_anchor_temp_cache", {key(2, 64): 700, key(2, 128): 900},
                        raising=False)
    assert [TA._anchor_group_temp_bytes(te, xkv, 2, p) for p in (32, 64, 96, 128, 256)] == [
        700, 700, 900, 900, None]
    assert TA._anchor_group_temp_bytes(te, xkv, 4, 32) is None
    bf16 = TA.XKVAllocator.for_engine(te, 2, dtype=torch.bfloat16)
    assert TA._anchor_group_temp_bytes(te, bf16, 2, 32) is None


def test_warm_pass_leaves_live_pools_bit_identical(engines, monkeypatch):
    """precompile_serving_programs runs the inc tick at both refresh widths,
    the chunked anchor at B 4 and 8 and the whole-group anchor, each once,
    on scratch pools; measure_anchor_group_temp_bytes runs the whole-group
    anchor once more. Neither touches a live group's pools, the encoder
    pool or the audio pool, nor adds a group; off CUDA neither measures a
    transient."""
    _, te, tok = engines
    pool, enc_pool, xkv, sessions = _wire(TA, te, 2, 2)
    for tick_no in range(2):  # an anchor, then an inc tick: real pool contents
        tis = []
        for j, s in enumerate(sessions):
            s.insert_audio(chunk(10 * j + tick_no, seconds=4.0 if not s.segments else 1.0))
            tis.append(s.prepare_tick(False))
        for s, ti, o in zip(sessions, tis, torch_run(te, tis, tok, pool=pool, enc_pool=enc_pool,
                                                     xkv=xkv)):
            s.finish_tick(ti, o)
    assert [t.enc_mode for t in tis] == ["inc", "inc"]
    before = (_pool_bits(xkv.groups[0]), enc_pool.pool.numpy().view(np.int32).copy(),
              pool.pool.numpy().copy())
    runs = {}
    for name in ("alignatt_tick_inc_skv", "alignatt_tick_anchor_pooled",
                 "alignatt_tick_anchor_group"):
        real = getattr(TA, name)

        def wrapped(*a, _real=real, _name=name, **k):
            runs[_name] = runs.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(TA, name, wrapped)

    times = TD.precompile_serving_programs(te, xkv, enc_pool.capacity, pool.capacity)
    assert TD.measure_anchor_group_temp_bytes(te, xkv, 2, te.bucket_for(te.serving_prefix_cap)) is None
    assert sorted(times) == ["anchor_group", "anchor_pooled_b4", "anchor_pooled_b8",
                             "inc_skv", "inc_skv_full"]
    assert all(isinstance(s, float) and s >= 0 for s in times.values())
    assert set(te._serving_transient_bytes.values()) == {None}
    assert runs == {"alignatt_tick_inc_skv": 2, "alignatt_tick_anchor_pooled": 2,
                    "alignatt_tick_anchor_group": 2}
    assert not getattr(te, "_anchor_temp_cache", {})
    assert len(xkv.groups) == 1
    got = _pool_bits(xkv.groups[0])
    for n in POOLS:
        np.testing.assert_array_equal(got[n], before[0][n], err_msg=n)
    np.testing.assert_array_equal(enc_pool.pool.numpy().view(np.int32), before[1])
    np.testing.assert_array_equal(pool.pool.numpy(), before[2])
