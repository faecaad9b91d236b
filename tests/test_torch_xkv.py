"""Port parity for the large form: the cross-KV splice (kernel K2's plain
version), ``cross_kv_into_pool`` and the pooled tick programs of
whisperlivekit_tpu_torch against the JAX package, at dev-tiny size with JAX
weights bridged through numpy and inputs made from numpy seeds.

- ``xkv_splice_plain`` equals both the Pallas ``xkv_splice`` (interpret mode)
  and ``xkv_splice_ref`` exactly: it is a copy (and a round-to-nearest cast);
- ``cross_kv_into_pool`` within 1e-5 in f32 and one bf16 step in bf16, the
  bars of tests/test_torch_model.py;
- the pooled slice (``alignatt_tick_anchor_pooled``, then
  ``alignatt_tick_anchor_group``, then three ``alignatt_tick_inc_skv``, the
  last with a full-width refresh plan) on the same pools: packed integer
  outputs and the token pool exactly equal, ``no_speech_p`` within 1e-5 and
  the float pools within 1e-4 (the f32 bars of tests/test_torch_tick.py);
  a slot that never runs keeps every pool bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperlivekit_tpu.models.whisper import model as JM
from whisperlivekit_tpu.models.whisper.dims import MODEL_DIMS
from whisperlivekit_tpu.models.whisper.tokenizer import get_tokenizer
from whisperlivekit_tpu.ops import xkv_merge as JX
from whisperlivekit_tpu.streaming import alignatt as JA
from whisperlivekit_tpu.streaming import pools as JP
from whisperlivekit_tpu_torch.harness.vocab import write_standin_vocab
from whisperlivekit_tpu_torch.models.whisper import model as TM
from whisperlivekit_tpu_torch.ops import xkv_merge as TX
from whisperlivekit_tpu_torch.ops.f8 import F8
from whisperlivekit_tpu_torch.streaming import alignatt as TA
from whisperlivekit_tpu_torch.streaming import pools as TP

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

DIMS = MODEL_DIMS["dev-tiny"]
N = 480000
L, G, H, Dh, Tp = 4, 3, 2, 64, 1536


def _bits(x) -> np.ndarray:
    """Raw bits of a torch or JAX array, so bf16 and f8 compare exactly."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        view = {torch.bfloat16: torch.int16, F8: torch.uint8}.get(x.dtype)
        return (x.view(view) if view else x).numpy()
    a = np.asarray(x)
    view = {"bfloat16": np.int16, "float8_e4m3fn": np.uint8}.get(str(a.dtype))
    return a.view(view) if view else a


def _splice_inputs(seed, tail_dtype, pool_dtype, tail_edges=False):
    """Pools and tails from one seed; ``tail_edges`` puts overflow,
    non-finite, near-448 and subnormal values into the tails."""
    rng = np.random.default_rng(seed)
    pk = rng.standard_normal((L, G, H, Dh, Tp)).astype(np.float32)
    tk = rng.standard_normal((L, G, H, Dh, TX.W_SPLICE)).astype(np.float32)
    if tail_edges:
        edges = np.array([447.9, 448.0, 463.9, 464.0, 464.1, 1e4, -1e4, np.inf, -np.inf, np.nan,
                          -0.0, 2.0 ** -10, 3 * 2.0 ** -10, -2.0 ** -8, 1e-30], np.float32)
        hit = rng.random(tk.shape) < 0.05
        tk[hit] = rng.choice(edges, hit.sum())
        tk *= np.where(rng.random(tk.shape) < 0.05, 300.0, 1.0).astype(np.float32)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, F8: jnp.float8_e4m3fn}
    jax_in = tuple(jnp.asarray(a).astype(jdt[dt]) for a, dt in (
        (pk, pool_dtype), (pk * 0.5 + 1.0, pool_dtype), (tk, tail_dtype), (tk * 2.0, tail_dtype)))
    # the same bits on both sides (torch rounds f32 NaN to a bf16 NaN of
    # another sign than XLA does)
    torch_in = tuple(torch.from_numpy(_bits(a).copy()).view(dt) for a, dt in
                     zip(jax_in, (pool_dtype, pool_dtype, tail_dtype, tail_dtype)))
    return jax_in, torch_in


@pytest.mark.parametrize("wn", [[256, 999, 1500], [300, 384, 0]])
@pytest.mark.parametrize("tail_dtype,pool_dtype", [
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16),  # the cast rounds to nearest even
    (torch.float32, F8),              # JAX's f8 cast: overflow to NaN
    (torch.bfloat16, F8),
])
def test_xkv_splice_plain_matches_jax_exactly(wn, tail_dtype, pool_dtype):
    jax_in, torch_in = _splice_inputs(sum(wn), tail_dtype, pool_dtype)
    win = np.asarray(wn, np.int32)
    want_kernel = JX.xkv_splice(*jax_in, jnp.asarray(win), interpret=True)
    want_ref = JX.xkv_splice_ref(*jax_in, jnp.asarray(win))
    got = TX.xkv_splice_plain(*torch_in, torch.from_numpy(win))
    for g, wk, wr in zip(got, want_kernel, want_ref):
        assert g.dtype == pool_dtype
        np.testing.assert_array_equal(_bits(g), _bits(wk))
        np.testing.assert_array_equal(_bits(g), _bits(wr))
    # the wrapper on CPU tensors: the plain version, in place, no launch
    before = TX.xkv_splice.launches
    pk, pv = torch_in[0].clone(), torch_in[1].clone()
    out = TX.xkv_splice(pk, pv, *torch_in[2:], torch.from_numpy(win))
    assert out[0] is pk and out[1] is pv and TX.xkv_splice.launches == before
    np.testing.assert_array_equal(_bits(pk), _bits(got[0]))
    np.testing.assert_array_equal(_bits(pv), _bits(got[1]))


@pytest.mark.parametrize("tail_dtype", [torch.float32, torch.bfloat16])
def test_xkv_splice_plain_f8_edges_match_jax(tail_dtype):
    """Tails holding overflow (past 464), +-inf, NaN, near-448, subnormal
    and -0 values, spliced into f8 pools at an edge lane (win 1: dst0 0),
    the last lane (win 1500: dst0 Tp-256) and an idle lane: every byte as
    ``xkv_splice_ref`` writes it, through the wrapper in place."""
    jax_in, torch_in = _splice_inputs(17, tail_dtype, F8, tail_edges=True)
    win = np.asarray([1, 1500, 0], np.int32)
    want = JX.xkv_splice_ref(*jax_in, jnp.asarray(win))
    pk, pv = torch_in[0].clone(), torch_in[1].clone()
    got = TX.xkv_splice(pk, pv, *torch_in[2:], torch.from_numpy(win))
    assert got[0] is pk and pk.dtype == F8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    nan = np.isnan(np.asarray(want[0][:, :2]).astype(np.float32))
    assert nan.any()  # the overflow and the non-finite values did reach the pool
    np.testing.assert_array_equal(_bits(pk)[:, 2], _bits(torch_in[0])[:, 2])  # idle lane


def test_splice_dst0_matches_jax():
    wn = np.concatenate([np.arange(0, 1501, 7), [1, 127, 128, 129, 255, 256, 1535]]).astype(np.int32)
    want = np.asarray(JX.splice_dst0(jnp.asarray(wn), Tp))
    got = TX.splice_dst0(torch.from_numpy(wn).long(), Tp).numpy()
    np.testing.assert_array_equal(got, want)


def test_build_without_nvcc_raises_kernel_error(monkeypatch, tmp_path):
    """A kernel that cannot be built raises KernelError, which is not a
    RuntimeError, so the pooled-program containment does not swallow it."""
    from whisperlivekit_tpu_torch.ops import cuda_build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(cuda_build.KernelError, match="nvcc not found") as err:
        cuda_build.find_nvcc()
    assert not isinstance(err.value, RuntimeError)


@pytest.mark.cuda
@pytest.mark.parametrize("tail_dtype,pool_dtype", [
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16),
    (torch.float32, F8),
    (torch.bfloat16, F8),
])
def test_xkv_splice_kernel_matches_plain_on_gpu(tail_dtype, pool_dtype):
    """The CUDA kernel against its plain version, exactly, with active,
    edge and inactive lanes (f8 pools: tails with overflow and non-finite
    values)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    _, torch_in = _splice_inputs(5, tail_dtype, pool_dtype, tail_edges=pool_dtype == F8)
    pk, pv, tk, tv = (x.cuda() for x in torch_in)
    win = torch.tensor([1, 1500, 0], device="cuda")
    want_k, want_v = TX.xkv_splice_plain(pk, pv, tk, tv, win)
    before = TX.xkv_splice.launches
    got_k, got_v = TX.xkv_splice(pk, pv, tk, tv, win)
    torch.cuda.synchronize()
    assert TX.xkv_splice.launches == before + 1 and got_k is pk
    np.testing.assert_array_equal(_bits(got_k), _bits(want_k))
    np.testing.assert_array_equal(_bits(got_v), _bits(want_v))


# ---------------------------------------------------------------------------
# cross_kv_into_pool
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jp = JM.init_params(DIMS, jax.random.PRNGKey(0), jnp.float32)
    return jp, TM.params_from_jax_numpy(jax.tree.map(np.asarray, jp), DIMS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_kv_into_pool_matches_jax(weights, dtype):
    """Active slots get the projection (zero-padded to Tp), the inactive
    slot keeps every bit."""
    jp, tm = weights
    rng = np.random.default_rng(7)
    Gp = 3
    enc = rng.standard_normal((Gp, DIMS.n_audio_ctx, DIMS.n_audio_state)).astype(np.float32)
    shape = (DIMS.n_text_layer, Gp, DIMS.n_text_head, DIMS.head_dim, Tp)
    pool0 = rng.standard_normal(shape).astype(np.float32)
    active = np.array([True, False, True])
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jparams = jax.tree.map(lambda a: a.astype(jdt), jp)
    tmodel = TM.params_from_jax_numpy(jax.tree.map(np.asarray, jp), DIMS, dtype=tdt)
    want = JM.cross_kv_into_pool(
        jparams, jnp.asarray(enc).astype(jdt), jnp.asarray(pool0).astype(jdt),
        jnp.asarray(pool0 * 2).astype(jdt), DIMS, active=jnp.asarray(active))
    pk = torch.from_numpy(pool0).to(tdt)
    pv = torch.from_numpy(pool0 * 2).to(tdt)
    got = TM.cross_kv_into_pool(tmodel, torch.from_numpy(enc).to(tdt), pk, pv, DIMS,
                                active=torch.from_numpy(active))
    assert got.k is pk and got.v is pv  # written in place
    for g, w in zip(got, want):
        g32, w32 = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        np.testing.assert_array_equal(_bits(g[:, 1]), _bits(w[:, 1]))   # inactive: untouched
        assert not g32[:, :, :, :, DIMS.n_audio_ctx:][:, active].any()  # padding zeroed
        if dtype == "float32":
            np.testing.assert_allclose(g32, w32, rtol=0, atol=1e-5)
        else:
            # f32 sums in two orders, each rounded once to bf16: at most one
            # bf16 step apart, and rarely (tests/test_torch_model.py)
            diff = np.abs(g32 - w32)
            assert (diff <= np.abs(w32) * 2.0 ** -7 + 1e-4).all(), diff.max()
            assert (diff > 0).mean() < 1e-3, (diff > 0).mean()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_kv_into_pool_f8_matches_jax(weights, dtype):
    """Into a float8_e4m3fn pool the f32 projection is rounded once, as JAX
    rounds it: JAX's bytes up to one f8 step where the two packages' f32
    sums straddle a rounding boundary; the inactive slot keeps every byte,
    the padding columns are zero bytes."""
    jp, _ = weights
    rng = np.random.default_rng(8)
    Gp = 3
    enc = rng.standard_normal((Gp, DIMS.n_audio_ctx, DIMS.n_audio_state)).astype(np.float32)
    shape = (DIMS.n_text_layer, Gp, DIMS.n_text_head, DIMS.head_dim, Tp)
    pool0 = jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(jnp.float8_e4m3fn)
    active = np.array([True, False, True])
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jparams = jax.tree.map(lambda a: a.astype(jdt), jp)
    tmodel = TM.params_from_jax_numpy(jax.tree.map(np.asarray, jp), DIMS, dtype=tdt)
    want = JM.cross_kv_into_pool(jparams, jnp.asarray(enc).astype(jdt), pool0, pool0,
                                 DIMS, active=jnp.asarray(active))
    pk = torch.from_numpy(_bits(pool0).copy()).view(F8)
    pv = pk.clone()
    got = TM.cross_kv_into_pool(tmodel, torch.from_numpy(enc).to(tdt), pk, pv, DIMS,
                                active=torch.from_numpy(active))
    assert got.k is pk and got.v is pv and pk.dtype == F8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g)[:, 1], _bits(pool0)[:, 1])
        assert not _bits(g)[:, active][..., DIMS.n_audio_ctx:].any()
        _assert_f8_close(g, w, dtype)


# ---------------------------------------------------------------------------
# The pooled slice: anchor_pooled -> anchor_group -> inc_skv x 3
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines(tmp_path_factory, weights):
    path = write_standin_vocab(tmp_path_factory.mktemp("vocab"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WLK_TPU_ASSET_DIR", str(path.parent))
        tok = get_tokenizer(True, language="en", task="transcribe")
    jp, tm = weights
    cfg = dict(language="en", max_steps=4, xkv_cache=True, enc_tail_frames=128,
               enc_rewrite_margin=16)
    return (JA.AlignAttEngine(jp, DIMS, tok, JA.AlignAttConfig(**cfg)),
            TA.AlignAttEngine(tm, DIMS, tok, TA.AlignAttConfig(**cfg)), tok)


@pytest.fixture(scope="module")
def engines_f8(engines, weights):
    """The f8 large form on both sides: JAX's ``quantize_decoder_f8`` weights
    (bridged into the port) and ``xkv_cache_dtype="f8"``."""
    jp, _ = weights
    _, _, tok = engines
    jq = JM.quantize_decoder_f8(jp)
    tq = TM.params_from_jax_numpy(jax.tree.map(np.asarray, jq), DIMS)
    cfg = dict(language="en", max_steps=4, xkv_cache=True, enc_tail_frames=128,
               enc_rewrite_margin=16, xkv_cache_dtype="f8")
    return (JA.AlignAttEngine(jq, DIMS, tok, JA.AlignAttConfig(**cfg)),
            TA.AlignAttEngine(tq, DIMS, tok, TA.AlignAttConfig(**cfg)), tok)


def _speechlike(B, seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    sig = np.stack([
        0.3 * np.sin(2 * np.pi * (180 + 60 * i) * t) * (1 + 0.4 * np.sin(2 * np.pi * 3.1 * t))
        + 0.05 * rng.standard_normal(t.shape)
        for i in range(B)
    ])
    return (np.clip(sig, -1, 1 - 1 / 32768) * 32768).astype(np.int16)


def _assert_f8_close(got, want, what=""):
    """Two f8 tensors rounded from f32 projections that differ in summation
    order: NaN exactly where the other has NaN, every other byte equal or
    one f8 step apart (an f32 value within its own rounding error of an f8
    midpoint), and under 1e-4 of them not equal."""
    g, w = _bits(got), _bits(want)
    gf = np.asarray(torch.from_numpy(g.copy()).view(F8).float())
    wf = np.asarray(torch.from_numpy(w.copy()).view(F8).float())
    np.testing.assert_array_equal(np.isnan(gf), np.isnan(wf), err_msg=what)
    fin = ~np.isnan(wf)
    m = np.maximum(np.abs(gf[fin]), np.abs(wf[fin]))
    step = np.where(m < 2.0 ** -6, 2.0 ** -9, 2.0 ** (np.floor(np.log2(np.maximum(m, 2.0 ** -6))) - 3))
    assert (np.abs(gf[fin] - wf[fin]) <= step).all(), what
    assert (g != w).mean() < 1e-4, (what, (g != w).mean())


class _Sides:
    """The same group pools as JAX arrays (replaced by each program) and as
    torch tensors (updated in place), started from the same random bits.
    ``pool_dtype=F8`` makes the cross-KV pools float8_e4m3fn."""

    NAMES = ("k", "v", "enc", "skv_k", "skv_v", "asum", "asq", "alast", "acount", "tok")

    def __init__(self, Wc, K, seed, pool_dtype=torch.float32):
        rng = np.random.default_rng(seed)
        shapes = dict(
            k=(DIMS.n_text_layer, G, DIMS.n_text_head, DIMS.head_dim, Tp),
            enc=(4, DIMS.n_audio_ctx, DIMS.n_audio_state),
            skv_k=(DIMS.n_text_layer, G, Wc, DIMS.n_text_head, DIMS.head_dim),
            asum=(G, K, DIMS.n_audio_ctx), acount=(G,),
        )
        shapes["v"], shapes["skv_v"] = shapes["k"], shapes["skv_k"]
        shapes["asq"] = shapes["alast"] = shapes["asum"]
        self.np = {n: rng.standard_normal(shapes[n]).astype(np.float32) for n in shapes}
        self.np["tok"] = rng.integers(0, 50000, (G, DIMS.n_text_ctx)).astype(np.int32)
        self.j = {n: jnp.asarray(a) for n, a in self.np.items()}
        self.f8 = pool_dtype == F8
        if self.f8:
            for n in ("k", "v"):
                self.j[n] = self.j[n].astype(jnp.float8_e4m3fn)
                self.np[n] = _bits(self.j[n]).copy()
        self.t = {n: torch.from_numpy(a.copy()) for n, a in self.np.items()}
        if self.f8:
            self.t["k"], self.t["v"] = self.t["k"].view(F8), self.t["v"].view(F8)

    def jax_pools(self):
        return [self.j[n] for n in self.NAMES]

    def torch_pools(self):
        return [self.t[n] for n in self.NAMES]

    def take_jax(self, outs):
        for n, a in zip(self.NAMES, outs):
            self.j[n] = a

    def compare(self, what):
        for n in self.NAMES:
            if self.f8 and n in ("k", "v"):
                assert self.t[n].dtype == F8 and self.j[n].dtype == jnp.float8_e4m3fn
                _assert_f8_close(self.t[n], self.j[n], f"{what}: {n}")
                continue
            got, want = self.t[n].numpy(), np.asarray(self.j[n])
            if n == "tok":
                np.testing.assert_array_equal(got, want, err_msg=f"{what}: {n}")
            elif self.f8 and n in ("asum", "asq", "alast"):
                # a frame whose f8 key is one step off JAX's moves the
                # attention at that frame a little in every row the running
                # sums add up: 1e-3, and past 1e-4 only at such frames
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-3, err_msg=f"{what}: {n}")
                assert (np.abs(got - want) > 1e-4).mean() < 1e-3, f"{what}: {n}"
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=f"{what}: {n}")


def _packed_equal(to, jo, what):
    to, jo = to.numpy(), np.asarray(jo)
    assert to.dtype == np.int32 and to.shape == jo.shape
    np.testing.assert_array_equal(to[:, :-1], jo[:, :-1], err_msg=what)
    np.testing.assert_allclose(to[:, -1].view(np.float32), jo[:, -1].view(np.float32),
                               rtol=0, atol=1e-5, err_msg=what)


def _refresh_plan(prefix, mirror, R, Wc, sot_index):
    """The session plan's refresh rows: slot 0 the sot row, the delta rows
    [common, plen) right-aligned, scratch rows (Wc-1, eot) between."""
    plen = len(prefix)
    common = 0
    for a, b in zip(mirror, prefix):
        if a != b:
            break
        common += 1
    start = 0 if R > JA.SKV_REFRESH_ROWS else max(0, min(common, plen - 1), plen - (R - 1))
    rows = list(range(start, plen))
    assert len(rows) <= R - 1
    tok = np.full(R, 50257, np.int32)
    pos = np.full(R, Wc - 1, np.int32)
    tok[0], pos[0] = prefix[sot_index], sot_index
    for j, q in enumerate(rows):
        tok[R - len(rows) + j], pos[R - len(rows) + j] = prefix[q], q
    return tok, pos


def test_pooled_slice_matches_jax(engines):
    """Slot 1 never runs (padded, then inactive): its pool rows keep every
    bit but the scratch row Wc-1, where inactive lanes park their writes."""
    _pooled_slice(*engines, pool_dtype=torch.float32)


def test_pooled_slice_f8_matches_jax(engines_f8):
    """The f8 large form (``decoder_dtype="f8"`` weights, float8_e4m3fn
    cross-KV pools): the chunked anchor, the whole-group anchor and three
    pooled inc ticks give JAX's packed integers; the f8 pools hold JAX's
    bytes up to one f8 step where the two f32 projections straddle an f8
    rounding boundary (_assert_f8_close)."""
    _pooled_slice(*engines_f8, pool_dtype=F8)


def _pooled_slice(je, te, tok, pool_dtype):
    max_steps, tail, p_max = 4, 128, 32
    Wc = 96 + 16 + max_steps + 2
    K = int(je.align_layers.shape[0])
    sides = _Sides(Wc, K, seed=11, pool_dtype=pool_dtype)
    idle = {n: sides.np[n][:, 1].copy() if n in ("k", "v", "skv_k", "skv_v") else None
            for n in _Sides.NAMES}
    pcm = _speechlike(2, 8.0, 3)
    audio_lanes = np.array([1, 2, 0], np.int32)   # by slot; slot 1 rides along
    enc_lanes = np.array([1, 0, 2], np.int32)     # slot 1 -> the scratch row
    active = np.array([True, False, True])
    jpool = jnp.zeros((3, N), jnp.int16)
    tpool = torch.zeros((3, N), dtype=torch.int16)
    sot = list(tok.sot_sequence_including_notimestamps)
    prefixes = {0: list(sot), 2: list(sot)}
    mirror = {0: [], 2: []}
    last_attend = np.full(G, -200, np.int32)
    statics = dict(dims=DIMS, max_steps=max_steps, eot=tok.eot, ts_begin=tok.timestamp_begin,
                   no_speech_tok=tok.no_speech, space_tok=tok.encode(" ")[0])
    tick_statics = dict(statics, p_max=p_max)
    synced = 0
    for tick in range(5):
        have = 16000 * (3 + tick)
        start = (synced // 128) * 128
        chunk = np.zeros((2, 160000), np.int16)
        chunk[:, : have - start] = pcm[:, start:have]
        upd = (np.array([1, 0], np.int32), np.zeros(2, np.int32), np.full(2, start, np.int32),
               np.full(2, have - start, np.int32), chunk)
        jpool = JP._pool_update(jpool, *(jnp.asarray(x) for x in upd))
        TP._pool_update(tpool, *(torch.from_numpy(x) for x in upd))
        win = have // 320
        content = np.where(active, win, 0).astype(np.int32)
        what = f"tick {tick}"
        if tick < 2:
            Bp = 4 if tick == 0 else G
            order = [2, 0] if tick == 0 else [0, 1, 2]  # batch lane -> slot
            arr = dict(prefix=np.full((Bp, p_max), tok.eot, np.int32),
                       prefix_len=np.ones(Bp, np.int32), sot_index=np.zeros(Bp, np.int32),
                       content_frames=np.zeros(Bp, np.int32),
                       last_attend=np.zeros(Bp, np.int32), is_last=np.zeros(Bp, bool),
                       max_new=np.full(Bp, 50, np.int32), active=np.zeros(Bp, bool))
            for b, sl in enumerate(order):
                if not active[sl]:
                    continue
                arr["prefix"][b, : len(prefixes[sl])] = prefixes[sl]
                arr["prefix_len"][b] = len(prefixes[sl])
                arr["content_frames"][b] = win
                arr["last_attend"][b] = last_attend[sl]
                arr["active"][b] = True
            rows = [audio_lanes[sl] for sl in order] + [0] * (Bp - len(order))
            args = [arr[n] for n in ("prefix", "prefix_len", "sot_index", "content_frames",
                                     "last_attend", "is_last", "max_new")]
            tail_args = (je.suppress_mask, te.suppress_mask), (je.align_layers, te.align_layers), \
                (je.align_heads, te.align_heads)
            jargs = [jnp.asarray(a) for a in args] + [t[0] for t in tail_args] + [
                jnp.int32(25), jnp.int32(200), jnp.float32(0.5), jnp.asarray(arr["active"]),
                je.cif_w, je.cif_b]
            targs = [torch.from_numpy(a) for a in args] + [t[1] for t in tail_args] + [
                25, 200, 0.5, torch.from_numpy(arr["active"]), te.cif_w, te.cif_b]
            if tick == 0:
                slots = np.array(order + [G] * (Bp - len(order)), np.int32)  # padded -> G
                lanes = np.array([enc_lanes[sl] for sl in order] + [0, 0], np.int32)
                jo, *jpools = JA.alignatt_tick_anchor_pooled(
                    je.params, jpool[np.asarray(rows)], *sides.jax_pools()[:2],
                    sides.j["enc"], *sides.jax_pools()[3:], jnp.asarray(lanes),
                    jnp.asarray(slots), *jargs, **tick_statics)
                to, *tpools = TA.alignatt_tick_anchor_pooled(
                    te.model, tpool[torch.tensor(rows).long()], *sides.torch_pools(),
                    torch.from_numpy(lanes), torch.from_numpy(slots), *targs, **tick_statics)
            else:
                jo, *jpools = JA.alignatt_tick_anchor_group(
                    je.params, jpool[np.asarray(rows)], *sides.jax_pools(),
                    jnp.asarray(enc_lanes), *jargs, **tick_statics)
                to, *tpools = TA.alignatt_tick_anchor_group(
                    te.model, tpool[torch.tensor(rows).long()], *sides.torch_pools(),
                    torch.from_numpy(enc_lanes), *targs, **tick_statics)
            got_lane = {sl: b for b, sl in enumerate(order)}
        else:
            # the last tick: a full-width plan re-decoding the whole prefix
            full = -(-(max(len(p) for p in prefixes.values()) + 1) // 8) * 8
            R = JA.SKV_REFRESH_ROWS if tick < 4 else max(16, full)
            r_tok = np.full((G, R), tok.eot, np.int32)
            r_pos = np.full((G, R), Wc - 1, np.int32)
            for sl in (0, 2):
                r_tok[sl], r_pos[sl] = _refresh_plan(prefixes[sl], mirror[sl], R, Wc, 0)
            plan = (audio_lanes, enc_lanes, np.where(active, max(0, win - tail), 0).astype(np.int32),
                    content, np.where(active, max(0, synced // 320 - 16), 0).astype(np.int32),
                    r_tok, r_pos,
                    np.array([len(prefixes[0]), 0, len(prefixes[2])], np.int32), content,
                    last_attend, np.zeros(G, bool), np.full(G, 50, np.int32))
            jo, *jpools = JA.alignatt_tick_inc_skv(
                je.params, jpool, *sides.jax_pools(), *(jnp.asarray(x) for x in plan),
                je.suppress_mask, je.align_layers, je.align_heads, jnp.int32(25),
                jnp.int32(200), jnp.float32(0.5), jnp.asarray(active), je.cif_w, je.cif_b,
                **statics, tail_frames=tail)
            to, *tpools = TA.alignatt_tick_inc_skv(
                te.model, tpool, *sides.torch_pools(), *(torch.from_numpy(x) for x in plan),
                te.suppress_mask, te.align_layers, te.align_heads, 25, 200, 0.5,
                torch.from_numpy(active), te.cif_w, te.cif_b, **statics, tail_frames=tail)
            got_lane = {0: 0, 1: 1, 2: 2}
        assert all(t is s for t, s in zip(tpools, sides.torch_pools()))  # in place
        sides.take_jax(jpools)
        _packed_equal(to, jo, what)
        sides.compare(what)
        # slot 1 never ran: every bit of its rows stays, bar the scratch row
        for n in ("k", "v"):
            np.testing.assert_array_equal(_bits(sides.t[n])[:, 1], idle[n], err_msg=f"{what}: {n}")
        for n in ("skv_k", "skv_v"):
            np.testing.assert_array_equal(sides.t[n].numpy()[:, 1, : Wc - 1], idle[n][:, : Wc - 1])
        for n in ("asum", "asq", "alast", "acount", "tok"):
            np.testing.assert_array_equal(sides.t[n].numpy()[1], sides.np[n][1], err_msg=f"{what}: {n}")
        # the session host's bookkeeping: prefixes grow by the kept tokens
        jo = np.asarray(jo)
        for sl in (0, 2):
            b = got_lane[sl]
            kept = [int(x) for x in jo[b, : jo[b, 2 * max_steps]]]
            mirror[sl] = prefixes[sl] + kept[:-1]
            prefixes[sl] = prefixes[sl] + kept
            last_attend[sl] = jo[b, 2 * max_steps + 2]
        synced = have
    assert any(len(p) > len(sot) for p in prefixes.values())  # tokens were committed


def test_anchor_group_with_mel_pallas_matches_jax(engines, monkeypatch):
    """The whole-group anchor with the fused mel (K3) at 128 mels (the
    large-v3 front end) on small dims: on the JAX side the Pallas kernel in
    interpret mode, on the port's its plain version; slot 1 is inactive.
    Packed integers and the token pool exact, ``no_speech_p`` within 1e-5,
    the float pools within 1e-4."""
    import functools
    from dataclasses import replace

    from whisperlivekit_tpu.ops import mel_pallas as JMP

    monkeypatch.setattr(JMP, "log_mel_pallas", functools.partial(JMP.log_mel_pallas, interpret=True))
    _, _, tok = engines
    dims = replace(DIMS, n_mels=128)
    jp = JM.init_params(dims, jax.random.PRNGKey(1), jnp.float32)
    tm = TM.params_from_jax_numpy(jax.tree.map(np.asarray, jp), dims)
    cfg = dict(language="en", max_steps=4, xkv_cache=True, enc_tail_frames=128)
    je = JA.AlignAttEngine(jp, dims, tok, JA.AlignAttConfig(**cfg))
    te = TA.AlignAttEngine(tm, dims, tok, TA.AlignAttConfig(**cfg))
    Wc, p_max = 40, 32
    sides = _Sides(Wc, int(je.align_layers.shape[0]), seed=31)
    audio = np.zeros((G, N), np.int16)
    audio[:, : 4 * 16000] = _speechlike(G, 4.0, 8)
    active = np.array([True, False, True])
    sot = list(tok.sot_sequence_including_notimestamps)
    arr = dict(prefix=np.full((G, p_max), tok.eot, np.int32),
               prefix_len=np.where(active, len(sot), 1).astype(np.int32),
               sot_index=np.zeros(G, np.int32),
               content_frames=np.where(active, 200, 0).astype(np.int32),
               last_attend=np.full(G, -200, np.int32), is_last=np.zeros(G, bool),
               max_new=np.full(G, 50, np.int32), active=active)
    arr["prefix"][:, : len(sot)] = sot
    names = ("prefix", "prefix_len", "sot_index", "content_frames", "last_attend", "is_last", "max_new")
    enc_lanes = np.array([1, 0, 2], np.int32)
    statics = dict(dims=dims, p_max=p_max, max_steps=4, eot=tok.eot, ts_begin=tok.timestamp_begin,
                   no_speech_tok=tok.no_speech, space_tok=tok.encode(" ")[0], mel_pallas=True)
    jo, *jpools = JA.alignatt_tick_anchor_group(
        je.params, jnp.asarray(audio), *sides.jax_pools(), jnp.asarray(enc_lanes),
        *(jnp.asarray(arr[n]) for n in names), je.suppress_mask, je.align_layers,
        je.align_heads, jnp.int32(25), jnp.int32(200), jnp.float32(0.5),
        jnp.asarray(active), je.cif_w, je.cif_b, **statics)
    to, *tpools = TA.alignatt_tick_anchor_group(
        te.model, torch.from_numpy(audio), *sides.torch_pools(), torch.from_numpy(enc_lanes),
        *(torch.from_numpy(arr[n]) for n in names), te.suppress_mask, te.align_layers,
        te.align_heads, 25, 200, 0.5, torch.from_numpy(active), te.cif_w, te.cif_b, **statics)
    assert all(t is s for t, s in zip(tpools, sides.torch_pools()))  # in place
    sides.take_jax(jpools)
    _packed_equal(to, jo, "anchor_group, mel_pallas")
    sides.compare("anchor_group, mel_pallas")
    np.testing.assert_array_equal(sides.t["k"].numpy()[:, 1], sides.np["k"][:, 1])  # inactive slot


def test_refresh_scatter_with_duplicate_rows_is_determined(engines):
    """Padded refresh plans park several rows on the scratch position Wc-1;
    the token-mirror scatter then meets duplicate indices, which all carry
    eot (or, for an inactive lane, the value already there), so the result
    is the same as JAX's and does not depend on the write order."""
    je, te, tok = engines
    Wc, R, K = 40, 8, int(je.align_layers.shape[0])
    rng = np.random.default_rng(3)
    B = 2
    xk = rng.standard_normal((DIMS.n_text_layer, B, DIMS.n_text_head, DIMS.head_dim, Tp)).astype(np.float32)
    xv = rng.standard_normal(xk.shape).astype(np.float32)
    skv = rng.standard_normal((DIMS.n_text_layer, B, Wc, DIMS.n_text_head, DIMS.head_dim)).astype(np.float32)
    stats = rng.random((B, K, DIMS.n_audio_ctx)).astype(np.float32)
    tokp = rng.integers(0, 50000, (B, DIMS.n_text_ctx)).astype(np.int32)
    r_tok = np.full((B, R), tok.eot, np.int32)
    r_pos = np.full((B, R), Wc - 1, np.int32)     # six duplicates of Wc-1 per lane
    r_tok[:, 0], r_pos[:, 0] = tok.sot, 1
    r_tok[:, -1], r_pos[:, -1] = 400, 9
    active = np.array([True, False])
    common = dict(prefix_len=np.array([10, 10], np.int32), content_frames=np.array([300, 300], np.int32),
                  last_attend=np.array([-200, -200], np.int32), is_last=np.zeros(B, bool),
                  max_new=np.full(B, 50, np.int32))
    statics = dict(dims=DIMS, p_max=0, max_steps=4, eot=tok.eot, ts_begin=tok.timestamp_begin,
                   no_speech_tok=tok.no_speech, space_tok=tok.encode(" ")[0])
    jskv = dict(cache=JM.KVCache(k=jnp.asarray(skv), v=jnp.asarray(skv * 0.5)), asum=jnp.asarray(stats),
                asq=jnp.asarray(stats * stats), alast=jnp.asarray(stats), acount=jnp.full((B,), 9.0),
                tok=jnp.asarray(tokp), refresh_tokens=jnp.asarray(r_tok), refresh_pos=jnp.asarray(r_pos))
    tskv = dict(cache=TM.KVCache(k=torch.from_numpy(skv.copy()), v=torch.from_numpy(skv * 0.5)),
                asum=torch.from_numpy(stats.copy()), asq=torch.from_numpy(stats * stats),
                alast=torch.from_numpy(stats.copy()), acount=torch.full((B,), 9.0),
                tok=torch.from_numpy(tokp.copy()), refresh_tokens=torch.from_numpy(r_tok),
                refresh_pos=torch.from_numpy(r_pos))
    jo, (_, _, jtok) = JA._tick_core(
        je.params, None, None, *(jnp.asarray(common[k]) for k in ("prefix_len",)), None,
        *(jnp.asarray(common[k]) for k in ("content_frames", "last_attend", "is_last", "max_new")),
        je.suppress_mask, je.align_layers, je.align_heads, jnp.int32(25), jnp.int32(200),
        jnp.float32(0.5), jnp.asarray(active), je.cif_w, je.cif_b, **statics,
        xkv_pre=JM.CrossKV(k=jnp.asarray(xk), v=jnp.asarray(xv)), xkv_t_valid=DIMS.n_audio_ctx,
        skv=jskv, return_state=True)
    to, (_, _, ttok) = TA._tick_core(
        te.model, None, None, torch.from_numpy(common["prefix_len"]), None,
        *(torch.from_numpy(common[k]) for k in ("content_frames", "last_attend", "is_last", "max_new")),
        te.suppress_mask, te.align_layers, te.align_heads, 25, 200, 0.5,
        torch.from_numpy(active), te.cif_w, te.cif_b, **statics,
        xkv_pre=TM.CrossKV(k=torch.from_numpy(xk), v=torch.from_numpy(xv)),
        xkv_t_valid=DIMS.n_audio_ctx, skv=tskv, return_state=True)
    _packed_equal(to, jo, "duplicate refresh rows")
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert ttok[0, Wc - 1] == tok.eot and ttok[0, 9] == 400
    np.testing.assert_array_equal(ttok[1].numpy(), tokp[1])  # inactive lane: as it was


def test_engine_builds_the_large_form_and_refuses_f8(weights, engines):
    """At d >= 1280 the engine picks the large form (xkv_cache "auto" and
    True): the serving cap and commit budget, the large-v3 tail and top
    prefix bucket. f8 storage is ported now and no longer refused:
    ``xkv_cache_dtype="f8"`` and ``xkv_f8`` build, the allocator then makes
    float8_e4m3fn pools at half the cross-KV bytes per slot, as JAX's
    allocator counts them; language auto-detect and the fused mel (K3)
    build."""
    _, te, tok = engines
    large = MODEL_DIMS["large-v3"]
    for xkv in ("auto", True):
        eng = TA.AlignAttEngine(te.model, large, tok, TA.AlignAttConfig(language="en", xkv_cache=xkv),
                                align_pairs=[(0, 0)])
        assert eng.cfg.xkv_cache is True
        assert (eng.serving_prefix_cap, eng.serving_commit_budget) == (96, 16)
        assert eng.cfg.enc_tail_frames == 160 and eng.prefix_buckets[-1] == 256
    model16 = TM.params_from_jax_numpy(jax.tree.map(np.asarray, weights[0]), DIMS, dtype=torch.bfloat16)
    bf16 = TA.AlignAttEngine(model16, large, tok, TA.AlignAttConfig(language="en"),
                             align_pairs=[(0, 0)])
    f8 = TA.AlignAttEngine(te.model, large, tok, TA.AlignAttConfig(language="en", xkv_cache_dtype="f8"),
                           align_pairs=[(0, 0)])
    assert TA.AlignAttEngine(te.model, large, tok, TA.AlignAttConfig(language="en", xkv_f8=True),
                             align_pairs=[(0, 0)]).cfg.xkv_f8
    assert TP.xkv_pool_dtype(f8) == F8 and TP.xkv_pool_dtype(bf16) == torch.bfloat16
    rows = {}
    for name, eng, jdt in (("bf16", bf16, jnp.bfloat16), ("f8", f8, jnp.float8_e4m3fn)):
        alloc = TP.XKVAllocator.for_engine(eng, 8, skv_dtype=torch.bfloat16)
        assert alloc.dtype == TP.xkv_pool_dtype(eng)
        rows[name] = TP.XKVGroupPool.row_bytes(large, alloc.dtype)
        assert rows[name] == JP.XKVGroupPool.row_bytes(large, jdt)
    assert 2 * rows["f8"] == rows["bf16"]
    eng = TA.AlignAttEngine(te.model, large, tok, TA.AlignAttConfig(language="auto", mel_pallas=True),
                            align_pairs=[(0, 0)])
    assert eng.cfg.xkv_cache is True and eng.cfg.mel_pallas


def test_legacy_tick_xkv_f8_matches_jax(engines_f8):
    """The plan-less full-window program with the legacy ``xkv_f8`` (the
    dense cross-KV rounded from f32 to f8, widened per layer by the decode)
    and the quantized decoder: JAX's packed integers, ``no_speech_p`` within
    1e-5; the dense f8 projection equals JAX's bytes up to one f8 step."""
    je, te, tok = engines_f8
    B, p_max = 2, 32
    audio = np.zeros((B, N), np.int16)
    audio[:, : 3 * 16000] = _speechlike(B, 3.0, 6)
    sot = list(tok.sot_sequence_including_notimestamps)
    arr = dict(prefix=np.full((B, p_max), tok.eot, np.int32), prefix_len=np.full(B, len(sot), np.int32),
               sot_index=np.zeros(B, np.int32), content_frames=np.full(B, 150, np.int32),
               last_attend=np.full(B, -200, np.int32), is_last=np.array([False, True]),
               max_new=np.full(B, 50, np.int32), active=np.array([True, True]))
    arr["prefix"][:, : len(sot)] = sot
    names = ("prefix", "prefix_len", "sot_index", "content_frames", "last_attend", "is_last", "max_new")
    statics = dict(dims=DIMS, p_max=p_max, max_steps=4, eot=tok.eot, ts_begin=tok.timestamp_begin,
                   no_speech_tok=tok.no_speech, space_tok=tok.encode(" ")[0], xkv_f8=True)
    jo = JA.alignatt_tick(
        je.params, jnp.asarray(audio), *(jnp.asarray(arr[n]) for n in names), je.suppress_mask,
        je.align_layers, je.align_heads, jnp.int32(25), jnp.int32(200), jnp.float32(0.5),
        jnp.asarray(arr["active"]), je.cif_w, je.cif_b, **statics)
    to = TA.alignatt_tick(
        te.model, torch.from_numpy(audio), *(torch.from_numpy(arr[n]) for n in names),
        te.suppress_mask, te.align_layers, te.align_heads, 25, 200, 0.5,
        torch.from_numpy(arr["active"]), te.cif_w, te.cif_b, **statics)
    _packed_equal(to, jo, "legacy xkv_f8")
    enc = np.random.default_rng(4).standard_normal((B, 300, DIMS.n_audio_state)).astype(np.float32)
    for transposed in (True, False):
        jx = JM.cross_kv(je.params, jnp.asarray(enc), DIMS, out_dtype=jnp.float8_e4m3fn,
                         transposed=transposed)
        tx = TM.cross_kv(te.model, torch.from_numpy(enc), DIMS, out_dtype=F8, transposed=transposed)
        for g, w in zip(tx, jx):
            assert g.dtype == F8 and tuple(g.shape) == w.shape
            _assert_f8_close(g, w, f"transposed={transposed}")


def test_inc_pooled_matches_jax(engines):
    """The pooled inc tick with a full-prefix prefill (the JAX package's
    reference for the refresh path): the tail re-encode, the splice and the
    decode off the pool, from the same random pools; slot 1 is idle."""
    je, te, tok = engines
    max_steps, tail, p_max = 4, 128, 32
    K = int(je.align_layers.shape[0])
    sides = _Sides(8, K, seed=21)
    pcm = _speechlike(3, 6.0, 5)
    rows = np.pad(pcm, ((0, 0), (0, N - pcm.shape[1])))
    jpool, tpool = jnp.asarray(rows), torch.from_numpy(rows)
    win = pcm.shape[1] // 320
    active = np.array([True, False, True])
    sot = list(tok.sot_sequence_including_notimestamps)
    arr = dict(prefix=np.full((G, p_max), tok.eot, np.int32),
               prefix_len=np.where(active, len(sot), 1).astype(np.int32),
               sot_index=np.zeros(G, np.int32), content_frames=np.where(active, win, 0).astype(np.int32),
               last_attend=np.full(G, -200, np.int32), is_last=np.zeros(G, bool),
               max_new=np.full(G, 50, np.int32), active=active)
    arr["prefix"][:, : len(sot)] = sot
    names = ("prefix", "prefix_len", "sot_index", "content_frames", "last_attend", "is_last", "max_new")
    plan = (np.array([0, 1, 2], np.int32), np.array([1, 0, 2], np.int32),
            np.where(active, win - tail, 0).astype(np.int32), arr["content_frames"],
            np.where(active, win - 40, 0).astype(np.int32))
    statics = dict(dims=DIMS, p_max=p_max, max_steps=max_steps, eot=tok.eot,
                   ts_begin=tok.timestamp_begin, no_speech_tok=tok.no_speech,
                   space_tok=tok.encode(" ")[0], tail_frames=tail)
    jo, jk, jv, jenc = JA.alignatt_tick_inc_pooled(
        je.params, jpool, sides.j["k"], sides.j["v"], sides.j["enc"],
        *(jnp.asarray(x) for x in plan), *(jnp.asarray(arr[n]) for n in names),
        je.suppress_mask, je.align_layers, je.align_heads, jnp.int32(25), jnp.int32(200),
        jnp.float32(0.5), jnp.asarray(active), je.cif_w, je.cif_b, **statics)
    to, tk, tv, tenc = TA.alignatt_tick_inc_pooled(
        te.model, tpool, sides.t["k"], sides.t["v"], sides.t["enc"],
        *(torch.from_numpy(x) for x in plan), *(torch.from_numpy(arr[n]) for n in names),
        te.suppress_mask, te.align_layers, te.align_heads, 25, 200, 0.5,
        torch.from_numpy(active), te.cif_w, te.cif_b, **statics)
    assert tk is sides.t["k"] and tenc is sides.t["enc"]
    _packed_equal(to, jo, "inc_pooled")
    for got, want in ((tk, jk), (tv, jv), (tenc, jenc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tk.numpy()[:, 1], sides.np["k"][:, 1])  # idle slot
