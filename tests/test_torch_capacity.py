"""The capacity sweep's twin (whisperlivekit_tpu_torch/harness/capacity.py)
against the repository's root bench.py on the CPU, at dev-tiny size.

Both sweeps run with their four tick programs replaced by recorders (and
bench.py's AOT temp probe and HBM limit by constants), so every argument
an arm hands its programs is captured:

- (a) the twin's arm inputs equal bench.py's exactly, for the base form's
  encoder-row arm and for the pooled arms (bf16 and f8 pools);
- (b) one anchor tick and one inc tick on those captured inputs, in f32
  with the JAX weights bridged through numpy: packed integer outputs equal,
  no_speech_p and every pool within 2e-5;
- (c) ``_arm_resident_bytes`` equal for every SWEEP model, width and dtype;
- (d) with scripted tick times, the results (both peaks, the latency
  clause, f8d kept out of the peaks) equal key for key, the twin's own
  keys apart;
- (e) an out-of-memory arm is recorded as FAILED and the sweep goes on,
  while any other exception propagates; the memory precheck counts the
  arm's own weights and none of another model's;
- (f) ``main(device="cpu")`` prints one JSON line with the headline's keys;
- (g) the twin runs in a process where jax and the JAX package cannot be
  imported.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench
from whisperlivekit_tpu.models.whisper import model as JM
from whisperlivekit_tpu.models.whisper.dims import MODEL_DIMS as JDIMS
from whisperlivekit_tpu.models.whisper.dims import default_alignment_heads
from whisperlivekit_tpu.streaming import alignatt as JA
from whisperlivekit_tpu_torch.harness import capacity as C
from whisperlivekit_tpu_torch.models.whisper import model as TM
from whisperlivekit_tpu_torch.models.whisper.dims import MODEL_DIMS as TDIMS
from whisperlivekit_tpu_torch.streaming import alignatt as TA

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

REPO = Path(__file__).resolve().parent.parent
PROGRAMS = ("alignatt_tick_inc", "alignatt_tick_anchor", "alignatt_tick_inc_skv", "alignatt_tick_anchor_group")
TOL = 2e-5
# (tail frames, dtypes) of the captured sweeps: the base form's arm, then
# the pooled arms in bench.py's order
CAPTURED = ((384, ("enc",)), (160, ("bf16", "f8")))


def _np(x) -> np.ndarray:
    """A torch tensor, JAX array or Python number as numpy, bf16 and f8 as
    their raw bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        view = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8}.get(x.dtype)
        return (x.view(view) if view else x).numpy()
    a = np.asarray(x)
    view = {"bfloat16": np.int16, "float8_e4m3fn": np.uint8}.get(str(a.dtype))
    return a.view(view) if view else a


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


class _Recorder:
    """Stands in for the four programs on one package's alignatt module:
    records (program, args, kwargs) and returns the pools it was given, as
    the in-place programs do."""

    def __init__(self, jax_side: bool):
        self.calls, self.jax_side = [], jax_side

    def program(self, name):
        def run(*args, **kwargs):
            self.calls.append((name, args, kwargs))
            packed = np.zeros((1, 1), np.int32) if self.jax_side else torch.zeros((1, 1), dtype=torch.int32)
            if name in ("alignatt_tick_inc", "alignatt_tick_anchor"):
                return (packed, args[2])
            return (packed, *args[2:12])
        return run


def _patch_jax(monkeypatch, times=None):
    rec = _Recorder(jax_side=True)
    for name in PROGRAMS:
        monkeypatch.setattr(JA, name, rec.program(name))
    monkeypatch.setattr(bench, "_arm_temp_bytes", lambda *a, **k: 0)
    monkeypatch.setattr(bench, "_hbm_limit", lambda: 1 << 50)
    it = iter(times) if times is not None else None

    def time_call(fn, iters=4):
        np.asarray(fn()[0])
        return next(it) if it is not None else 0.1
    monkeypatch.setattr(bench, "time_call", time_call)
    return rec


def _patch_torch(monkeypatch, times=None):
    rec = _Recorder(jax_side=False)
    for name in PROGRAMS:
        monkeypatch.setattr(TA, name, rec.program(name))
    it = iter(times) if times is not None else None

    def time_call(fn, iters=4):
        fn()[0].cpu()
        return next(it) if it is not None else 0.1
    monkeypatch.setattr(C, "time_call", time_call)
    return rec


@pytest.fixture(scope="module")
def captured():
    """Both sweeps at dev-tiny, 2 lanes, with recorders for programs."""
    mp = pytest.MonkeyPatch()
    try:
        jrec, trec = _patch_jax(mp), _patch_torch(mp)
        for tail, dtypes in CAPTURED:
            bench.bench_model("dev-tiny", (2,), {}, tail_frames=tail, dtypes=dtypes)
            C.bench_model("dev-tiny", (2,), {}, tail_frames=tail, dtypes=dtypes, device="cpu")
    finally:
        mp.undo()
    return jrec.calls, trec.calls


def test_arm_inputs_equal_bench_exactly(captured):
    """(a) Every argument past the weights, positional and static, equals
    bench.py's: values bit for bit (bf16 and f8 pools as raw bits), dtypes
    by name; the dims as fields."""
    jcalls, tcalls = captured
    assert [c[0] for c in tcalls] == [c[0] for c in jcalls] == [
        "alignatt_tick_inc", "alignatt_tick_anchor",
        "alignatt_tick_inc_skv", "alignatt_tick_anchor_group",
        "alignatt_tick_inc_skv", "alignatt_tick_anchor_group",
    ]
    for (name, jargs, jkw), (_, targs, tkw) in zip(jcalls, tcalls):
        assert len(jargs) == len(targs), name
        for i, (j, t) in enumerate(zip(jargs[1:], targs[1:]), start=1):
            jn, tn = _np(j), _np(t)
            assert jn.shape == tn.shape, (name, i)
            np.testing.assert_array_equal(tn, jn, err_msg=f"{name} argument {i}")
            if isinstance(t, torch.Tensor):
                assert _dtype_name(t) == _dtype_name(j), (name, i)
        assert set(jkw) == set(tkw), name
        for key in jkw:
            if key == "dims":
                assert vars(tkw[key]) == vars(jkw[key]), name
            else:
                assert tkw[key] == jkw[key], (name, key)
    # the pooled arms' cross-KV pools: bf16, then float8_e4m3fn
    assert [_dtype_name(c[1][2]) for c in tcalls[2:]] == ["bfloat16"] * 2 + ["float8_e4m3fn"] * 2


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float() if x.is_floating_point() else x.clone()
    return x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x


@pytest.mark.parametrize("arm", ["enc", "pooled"])
def test_one_anchor_and_one_inc_tick_match_jax_in_f32(captured, arm):
    """(b) The captured arm (the base form's, or the first pooled one) in
    f32: one anchor tick, then one inc tick on the pools it left, each
    program of both packages on the same inputs and weights."""
    jcalls, tcalls = captured
    first = 0 if arm == "enc" else 2
    (inc_name, jinc, jinc_kw), (_, tinc, tinc_kw) = jcalls[first], tcalls[first]
    (anc_name, janc, janc_kw), (_, tanc, tanc_kw) = jcalls[first + 1], tcalls[first + 1]
    dims = JDIMS["dev-tiny"]
    jp = JM.init_params(dims, jax.random.PRNGKey(0), dtype=jnp.float32)
    tm = TM.params_from_jax_numpy(jax.tree.map(np.asarray, jp), TDIMS["dev-tiny"])
    n_pools = 1 if arm == "enc" else 10
    jpools = [_f32(a) for a in janc[2:2 + n_pools]]
    tpools = [_f32(a) for a in tanc[2:2 + n_pools]]

    def check(jo, to, what):
        jo, to = np.asarray(jo), to.numpy()
        np.testing.assert_array_equal(to[:, :-1], jo[:, :-1], err_msg=what)
        np.testing.assert_allclose(to[:, -1].view(np.float32), jo[:, -1].view(np.float32),
                                   rtol=0, atol=TOL, err_msg=what)
        for i, (j, t) in enumerate(zip(jpools, tpools)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=TOL, err_msg=f"{what}: pool {i}")

    jo, *jpools = getattr(JA, anc_name)(jp, janc[1], *jpools, *janc[2 + n_pools:], **janc_kw)
    to, *tp = getattr(TA, anc_name)(tm, tanc[1], *tpools, *tanc[2 + n_pools:], **tanc_kw)
    assert all(a is b for a, b in zip(tp, tpools))  # in place
    check(jo, to, anc_name)
    jo, *jpools = getattr(JA, inc_name)(jp, jinc[1], *jpools, *jinc[2 + n_pools:], **jinc_kw)
    to, *tp = getattr(TA, inc_name)(tm, tinc[1], *tpools, *tinc[2 + n_pools:], **tinc_kw)
    check(jo, to, inc_name)
    steps = C.DECODE_STEPS
    assert (np.asarray(jo)[:, 2 * steps] > 0).all()  # the pinned steps kept tokens


@pytest.mark.parametrize("name,widths,tail,dtypes", [s[:4] for s in bench.SWEEP])
def test_arm_resident_bytes_equal_bench(name, widths, tail, dtypes):
    """(c) The precheck's resident count, every width and dtype of SWEEP
    (the base form's arm at its bf16 encoder pool)."""
    assert [s[:4] for s in C.SWEEP] == [s[:4] for s in bench.SWEEP]
    jd, td = JDIMS[name], TDIMS[name]
    K = len(default_alignment_heads(jd, name))
    for B in widths:
        for dt in dtypes:
            jdt = jnp.float8_e4m3fn if dt in ("f8", "f8d") else jnp.bfloat16
            want = bench._arm_resident_bytes(jd, B, jdt, C.SERVING_WC, K)
            assert C._arm_resident_bytes(td, B, C.pool_dtype(dt), C.SERVING_WC, K) == want, (name, B, dt)


def test_constants_equal_bench():
    for key in ("TICK_SECONDS", "DECODE_STEPS", "PREFIX_BUCKET", "SERVING_PREFIX_CAP",
                "SERVING_COMMIT_BUDGET", "SERVING_PLEN", "ANCHOR_EVERY", "LATENCY_P50_BUDGET_S",
                "EOT", "TS_BEGIN", "NO_SPEECH", "SPACE", "_TEMP_SAFETY"):
        assert getattr(C, key) == getattr(bench, key), key
    assert C.SWEEP == bench.SWEEP
    assert C.SERVING_WC == bench.SERVING_PREFIX_CAP + bench.SERVING_COMMIT_BUDGET + bench.DECODE_STEPS + 2


# (inc, anchor) seconds per arm, in sweep order (B 2 then 16; bf16, f8,
# f8d): at 16 lanes bf16 has the most streams but misses the latency
# clause, so the headline peak is f8 at 2 lanes; f8d is the fastest of all
# but stays out of both peaks
SCRIPT = [0.10, 0.50, 0.09, 0.40, 0.01, 0.02,
          0.60, 0.70, 0.70, 0.80, 0.001, 0.002]


def test_results_equal_bench_with_scripted_times(monkeypatch):
    """(d) The peaks, the latency clause and the f8d exclusion."""
    _patch_jax(monkeypatch, SCRIPT)
    _patch_torch(monkeypatch, SCRIPT)
    jres, tres = {}, {}
    jbest = bench.bench_model("dev-tiny", (2, 16), jres, tail_frames=160, dtypes=("bf16", "f8", "f8d"))
    tbest = C.bench_model("dev-tiny", (2, 16), tres, tail_frames=160, dtypes=("bf16", "f8", "f8d"),
                          device="cpu")
    assert tbest == jbest
    extra = {"peak_alloc_gib"}
    assert list(tres) == list(jres)
    for key, want in jres.items():
        got = tres[key]
        if isinstance(want, dict):
            assert set(got) - set(want) == extra, key
            got = {k: v for k, v in got.items() if k not in extra}
        assert got == want, key
    assert tres["dev-tiny_peak_tick_ms"] == tres["dev-tiny_B2_f8"]["amortized_ms"]
    assert tres["dev-tiny_peak_streams"] == tres["dev-tiny_B2_f8"]["streams"]
    assert tres["dev-tiny_peak_streams_unconstrained"] == tres["dev-tiny_B16_bf16"]["streams"]
    assert tres["dev-tiny_B16_f8d"]["streams"] > tres["dev-tiny_peak_streams_unconstrained"]


def test_out_of_memory_arm_fails_and_the_sweep_goes_on(monkeypatch):
    """(e) A scripted torch.cuda.OutOfMemoryError fails its arm only; a
    ValueError is not caught (bench.py catches every exception)."""
    rec = _patch_torch(monkeypatch)
    record = rec.program("alignatt_tick_inc_skv")
    raised = []

    def oom_once(*args, **kwargs):
        if not raised:
            raised.append(1)
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (scripted)")
        return record(*args, **kwargs)

    monkeypatch.setattr(TA, "alignatt_tick_inc_skv", oom_once)
    res = {}
    C.bench_model("dev-tiny", (2,), res, tail_frames=160, dtypes=("bf16", "f8"), device="cpu")
    assert res["dev-tiny_B2_bf16"] == "FAILED OutOfMemoryError"
    assert res["dev-tiny_B2_f8"]["streams"] > 0
    assert res["dev-tiny_peak_streams"] == res["dev-tiny_B2_f8"]["streams"]

    def value_error(*args, **kwargs):
        raise ValueError("not an out-of-memory error")

    monkeypatch.setattr(TA, "alignatt_tick_inc_skv", value_error)
    with pytest.raises(ValueError):
        C.bench_model("dev-tiny", (2,), {}, tail_frames=160, dtypes=("bf16",), device="cpu")


def test_memory_budget_counts_the_arms_own_weights(monkeypatch):
    """(e) The precheck's budget: the card's free bytes, the allocator's
    unused bytes and the running model's weights, whatever else is
    allocated (the f8d copy of the weights counts only in its own arms)."""
    dims = TDIMS["dev-tiny"]
    base = TM.init_params(dims, torch.Generator().manual_seed(0), torch.bfloat16)
    f8 = sum(mod.weight.numel() for mod in TM._f8_linears(base))
    scales = sum(mod.weight.shape[0] * 4 for mod in TM._f8_linears(base))
    bf16 = sum(t.numel() * 2 for t in base.state_dict().values())
    assert C._model_bytes(base) == bf16
    q = TM.quantize_decoder_f8(TM.init_params(dims, torch.Generator().manual_seed(0), torch.bfloat16))
    assert C._model_bytes(q) == bf16 - f8 + scales
    assert C._device_budget(torch.device("cpu"), base) is None
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (5 << 30, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 9 << 30)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 7 << 30)
    cuda = torch.device("cuda", 0)
    assert C._device_budget(cuda, base) == (5 << 30) + (2 << 30) + bf16
    assert C._device_budget(cuda, q) == (5 << 30) + (2 << 30) + bf16 - f8 + scales


def test_main_prints_the_headline_line(monkeypatch, capsys, tmp_path):
    """(f) One arm of the real programs at dev-tiny on the CPU: one stdout
    line with bench.py's keys; the sweep and sub_metrics on stderr; --out
    writes the artifact with the device."""
    monkeypatch.setattr(C, "SWEEP", [("dev-tiny", (2,), 160, ("bf16",), True)])
    out = tmp_path / "sweep.json"
    assert C.main(["--out", str(out), "--round", "t"], device="cpu") == 0
    cap = capsys.readouterr()
    lines = cap.out.strip().splitlines()
    assert len(lines) == 1
    head = json.loads(lines[0])
    assert set(head) == {"metric", "value", "unit", "vs_baseline"}
    assert head["metric"] == "concurrent_realtime_streams_per_chip_whisper_large_v3"
    assert head["value"] > 0 and abs(head["vs_baseline"] - head["value"] * 0.144) <= 0.01
    assert "sub_metrics" in cap.err and "dev-tiny B=2 bf16" in cap.err
    art = json.loads(out.read_text())
    assert art["device"] == "cpu" and art["round"] == "t" and art["headline"] == head
    arm = art["sub_metrics"]["dev-tiny_B2_bf16"]
    assert arm["peak_alloc_gib"] is None  # CPU: no allocator statistics


def test_twin_runs_without_jax():
    """(g) The twin's main in a process that refuses jax, jaxlib and the JAX
    package."""
    code = textwrap.dedent(
        """
        import sys
        REFUSED = ("jax", "jaxlib", "whisperlivekit_tpu")
        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in REFUSED:
                    raise ImportError("refused in this process: " + name)
                return None
        sys.meta_path.insert(0, Refuse())
        import torch
        torch.set_num_threads(1)
        from whisperlivekit_tpu_torch.harness import capacity as C
        C.SWEEP = [("dev-tiny", (1,), 384, ("enc",), False), ("dev-tiny", (1,), 160, ("f8",), True)]
        C.main([], device="cpu")
        assert not any(m.split(".")[0] in REFUSED for m in sys.modules)
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["value"] > 0
