"""The Qwen3 capacity bench's twin (whisperlivekit_tpu_torch/harness/capacity_qwen3.py)
against scripts/bench_qwen3_tpu.py on the CPU, at reduced Qwen3 dims (the
JAX package's dev-tiny tower and a 24-token text vocabulary, so lanes end
at different steps):

- one tick (a block appended, a hypothesis decoded) on JAX's f32 weights
  bridged through ``qwen3_params_from_jax``, inputs drawn as the script
  draws them: ``n.sum()`` and the decode steps (the JAX loop's iterations)
  equal JAX's, tick after tick, at several lane counts;
- the constants equal the script's;
- with the tick time scripted, the results equal the script's key for
  key (the port adds ``decode_steps``; ``device`` names the device);
- an out-of-memory B is recorded as FAILED and stops the sweep, any other
  exception propagates;
- the twin runs without jax and the JAX package.
"""

import importlib.util
import json
import subprocess
import sys
import textwrap
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperlivekit_tpu.models import llama as JL
from whisperlivekit_tpu.models import qwen3_asr as JQ
from whisperlivekit_tpu_torch.harness import capacity_qwen3 as Q
from whisperlivekit_tpu_torch.models import qwen3_asr as TQ

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

REPO = Path(__file__).resolve().parent.parent
JDIMS = replace(JQ.DEV_TINY, text=replace(JQ.DEV_TINY_TEXT, vocab_size=24))
TDIMS = replace(TQ.DEV_TINY, text=replace(TQ.DEV_TINY_TEXT, vocab_size=24))


def _script():
    spec = importlib.util.spec_from_file_location("bench_qwen3_tpu", REPO / "scripts" / "bench_qwen3_tpu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J = _script()


def _jax_tick(params, dims, B, rng):
    """The script's tick (its ``main`` body) in f32, returning n per lane."""
    window_tokens = dims.max_frames // dims.downsample
    cache_len = 8 + window_tokens + J.HYP_TOKENS + 8
    mel = jnp.asarray(rng.standard_normal((B, dims.n_mels, 2 * dims.block_frames)).astype(np.float32))
    state = {"tower": JQ.init_tower_cache(dims, B), "text": JL.init_cache(dims.text, B, cache_len)}
    start = jnp.full((B,), dims.block_frames, jnp.int32)
    tpos = jnp.full((B,), 8 + dims.block_tokens, jnp.int32)
    hyp = jnp.full((B, 1), 4, jnp.int32)

    def tick():
        tw, tx, _ = JQ.append_audio_block(params, mel, state["tower"], state["text"], start, tpos, dims)
        _, n, tx = JQ.decode_hypothesis(params, tx, hyp, tpos + dims.block_tokens, 0, dims,
                                        max_new=J.HYP_TOKENS)
        state["tower"], state["text"] = tw, tx
        return np.asarray(n)
    return tick


def test_constants_equal_the_script():
    assert vars(Q.TEXT) == vars(J.TEXT)
    assert {k: v for k, v in vars(Q.DIMS).items() if k != "text"} == \
        {k: v for k, v in vars(J.DIMS).items() if k != "text"}
    assert Q.HYP_TOKENS == J.HYP_TOKENS and Q.EOS == 0


def test_tick_steps_and_n_equal_jax():
    """Three ticks a lane count, both packages drawing from their own
    default_rng(0) in the script's order across the counts."""
    jp = JQ.init_params(JDIMS, jax.random.PRNGKey(0), jnp.float32)
    model = TQ.qwen3_params_from_jax(jax.tree.map(np.asarray, jp), TDIMS)
    jrng, trng = np.random.default_rng(0), np.random.default_rng(0)
    steps_seen = set()
    for B in (2, 4, 8):
        jtick = _jax_tick(jp, JDIMS, B, jrng)
        ttick = Q.make_tick(model, TDIMS, B, trng, dtype=torch.float32, device="cpu")
        for _ in range(3):
            n = jtick()
            got = ttick().tolist()
            want = [int(n.sum()), min(J.HYP_TOKENS, int(n.max()) + 1)]
            assert got == want, (B, got, want)
            steps_seen.add(want[1])
    assert min(steps_seen) < J.HYP_TOKENS  # some ticks stopped early


# scripted seconds per B (8, 16, 32, 64): the peak at B32
TIMES = [0.05, 0.06, 0.07, 0.2]


def _scripted_jax(monkeypatch, tmp_path):
    it = iter(TIMES)

    def timeit(fn, iters=3):
        float(np.asarray(fn()))
        return next(it)
    monkeypatch.setattr(J, "timeit", timeit)
    monkeypatch.setattr(J, "DIMS", JDIMS)
    monkeypatch.setattr(J, "RESULTS", {"device": "cpu"})
    monkeypatch.setattr(J, "open", lambda path, mode="r": open(tmp_path / "jax.json", mode), raising=False)


def _scripted_torch(monkeypatch):
    it = iter(TIMES)

    def timeit(fn, iters=3):
        out = fn().cpu()
        return next(it), [out] * iters
    monkeypatch.setattr(Q, "timeit", timeit)
    monkeypatch.setattr(Q, "DIMS", TDIMS)


def test_results_equal_the_script_with_scripted_times(monkeypatch, tmp_path, capsys):
    _scripted_jax(monkeypatch, tmp_path)
    J.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert json.loads((tmp_path / "jax.json").read_text()) == want
    _scripted_torch(monkeypatch)
    out = tmp_path / "torch.json"
    assert Q.main(["--out", str(out)], device="cpu") == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert json.loads(out.read_text()) == got
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, dict):
            assert set(g) - set(w) == {"decode_steps"}
            assert len(g["decode_steps"]) == 3 and all(1 <= s <= Q.HYP_TOKENS for s in g["decode_steps"])
            g = {k: v for k, v in g.items() if k != "decode_steps"}
        assert g == w, key
    assert got["peak_streams"] == pytest.approx(32 * (TDIMS.block_samples / 16000) / 0.07)


def test_out_of_memory_stops_the_sweep_and_other_errors_propagate(monkeypatch):
    real = Q.make_tick

    def oom_at_16(model, dims, B, rng, dtype=torch.bfloat16, device="cpu"):
        if B == 16:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (scripted)")
        return real(model, dims, B, rng, dtype, device)

    monkeypatch.setattr(Q, "make_tick", oom_at_16)
    model = TQ.init_params(TDIMS, torch.Generator().manual_seed(0))
    res = {}
    peak = Q.sweep(model, TDIMS, res, "cpu", dtype=torch.float32)
    assert list(res) == ["B8", "B16"] and res["B16"] == "FAILED OutOfMemoryError"
    assert peak == pytest.approx(8 * 0.4 / (res["B8"]["tick_ms"] / 1e3), rel=1e-2)

    def value_error(*a, **k):
        raise ValueError("not an out-of-memory error")

    monkeypatch.setattr(Q, "make_tick", value_error)
    with pytest.raises(ValueError):
        Q.sweep(model, TDIMS, {}, "cpu", dtype=torch.float32)


def test_twin_runs_without_jax():
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
        from whisperlivekit_tpu_torch.harness import capacity_qwen3 as Q
        from whisperlivekit_tpu_torch.models import qwen3_asr as TQ
        Q.DIMS = TQ.DEV_TINY
        Q.B_SWEEP = (1, 2)
        Q.main([], device="cpu")
        assert not any(m.split(".")[0] in REFUSED for m in sys.modules)
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(out) == {"device", "B1", "B2", "peak_streams"} and out["device"] == "cpu"
