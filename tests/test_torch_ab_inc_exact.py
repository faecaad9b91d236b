"""The inc-vs-exact A/B's twin (whisperlivekit_tpu_torch/harness/ab_inc_exact.py)
against scripts/ab_inc_exact.py on the CPU, at dev-tiny size with the
stand-in vocabulary and JAX's f32 weights bridged through numpy (both
scripts' ``build_engine`` swapped for makers of those engines):

- ``enc_err_fn`` and ``_tok_agreement`` equal the script's on seeded
  inputs, windows at both edges included;
- ``run_model`` over 12 ticks with the encoder-row cache: every integer
  field (tick mix, gate frames, committed tokens) equals the script's,
  every float within 2e-5 relative to ``exact_frame_rms`` (the cross-KV
  pools forced on, and ``run_decoder_ab``, are in
  tests/test_torch_ab_inc_exact_pooled.py: each JAX run compiles its own
  programs, ~40 s);
- the argparse surface equals the script's; the twin runs without jax and
  the JAX package.

``run_decoder_ab``, the events route and ``main`` are in
tests/test_torch_ab_inc_exact_decoder.py.
"""

import argparse
import importlib.util
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperlivekit_tpu.models.whisper import model as JM
from whisperlivekit_tpu.models.whisper.dims import MODEL_DIMS
from whisperlivekit_tpu.models.whisper.tokenizer import get_tokenizer
from whisperlivekit_tpu.streaming import alignatt as JA
from whisperlivekit_tpu_torch.harness import ab_inc_exact as AB
from whisperlivekit_tpu_torch.harness.vocab import write_standin_vocab
from whisperlivekit_tpu_torch.models.whisper import model as TM
from whisperlivekit_tpu_torch.streaming import alignatt as TA

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

REPO = Path(__file__).resolve().parent.parent
DIMS = MODEL_DIMS["dev-tiny"]
TICKS = 12
TOL = 2e-5
# (field group, key) of run_model's float readings
FLOATS = ("max_abs_err", "p50_max_abs_err", "mean_abs_err", "exact_frame_rms", "mean_rel_err")


def _script():
    spec = importlib.util.spec_from_file_location("ab_inc_exact_script", REPO / "scripts" / "ab_inc_exact.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J = _script()


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    path = write_standin_vocab(tmp_path_factory.mktemp("vocab"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WLK_TPU_ASSET_DIR", str(path.parent))
        yield get_tokenizer(True, language="en", task="transcribe")


@pytest.fixture(scope="module")
def weights():
    return JM.init_params(DIMS, jax.random.PRNGKey(0), jnp.float32)


def _engine_makers(params, tok, xkv_cache):
    """(JAX maker, port maker) with build_engine's signature: dev-tiny
    engines on the same f32 weights ``params``, the decoder quantized under
    f8 (each package's own quantize_decoder_f8, whose bytes agree)."""
    def cfg(mod, ft, xkv_dtype, enc_tail_frames):
        return mod.AlignAttConfig(language="en", frame_threshold=ft, xkv_cache_dtype=xkv_dtype,
                                  enc_tail_frames=enc_tail_frames, xkv_cache=xkv_cache)

    def jbuild(model, ft, xkv_dtype, decoder_dtype="bf16", weights=None, enc_tail_frames=0):
        p = JM.quantize_decoder_f8(params) if decoder_dtype == "f8" else params
        return JA.AlignAttEngine(p, DIMS, tok, cfg(JA, ft, xkv_dtype, enc_tail_frames), model_name=model)

    def tbuild(model, ft, xkv_dtype, decoder_dtype="bf16", weights=None, enc_tail_frames=0, device=None):
        m = TM.params_from_jax_numpy(jax.tree.map(np.asarray, params), DIMS, device=device)
        if decoder_dtype == "f8":
            m = TM.quantize_decoder_f8(m)
        return TA.AlignAttEngine(m, DIMS, tok, cfg(TA, ft, xkv_dtype, enc_tail_frames), model_name=model)
    return jbuild, tbuild


@pytest.mark.parametrize("win", [0, 1, 7, 750, 1499, 1500])
def test_enc_err_fn_equals_the_script(win):
    rng = np.random.default_rng(win)
    a = rng.standard_normal((3, 1500, 64)).astype(np.float32)
    c = (a + 0.01 * rng.standard_normal(a.shape)).astype(np.float32)
    want = np.asarray(J.enc_err_fn()(jnp.asarray(a), 2, jnp.asarray(c), 1, jnp.int32(win)))
    got = AB.enc_err_fn()(torch.from_numpy(a), 2, torch.from_numpy(c), 1, win).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-7)


@pytest.mark.parametrize("a,b", [([], []), ([1, 2, 3], [1, 2, 3]), ([1, 2, 3, 4], [2, 3, 9]),
                                 ([5] * 7, [5, 6] * 3), ([1, 2], [])])
def test_tok_agreement_equals_the_script(a, b):
    assert AB._tok_agreement(a, b) == J._tok_agreement(a, b)


def _assert_run_equal(got, want):
    got, want = dict(got), dict(want)
    assert got.pop("wall_s") >= 0 and want.pop("wall_s") >= 0
    gdiv, wdiv = got.pop("encoder_divergence"), want.pop("encoder_divergence")
    assert got == want
    assert gdiv["n_samples"] == wdiv["n_samples"] > 0
    rms = wdiv["exact_frame_rms"]
    for key in FLOATS:
        bar = TOL if key == "mean_rel_err" else TOL * rms
        assert abs(gdiv[key] - wdiv[key]) <= bar, (key, gdiv[key], wdiv[key])


def check_run_model(tok, params, monkeypatch, xkv_cache):
    """TICKS ticks of speech-like audio, permissive gate: the tick mix, the
    gate frames and the committed tokens exactly, the encoder divergence
    within the bar; with the pools forced on the inc session serves from a
    cross-KV group (``xkv_dtype`` reported)."""
    jbuild, tbuild = _engine_makers(params, tok, xkv_cache)
    monkeypatch.setattr(J, "build_engine", jbuild)
    monkeypatch.setattr(AB, "build_engine", tbuild)
    want = J.run_model("dev-tiny", TICKS / 60, 1, "bf16", 5)
    got = AB.run_model("dev-tiny", TICKS / 60, 1, "bf16", 5, device="cpu")
    _assert_run_equal(got, want)
    assert got["n_ticks_compared"] == TICKS
    assert got["inc_tick_mix"]["inc"] > 0 and got["inc_tick_mix"]["anchor"] > 0
    assert got["committed_tokens"]["n_inc"] > 0 and got["committed_tokens"]["n_exact"] > 0
    assert got["xkv_dtype"] == ("bf16" if xkv_cache else None)


def test_run_model_equals_the_script(vocab, weights, monkeypatch):
    """The base form's encoder-row cache (dev-tiny: the pools off); the
    pooled form is tests/test_torch_ab_inc_exact_pooled.py's."""
    check_run_model(vocab, weights, monkeypatch, False)


def _surface(parser) -> list:
    return sorted(
        (tuple(a.option_strings), a.dest, a.default, getattr(a.type, "__name__", a.type), a.nargs,
         tuple(a.choices or ()), type(a).__name__)
        for a in parser._actions if a.dest != "help"
    )


def test_argparse_surface_equals_the_script(monkeypatch):
    """Every flag, default, type, nargs and choice of the script's parser."""
    class Captured(Exception):
        pass

    seen = []

    def capture(self, args=None, namespace=None):
        seen.append(self)
        raise Captured

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Captured):
        J.main()
    monkeypatch.undo()
    assert _surface(AB.build_parser()) == _surface(seen[0])


def test_twin_runs_without_jax(tmp_path):
    code = textwrap.dedent(
        f"""
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
        from whisperlivekit_tpu_torch.harness.vocab import install_standin_vocab
        install_standin_vocab({str(tmp_path)!r})
        from whisperlivekit_tpu_torch.harness import ab_inc_exact as AB
        r = AB.run_model("dev-tiny", 2 / 60, 1, "bf16", 1, device="cpu")
        assert r["n_ticks_compared"] == 2
        assert not any(m.split(".")[0] in REFUSED for m in sys.modules)
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
