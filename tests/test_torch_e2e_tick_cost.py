"""The serving-tick cost probe's twin (whisperlivekit_tpu_torch/harness/e2e_tick_cost.py)
against scripts/probe_e2e_tick_cost.py on the CPU: 3 sessions, 8 ticks, at
dev-tiny with JAX's f32 weights bridged through numpy (both sides'
``build_engine`` swapped for makers of those engines, the stand-in
vocabulary):

- every row's lane count and tick mix (``modes``) equal the script's, row
  for row;
- the summary has the script's keys plus ``device``, and the dispatch's
  ``phases`` the same programs with the same call counts;
- the warm pass's line comes first (no warm pass off CUDA);
- the twin runs without jax and the JAX package.
"""

import importlib
import importlib.util
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

from whisperlivekit_tpu.models.whisper import model as JM
from whisperlivekit_tpu.models.whisper.dims import MODEL_DIMS
from whisperlivekit_tpu.models.whisper.tokenizer import get_tokenizer
from whisperlivekit_tpu.streaming import alignatt as JA
from whisperlivekit_tpu_torch.harness import ab_inc_exact as AB
from whisperlivekit_tpu_torch.harness import e2e_tick_cost as TC
from whisperlivekit_tpu_torch.harness.vocab import write_standin_vocab
from whisperlivekit_tpu_torch.models.whisper import model as TM
from whisperlivekit_tpu_torch.streaming import alignatt as TA

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

REPO = Path(__file__).resolve().parent.parent
DIMS = MODEL_DIMS["dev-tiny"]
ARGV = ["--n", "3", "--ticks", "8", "--model", "dev-tiny", "--xkv-dtype", "bf16"]


def _probe():
    spec = importlib.util.spec_from_file_location("probe_e2e_tick_cost",
                                                  REPO / "scripts" / "probe_e2e_tick_cost.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's rows and summary, the port's run and stdout lines)."""
    tmp = tmp_path_factory.mktemp("tick_cost")
    path = write_standin_vocab(tmp / "vocab")
    jp = JM.init_params(DIMS, jax.random.PRNGKey(0), jnp.float32)
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("WLK_TPU_ASSET_DIR", str(path.parent))
        tok = get_tokenizer(True, language="en", task="transcribe")
        probe = _probe()
        script_ab = importlib.import_module("ab_inc_exact")  # as the probe imports it, from scripts/
        mp.setattr(script_ab, "build_engine", lambda model, ft, xkv_dtype, **_: JA.AlignAttEngine(
            jp, DIMS, tok, JA.AlignAttConfig(language="en", frame_threshold=ft, xkv_cache_dtype=xkv_dtype),
            model_name=model))
        mp.setattr(AB, "build_engine", lambda model, ft, xkv_dtype, device=None, **_: TA.AlignAttEngine(
            TM.params_from_jax_numpy(jax.tree.map(np.asarray, jp), DIMS, device=device), DIMS, tok,
            TA.AlignAttConfig(language="en", frame_threshold=ft, xkv_cache_dtype=xkv_dtype), model_name=model))
        mp.setattr(sys, "argv", ["probe_e2e_tick_cost.py", *ARGV, "--out", str(tmp / "jax.json")])
        probe.main()
        want = json.loads((tmp / "jax.json").read_text())
        out = tmp / "torch.json"
        lines = []
        mp.setattr("builtins.print", lambda *a, **k: lines.append(" ".join(map(str, a))))
        got = TC.run([*ARGV, "--out", str(out)], device="cpu")
    finally:
        mp.undo()
    assert json.loads(out.read_text()) == got
    return want, got, lines


def test_rows_equal_the_script(runs):
    want, got, _ = runs
    assert len(got["rows"]) == len(want["rows"]) == 8
    for g, w in zip(got["rows"], want["rows"]):
        assert (g["tick"], g["lanes"], g["modes"]) == (w["tick"], w["lanes"], w["modes"])
        assert set(g) == set(w)
        assert all(g[k] >= 0 for k in ("prepare_ms", "device_ms", "finish_ms"))
    modes = {m for r in got["rows"] for m in r["modes"]}
    assert {"anchor", "inc"} <= modes


def test_summary_keys_and_phases_equal_the_script(runs):
    want, got, _ = runs
    ws, gs = want["summary"], got["summary"]
    assert set(gs) == set(ws) | {"device"}
    assert gs["device"] == "cpu" and (gs["n"], gs["model"]) == (ws["n"], ws["model"])
    assert {k: v["n"] for k, v in gs["phases"].items()} == {k: v["n"] for k, v in ws["phases"].items()}
    # the warm-up cut: percentiles over rows[5:]
    assert gs["device_ms_p50"] == sorted(r["device_ms"] for r in got["rows"][5:])[1]


def test_lines_warm_pass_rows_summary(runs):
    """The warm pass's line first (None off CUDA: the large form warms only
    on the card), then one line a tick, then the summary."""
    _, got, lines = runs
    first = json.loads(lines[0])
    assert set(first) == {"warm_pass_s", "warm_times"} and first["warm_times"] is None
    assert [json.loads(ln) for ln in lines[1:-1]] == got["rows"]
    assert json.loads(lines[-1]) == got["summary"]
    assert got["warm_pass_s"] >= 0


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
        from whisperlivekit_tpu_torch.harness import e2e_tick_cost as TC
        r = TC.run(["--n", "2", "--ticks", "2", "--model", "dev-tiny"], device="cpu")
        assert [row["lanes"] for row in r["rows"]] == [2, 2]
        assert not any(m.split(".")[0] in REFUSED for m in sys.modules)
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
