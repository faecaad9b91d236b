"""The capacity table's twin (whisperlivekit_tpu_torch/harness/capacity_table.py)
against scripts/gen_capacity_table.py, on scripted artifacts:

- ``render``: the same sweep artifact gives the same table rows and peak
  lines (arms run, skipped and failed; peaks with and without an
  unconstrained figure), and the headline's figures; the port's page
  names the card and carries no history of earlier rounds;
- ``e2e_section``: the same summary gives the same sustained counts and
  rows (the script globs ``docs/perf/``, so it reads a copy there in a
  temporary directory);
- ``main`` writes ``--out`` (by default ``docs/perf/CAPACITY_torch.md``
  under the working directory), needs the sweep's path, and refuses the
  JAX generator's page, which stays byte for byte as it was;
- the twin imports neither torch nor jax.
"""

import importlib.util
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from whisperlivekit_tpu_torch.harness import capacity_table as CT

REPO = Path(__file__).resolve().parent.parent
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _script():
    spec = importlib.util.spec_from_file_location("gen_capacity_table", REPO / "scripts" / "gen_capacity_table.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J = _script()


def _arm(inc, anchor, amort, streams):
    return {"inc_ms": inc, "anchor_ms": anchor, "amortized_ms": amort, "streams": streams, "peak_alloc_gib": 9.5}


def _artifact(headline, peaks_equal=False) -> dict:
    """A harness/capacity.py --out artifact: the base arm, turbo, large-v3
    in three dtypes at two widths, one arm skipped and one failed."""
    subs = {
        "base_B96_enc": _arm(221.5, 309.0, 227.3, 422.3),
        "base_peak_streams": 422.3, "base_peak_streams_unconstrained": 422.3, "base_peak_tick_ms": 227.3,
        "large-v3-turbo_B64_bf16": _arm(302.7, 1007.2, 349.7, 183.0),
        "large-v3-turbo_peak_streams": 183.0, "large-v3-turbo_peak_streams_unconstrained": 183.0,
        "large-v3-turbo_peak_tick_ms": 349.7,
        "large-v3_B24_bf16": _arm(455.6, 1004.3, 492.2, 48.8),
        "large-v3_B24_f8": _arm(576.0, 1113.6, 611.8, 39.2),
        "large-v3_B24_f8d": _arm(446.5, 1066.4, 487.8, 49.2),
        "large-v3_B48_bf16": _arm(509.8, 1281.7, 561.2, 85.5),
        "large-v3_B48_f8": "SKIPPED resident 30.1G + 0.8G margin > free 20.0G",
        "large-v3_B48_f8d": "FAILED OutOfMemoryError",
        "large-v3_peak_streams": headline,
        "large-v3_peak_streams_unconstrained": headline if peaks_equal else 85.5,
        "large-v3_peak_tick_ms": 492.2 if headline else 0.0,
    }
    return {"round": "r1", "device": CARD, "platform": "Linux",
            "headline": {"metric": "concurrent_realtime_streams_per_chip_whisper_large_v3", "value": headline,
                         "unit": "streams", "vs_baseline": round(headline * 0.144, 2)},
            "sub_metrics": subs}


E2E = {
    "model": "random:large-v3", "xkv_dtype": "f8", "decoder_dtype": "bf16", "max_steps": 8,
    "anchor_cohorts": None, "commit_budget": None, "max_sustained_streams": 48,
    "max_sustained_streams_at_500ms_p50": 16, "device": CARD, "vad": "SileroJITVAD",
    "runs": [
        {"n_sessions": 16, "keep_up": True, "word_emission_p50_ms": 412.4, "word_emission_p95_ms": 1203.9,
         "duration_s": 60.0, "scheduler": {"tick_ms_p50": 762.1}},
        {"n_sessions": 48, "keep_up": True, "word_emission_p50_ms": 23868.2, "word_emission_p95_ms": 29082.6,
         "duration_s": 60.0, "scheduler": {"tick_ms_p50": 764.3}},
        {"n_sessions": 64, "keep_up": False, "word_emission_p50_ms": 36405.6, "word_emission_p95_ms": 42069.1,
         "duration_s": 60.0, "scheduler": {"tick_ms_p50": 1084.1}},
    ],
}


def _rows(text: str) -> list:
    """The table rows (past each header) and the bulleted lines."""
    lines = text.splitlines()
    return [ln for ln in lines if (ln.startswith("| ") and not ln.startswith(("| model", "| n "))) or
            ln.startswith("- ")]


@pytest.mark.parametrize("headline,peaks_equal", [(48.8, False), (0.0, False), (72.0, True)])
def test_render_rows_and_peaks_equal_the_script(headline, peaks_equal):
    art = _artifact(headline, peaks_equal)
    want, got = J.render(art, "sweep.json"), CT.render(art, "sweep.json")
    assert _rows(got) == _rows(want)
    assert len(_rows(got)) == 11  # 8 arms, 3 peaks
    assert f"**Headline: {headline} concurrent real-time large-v3 streams per card" in got
    assert f"{art['headline']['vs_baseline']}x the reference's" in got
    assert ("**MET**" in got) == (headline >= 64) == ("**MET**" in want)
    assert ("Unconstrained peak ignoring the latency clause: 85.5 streams" in got) == (not peaks_equal)
    assert f"device {CARD}" in got
    for tpu_word in ("History", "r1 24.9", "v5e", "HBM budget"):
        assert tpu_word not in got


def test_e2e_section_rows_equal_the_script(tmp_path, monkeypatch):
    perf = tmp_path / "docs" / "perf"
    perf.mkdir(parents=True)
    (perf / "e2e_serving_r9.json").write_text(json.dumps(E2E))
    monkeypatch.chdir(tmp_path)
    want = "\n".join(J.e2e_section())
    got = "\n".join(CT.e2e_section(perf / "e2e_serving_r9.json"))
    assert _rows(got) == _rows(want)
    assert len(_rows(got)) == 5  # 2 counts, 3 runs
    assert "5-minute" not in got and f"device {CARD}" in got and "VAD SileroJITVAD" in got


def test_main_writes_out_and_refuses_the_jax_page(tmp_path, monkeypatch, capsys):
    jax_page = REPO / "docs" / "perf" / "CAPACITY.md"
    before = jax_page.read_bytes()
    cap, e2e = tmp_path / "sweep.json", tmp_path / "e2e.json"
    cap.write_text(json.dumps(_artifact(48.8)))
    e2e.write_text(json.dumps(E2E))
    monkeypatch.chdir(tmp_path)
    assert CT.main([str(cap), "--e2e", str(e2e)]) == 0
    page = (tmp_path / CT.DEFAULT_OUT).read_text()
    assert page == CT.render(_artifact(48.8), "sweep.json") + "\n".join(CT.e2e_section(e2e)) + "\n"
    out = tmp_path / "t.md"
    assert CT.main([str(cap), "--out", str(out)]) == 0
    assert out.read_text() == CT.render(_artifact(48.8), "sweep.json")
    with pytest.raises(SystemExit):
        CT.main([])  # the sweep's path is required: nothing is globbed
    with pytest.raises(SystemExit, match="refusing"):
        CT.main([str(cap), "--out", str(jax_page)])
    monkeypatch.chdir(REPO)
    with pytest.raises(SystemExit, match="refusing"):
        CT.main([str(cap), "--out", "docs/perf/CAPACITY.md"])
    assert jax_page.read_bytes() == before
    capsys.readouterr()


def test_twin_imports_neither_torch_nor_jax(tmp_path):
    (tmp_path / "s.json").write_text(json.dumps(_artifact(48.8)))
    code = textwrap.dedent(
        f"""
        import sys
        REFUSED = ("jax", "jaxlib", "whisperlivekit_tpu", "torch")
        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in REFUSED:
                    raise ImportError("refused in this process: " + name)
                return None
        sys.meta_path.insert(0, Refuse())
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "capacity_table", "whisperlivekit_tpu_torch/harness/capacity_table.py")
        CT = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(CT)
        CT.main([{str(tmp_path / "s.json")!r}, "--out", {str(tmp_path / "o.md")!r}])
        assert not any(m.split(".")[0] in REFUSED for m in sys.modules)
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
