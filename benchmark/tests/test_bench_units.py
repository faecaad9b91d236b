"""The benchmark's own parts on the CPU: discovery by name, the traffic
plans, the metric arithmetic, the kernel counts, the reference against the
port at tiny widths, and the check for JAX."""

from __future__ import annotations

import asyncio
import json
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from harness import BENCH, ROOT, run

from lib import drive, flops, weights  # noqa: E402
from lib.audio import Voices  # noqa: E402
from lib.context import Context, percentile  # noqa: E402
from lib.system import TickRecord  # noqa: E402
from lib.trace import busy_and_gaps  # noqa: E402
from reference import whisper_ref as R  # noqa: E402


def test_every_name_resolves_to_a_file():
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in man["workloads"]:
        cell, cfg, traffic = run.load_cell(man, w["name"])
        arrivals = run.loop(traffic["loop"])
        assert callable(arrivals.run) and callable(arrivals.plan)
        assert cfg["serving"]["dtype"]
        assert callable(run.family(cfg).System)
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(run.reader(m["name"]))


def test_a_dropped_in_file_is_found(tmp_path, monkeypatch):
    tree = tmp_path / "benchmark"
    shutil.copytree(BENCH, tree, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    (tree / "metrics" / "new_metric.x.py").write_text("def read(ctx):\n    return 7.0\n")
    (tree / "traffic" / "loops" / "burst.py").write_text(
        "def plan(traffic, seed, n):\n    return list(range(n))\n\n"
        "async def run(system, traffic, seed, seconds, trace=None, sessions=None):\n    return 'burst'\n")
    (tree / "traffic" / "new-mix.json").write_text(json.dumps({"loop": "burst", "sessions": 3}))
    (tree / "configs" / "new.json").write_text(json.dumps({"model_type": "new_model", "serving": {"dtype": "float32"}}))
    (tree / "families" / "new_model.py").write_text(
        "from dataclasses import dataclass\n\n@dataclass\nclass System:\n    lanes: int = 4\n")
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "new", "file": "benchmark/configs/new.json"})
    man["workloads"].append({"name": "new-cell", "config": "new", "traffic": "new-mix", "chips": 1})
    monkeypatch.setattr(run, "BENCH", tree)
    monkeypatch.setattr(run, "ROOT", tmp_path)
    assert run.reader("new_metric.x")(None) == 7.0
    _, cfg, traffic = run.load_cell(man, "new-cell")
    assert traffic["sessions"] == 3 and cfg["serving"]["dtype"] == "float32"
    assert run.family(cfg).System().lanes == 4
    arrivals = run.loop(traffic["loop"])
    assert arrivals.plan(traffic, 1, 3) == [0, 1, 2]
    assert asyncio.run(arrivals.run(None, traffic, 1, 1.0)) == "burst"


@pytest.mark.parametrize("mix", ["steady-closed", "churn-closed", "live-open"])
def test_mix_is_deterministic_from_its_seed(mix):
    traffic = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    plan = run.loop(traffic["loop"]).plan
    n = 48 if traffic["loop"] == "closed" else 40
    a, b, c = plan(traffic, 5, n), plan(traffic, 5, n), plan(traffic, 6, n)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    # every seed gets the same sizes; a mix with a base seed, the same plan
    assert sorted(a[0]) == sorted(c[0]) and sorted(a[1]) == sorted(c[1])
    if traffic["loop"] == "closed" and a[2]:  # the same session lengths, in an order
        assert [sorted(x) for x in a[2]] == [sorted(x) for x in c[2]]
    if "base_seed" in traffic:
        assert all(np.array_equal(x, y) for x, y in zip(a, c))
    else:
        assert list(a[0]) != list(c[0])
    small = dict(traffic, voice_s=2.0)
    v1, v2, v3 = (drive.voices_for(small, s) for s in (5, 5, 6))
    assert np.array_equal(v1.voices[1], v2.voices[1])
    assert not np.array_equal(v1.voices[1], v3.voices[1])
    if "base_seed" in traffic:  # the seed only adds the sample noise
        gap = np.std(v1.voices[1] - v3.voices[1])
        assert gap == pytest.approx(traffic["sample_noise"] * 2 ** 0.5, rel=0.05)


def _ctx(records, w0=0.0, w1=10.0, trace=None):
    win = drive.Window(w0=w0, w1=w1, stats={"n_ticks": 4, "n_lanes_served": 96},
                       phases={"inc_xkv": (3, 2.7, 72), "anchor_xkv": (1, 1.3, 24), "pool_update": (4, 0.04, 96)})
    return Context(cfg={}, traffic={}, workload="w", window=win, records=records, setup_s=1.0,
                   max_steps=8, eot=50257, tail_frames=160, trace=trace)


def _recs(times, advanced=16000, due_lag=0.5, sid=None):
    return [TickRecord(sid=i if sid is None else sid, t_prep=t - 0.4, t_done=t, advanced=advanced,
                       due=t - due_lag) for i, t in enumerate(times)]


def test_rate_tail_and_idle_arithmetic():
    # one session, a one-second tick every half second from before the
    # window to after it: two seconds of audio a second, whatever the edges
    steady = _ctx(_recs(np.arange(-0.3, 11, 0.5), sid=0))
    assert run.reader("audio_s_per_s")(steady) == pytest.approx(2.0)
    # the same session stalls from 5 s on: its next result comes at 12 s
    stalled = _ctx(_recs(np.append(np.arange(-0.3, 5, 0.5), 12.0), sid=0))
    assert run.reader("audio_s_per_s")(stalled) == pytest.approx((0.4 + 9 + 5.3 / 7.3) / 10)
    stalled_early = _ctx(_recs(np.append(-4.0, np.arange(5.2, 11, 0.5)), sid=0))
    assert run.reader("audio_s_per_s")(stalled_early) < run.reader("audio_s_per_s")(steady)
    outside = _ctx(_recs([-3.0, -2.0, 11.0, 12.0]))  # separate sessions' ticks outside the window
    assert run.reader("audio_s_per_s")(outside) is None
    lags = _ctx(_recs(np.arange(1, 11), due_lag=0.0))
    for i, r in enumerate(lags.records):
        r.due = r.t_done - (i + 1) / 10              # lags 100 .. 1000 ms
    assert run.reader("lag_p50_ms")(lags) == pytest.approx(550.0)
    assert run.reader("lag_p95_ms")(lags) == pytest.approx(955.0)
    assert percentile([3.0], 95) == 3.0
    assert run.reader("lanes_per_tick.closed")(steady) == 24.0
    assert run.reader("anchor_share.closed")(steady) == pytest.approx(25.0)
    assert run.reader("tick_ms.closed")(steady) == pytest.approx(1010.0)
    busy, gaps = busy_and_gaps([("a", 0, 400), ("b", 300, 500), ("c", 800, 1000)], 0, 1000)
    assert busy == pytest.approx(700e-9) and [g[0] for g in gaps] == [pytest.approx(300e-9)]
    traced = _ctx([], trace={"busy_s": 2.0, "window_s": 8.0, "by_name": {"void xkv_splice_kernel<x>": 0.5},
                             "k2_least_s": 0.25, "k2_calls": 3})
    assert run.reader("device_idle_share.closed")(traced) == pytest.approx(75.0)
    assert run.reader("xkv_splice_roofline.closed")(traced) == pytest.approx(50.0)
    assert run.reader("enc_attn_roofline.closed")(traced) is None


def test_traced_span_pace_is_set_beside_the_window():
    # one session ticks every 0.5 s in the window (0-10 s); in the traced
    # span (10-18 s) every 0.5 s again, then every 0.6 s
    for step, flagged in ((0.5, False), (0.6, True)):
        times = list(np.arange(-0.3, 10.0, 0.5)) + list(10.2 + step * np.arange(0, 20))
        ctx = _ctx(_recs(times, sid=0))
        ctx.traffic = {"loop": "closed"}
        ctx.window.span = (10.0, 18.0)
        pace = run.span_pace(ctx)
        assert pace["audio_s_per_s"][0] == pytest.approx(2.0)
        assert pace["audio_s_per_s"][1] == pytest.approx(1 / step, rel=0.03)
        assert pace["slower"] == pytest.approx(step / 0.5 - 1, abs=0.03)
        assert pace["flagged"] is flagged


def test_kernel_counts_reproduce_the_bounds():
    # PERF.md's kernel table: K1 at the large-v3 encoder's B8 shape, K2 at
    # 6 of 8 lanes into bf16 and f8 pools
    assert flops.k1_least_s(8, 20, 1500, 1500, 64) * 1e3 == pytest.approx(0.0932, abs=5e-5)
    assert flops.k2_least_s(6, 32, 20, 64) * 1e3 == pytest.approx(0.1502, abs=5e-5)
    assert flops.k2_least_s(6, 32, 20, 64, 2, 1) * 1e3 == pytest.approx(0.1127, abs=5e-5)


def test_reference_matches_the_port_at_tiny_widths():
    from whisperlivekit_tpu_torch.audio.mel import log_mel_spectrogram
    from whisperlivekit_tpu_torch.models.whisper import model as wm
    from whisperlivekit_tpu_torch.models.whisper.load import convert_openai_state_dict

    from lib.system import port_dims

    cfg = json.loads((BENCH / "tests" / "tiny.json").read_text())
    sd = weights.draw(cfg, 77, "cpu", torch.float32)
    port = convert_openai_state_dict(sd, port_dims(cfg), dtype=torch.float32)
    ref = R.Whisper(sd, _dims(cfg), "cpu")
    audio = torch.from_numpy(Voices(3, 1, 3.0).voices[0])
    mel_p = log_mel_spectrogram(audio, n_mels=80)
    mel_r = R.log_mel(audio, ref.filters)
    assert torch.allclose(mel_p, mel_r, atol=1e-4)
    enc_p = wm.encode(port, mel_r[None], port_dims(cfg), pos_start=torch.tensor([40]))[0]
    enc_r = ref.encode(mel_r, pos_start=40)
    assert torch.allclose(enc_p, enc_r, atol=1e-4)
    # a prefill of five rows against the port's decode
    xkv = wm.cross_kv(port, enc_p[None], port_dims(cfg))
    cache = wm.init_cache(port_dims(cfg), 1, width=16)
    toks = torch.tensor([[50258, 50259, 50360, 50364, 400]])
    lg_p, _, _ = wm.decode(port, toks, torch.zeros(1, dtype=torch.long), xkv, cache, port_dims(cfg))
    lg_r = R.decode_rows(ref, R.DecoderState(ref), ref.cross_kv(enc_r), toks[0].tolist(), range(5))
    assert torch.allclose(lg_p[0], lg_r, atol=1e-3)


def _dims(cfg):
    from lib.judge import ref_dims

    return ref_dims(cfg)


def test_dry_penalty_matches_the_port():
    from whisperlivekit_tpu_torch.streaming.alignatt import dry_penalty

    rng = np.random.default_rng(0)
    for _ in range(20):
        seq = list(rng.integers(0, 6, size=int(rng.integers(3, 40))))
        logits = torch.zeros(1, 50300)
        want = dry_penalty(logits, torch.tensor([seq + [50257] * 8]), torch.tensor([len(seq)]), 50257)[0]
        got = torch.zeros(50300)
        for t, pen in R.dry_penalty([int(x) for x in seq], 50257).items():
            got[t] -= pen
        assert torch.equal(want, got)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "whisperlivekit_tpu_torch_extra", types.ModuleType("x"))
    assert "whisperlivekit_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "whisperlivekit_tpu.streaming", types.ModuleType("y"))
    assert "whisperlivekit_tpu" in run.forbidden_modules()


def test_nothing_the_benchmark_loads_imports_jax():
    code = (
        "import sys, pathlib; sys.path[:0] = ['benchmark', '.']\n"
        "import run; run._env()\n"
        "from lib import audio, context, drive, flops, judge, system, trace, weights\n"
        "from reference import causal_ref, whisper_ref\n"
        "for p in sorted(pathlib.Path('benchmark/metrics').glob('*.py')): run.reader(p.stem)\n"
        "for p in sorted(pathlib.Path('benchmark/families').glob('[!_]*.py')): run.family({'model_type': p.stem})\n"
        "from whisperlivekit_tpu_torch.streaming import qwen3_batch, qwen3_causal\n"
        "from whisperlivekit_tpu_torch.engine import scheduler\n"
        "from whisperlivekit_tpu_torch.streaming import simul_processor, dispatch\n"
        "from whisperlivekit_tpu_torch.models.whisper import load, tokenizer\n"
        "from whisperlivekit_tpu_torch.ops import flash_encoder, xkv_merge\n"
        "print(run.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
