"""The ``grin_qwen2_vl`` family (Uni-MoE-2.0-Omni) on the CPU at a tiny size
(``tiny_unimoe.json``, appended to the manifest as a new configuration
would be): the draw, the system built on the drawn tensors themselves, a
closed-loop window served and judged ``correct`` with every per-layer
reader of the cell returning a number, and a planted fault refused.

``FAULTS`` are the three controls the cell's limit is set against: routing
by top-2 alone (top-p ignored), the shared experts left out, the routed
experts' weights rounded through float8_e4m3. Each patches the port through
``monkeypatch`` for one run; none is a switch of the program.

The tiny cell serves float32, so a sound run's mean logit gap against the
float32 reference is 0 bar near-ties (0.0 on the CPU); a fault reads far
above the tiny limit of 1e-4."""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from harness import BENCH, SEED, run, run_tiny

CONFIG = "tiny_unimoe.json"
MIX = "causal-steady-closed"
CELL_METRICS = ("step_mfu.causal", "moe_weight_bw_share.causal", "decode_step_ms.causal",
                "decode_rows_per_op.causal")


def _top2_only(mp):
    from whisperlivekit_tpu_torch.models import llama as lm

    route = lm.route
    mp.setattr(lm, "route", lambda h, r, d: route(h, r, dataclasses.replace(d, moe_top_p=2.0)))


def _no_shared(mp):
    from whisperlivekit_tpu_torch.models import llama as lm

    ffn = lm.moe_ffn
    mp.setattr(lm, "moe_ffn", lambda h, ex, d, c: ffn(h, ex, dataclasses.replace(d, n_shared_experts=0), c))


def _f8_routed(mp):
    from whisperlivekit_tpu_torch.models import llama as lm

    swiglu, f8 = lm._swiglu_sum, torch.float8_e4m3fn

    def rounded(h, g, u, dn, w=None):
        if w is not None:  # the routed stack
            g, u, dn = (t.to(f8).to(t.dtype) for t in (g, u, dn))
        return swiglu(h, g, u, dn, w)

    mp.setattr(lm, "_swiglu_sum", rounded)


FAULTS = {"top2_only": _top2_only, "no_shared": _no_shared, "f8_routed": _f8_routed}


def _cfg() -> dict:
    return json.loads((BENCH / "tests" / CONFIG).read_text())


def test_draw_is_the_seeds_and_the_system_holds_it():
    cfg = _cfg()
    fam = run.family(cfg)
    a, b, c = (fam.draw(cfg, s, "cpu", torch.float32) for s in (SEED, SEED, SEED + 1))
    assert a.keys() == c.keys() and all(torch.equal(a[k], b[k]) for k in a)
    key = "model.layers.1.mlp.experts.up_proj"
    assert not torch.equal(a[key], c[key])
    assert float((a[key] - c[key]).std() / a[key].std()) < 0.01  # one model, perturbed
    system = fam.System(cfg, a, "cpu")
    text = system.holder.params.text
    assert text.blocks[1].experts.up.data_ptr() == a[key].data_ptr()
    assert text.blocks[0].wq.bias.data_ptr() == a["model.layers.0.self_attn.q_proj.bias"].data_ptr()
    assert text.lm_head.weight.data_ptr() == a["lm_head.weight"].data_ptr()


def test_draw_raises_first_on_a_program_without_the_model(monkeypatch):
    from whisperlivekit_tpu_torch.models import qwen3_asr as qm

    monkeypatch.delattr(qm, "dims_from_grin_qwen2_vl")
    with pytest.raises(AttributeError):
        run.family(_cfg()).draw(_cfg(), SEED, "cpu", torch.float32)


def test_unimoe_family_runs_correct_and_feeds_its_readers(monkeypatch):
    """The cell's per-layer readers run on this untraced window (a CPU run:
    the numbers only show that each reader finds what it reads)."""
    metrics_for = run.metrics_for
    monkeypatch.setattr(run, "metrics_for", lambda man, w, trace: (
        metrics_for(man, w, False) + [m for m in man["per_layer"] if m["name"] in CELL_METRICS]))
    res = run_tiny(MIX, seconds=2.0, config=CONFIG)
    assert res["correct"], res["checks"]
    assert res["checks"]["mean_logit_gap"]["value"] == 0.0
    assert res["info"]["tokens_compared"] >= 100
    assert res["attempted"] > 0 and res["failed"] == 0
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert got["audio_s_per_s"] > 0 and got["setup_s"] > 0
    assert all(got[m] > 0 for m in CELL_METRICS), got
    assert got["decode_rows_per_op.causal"] <= 4  # two groups of two sessions
    assert run.forbidden_modules() == []


def test_unimoe_fault_is_refused(monkeypatch):
    FAULTS["top2_only"](monkeypatch)
    res = run_tiny(MIX, seconds=2.0, config=CONFIG)
    assert not res["correct"], res["checks"]
    assert res["checks"]["mean_logit_gap"]["value"] > res["checks"]["mean_logit_gap"]["limit"]
