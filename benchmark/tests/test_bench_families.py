"""Families on the CPU: every configuration's ``model_type`` finds its file
and an unknown one raises with the path; the Whisper family hands out the
harness's own functions; the causal audio-LLM family (``tiny_causal.json``,
appended to the manifest as a new configuration would be) runs through
``run.run_once`` in the closed and the open loop, correct, and each fault
it can have is refused; ``reference/causal_ref.py`` against the port.

The causal tiny cell serves float32, so a sound run's mean logit gap
against the float32 reference is 0 bar near-ties (0.0 on three seeds on
the CPU). Its faults read, on the same three seeds: a served token altered
0.140-0.184, the text tower's final norm skipped 4.4e-4 to 5.5e-4; the
limit in ``tiny_causal.json`` is 1e-4."""

from __future__ import annotations

import json

import pytest
import torch

from harness import BENCH, ROOT, run, run_tiny

from lib import audio, judge, system, weights  # noqa: E402
from reference import causal_ref as R  # noqa: E402

CAUSAL = "tiny_causal.json"


def test_every_model_type_resolves_to_a_family():
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    files = [c["file"] for c in man["configs"]] + [str(p.relative_to(ROOT)) for p in BENCH.glob("configs/*.json")]
    files += ["benchmark/tests/tiny.json", f"benchmark/tests/{CAUSAL}"]
    for f in files:
        fam = run.family(json.loads((ROOT / f).read_text()))
        for name in ("assets", "draw", "System", "context", "judge"):
            assert callable(getattr(fam, name)), (f, name)
    for cfg in ({"model_type": "no_such_model"}, {}):
        with pytest.raises(LookupError, match=str(BENCH / "families")):
            run.family(cfg)


def test_whisper_family_hands_out_the_harness_functions():
    fam = run.family({"model_type": "whisper"})
    assert fam.draw is weights.draw
    assert fam.System is system.System
    assert fam.judge is judge.judge
    assert fam.assets is audio.write_vocab


@pytest.mark.parametrize("traffic,kw", [("steady-closed", {}), ("live-open", {"sessions": 3})],
                         ids=["closed", "open"])
def test_causal_family_runs_correct(traffic, kw):
    res = run_tiny(traffic, config=CAUSAL, **kw)
    assert res["correct"], res["checks"]
    assert res["checks"]["mean_logit_gap"]["value"] == 0.0
    assert res["info"]["tokens_compared"] >= 100
    assert res["attempted"] > 0 and res["failed"] == 0
    want = "audio_s_per_s" if traffic.endswith("closed") else "lag_p50_ms"
    assert res["metrics"][want]["value"] > 0
    assert res["metrics"]["setup_s"]["value"] > 0
    assert run.forbidden_modules() == []


def _token_altered(monkeypatch):
    """Each lane's first hypothesis token is changed where it is decoded."""
    from whisperlivekit_tpu_torch.models import qwen3_asr as qm

    orig = qm.decode_hypothesis

    def altered(*a, **kw):
        toks, n, cache = orig(*a, **kw)
        toks = toks.clone()
        toks[:, 0] = (toks[:, 0] + 1) % 512
        return toks, n, cache

    monkeypatch.setattr(qm, "decode_hypothesis", altered)


def _final_norm_skipped(monkeypatch):
    """The text tower's last RMSNorm returns its input."""
    from whisperlivekit_tpu_torch.models import llama as lm

    finals = set()
    convert, norm = lm.convert_hf_state_dict, lm._rms_norm

    def converted(*a, **kw):
        model = convert(*a, **kw)
        finals.add(id(model.norm))
        return model

    monkeypatch.setattr(lm, "convert_hf_state_dict", converted)
    monkeypatch.setattr(lm, "_rms_norm", lambda x, w, eps: x if id(w) in finals else norm(x, w, eps))


@pytest.mark.parametrize("fault", [_token_altered, _final_norm_skipped], ids=["token_altered", "final_norm_skipped"])
def test_causal_fault_is_refused(monkeypatch, fault):
    fault(monkeypatch)
    res = run_tiny(config=CAUSAL)
    assert not res["correct"], res["checks"]
    assert res["checks"]["mean_logit_gap"]["value"] > res["checks"]["mean_logit_gap"]["limit"]


def test_causal_family_rejects_a_control():
    fam = run.family({"model_type": "qwen3_causal"})
    with pytest.raises(ValueError, match="no control"):
        fam.System({}, {}, "cpu", control="f8")


def test_causal_reference_matches_the_port_at_tiny_widths():
    """Three blocks through the port's tower with its cache against the
    reference's one block-causal forward, then the text tower's logits over
    [prompt | audio tokens | hypothesis]. Both run float32 with sums in
    another order (the port widens per product and caches, the reference
    runs whole matrices), so they agree to about 1e-6 of values of order
    1; the tolerance is 1e-4."""
    from whisperlivekit_tpu_torch.audio.mel import log_mel_spectrogram
    from whisperlivekit_tpu_torch.models import llama as lm
    from whisperlivekit_tpu_torch.models import qwen3_asr as qm

    cfg = json.loads((BENCH / "tests" / CAUSAL).read_text())
    fam = run.family(cfg)
    sd = fam.draw(cfg, 77, "cpu", torch.float32)
    dims = fam.port_dims(cfg)
    port = qm.convert_hf_state_dict(sd, dims, dtype=torch.float32)
    ref = R.CausalLM(sd, R.dims(cfg), "cpu")
    bs = dims.block_samples
    blocks = torch.from_numpy(audio.Voices(3, 1, 2.0).voices[0][: 3 * bs].copy()).view(3, bs)
    cache = qm.init_tower_cache(dims, 1)
    feats = [qm.encode_block(port, log_mel_spectrogram(b, n_mels=dims.n_mels)[None], cache,
                             torch.tensor([i * dims.block_frames]), dims)[0] for i, b in enumerate(blocks)]
    emb_p = qm.project_audio_tokens(port, torch.cat(feats, 1), dims)[0]
    emb_r = ref.audio_tokens(blocks)
    assert torch.allclose(emb_p, emb_r, atol=1e-4)
    ids = [1, 2, 3]
    hyp = [4, 17, 301, 5]
    embeds = torch.cat([ref.embed(ids), emb_r, ref.embed(hyp)])[None]
    text_cache = lm.init_cache(dims.text, 1, embeds.shape[1])
    lg_p, _ = lm.forward(port.text, embeds, torch.zeros(1, dtype=torch.long), text_cache, dims.text)
    lg_r = ref.text_logits(embeds[0])
    assert torch.allclose(lg_p[0], lg_r, atol=1e-4)
    # the reference's own greedy tokens read gaps of 0, one for each token
    greedy = []
    for _ in range(4):
        seq = torch.cat([ref.embed(ids), emb_r, ref.embed(hyp[:1] + greedy)])
        greedy.append(int(ref.text_logits(seq)[-1].argmax()))
    assert ref.gaps(blocks, ids, hyp[:1], greedy) == [0.0] * 4


@pytest.mark.cuda
def test_tiny_causal_on_the_card():
    """The causal family at tiny widths served on the card, judged by the
    reference there with TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for seed in (3_000_000_019, 3_100_000_007, 3_200_000_011):
        for traffic, kw in (("steady-closed", {}), ("live-open", {"sessions": 3})):
            res = run_tiny(traffic, seed=seed, config=CAUSAL, device="cuda", **kw)
            print("card", seed, traffic, json.dumps(res["checks"]), res["info"]["tokens_compared"],
                  res["info"]["gap_stats"], flush=True)
            assert res["correct"], res["checks"]
            assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
