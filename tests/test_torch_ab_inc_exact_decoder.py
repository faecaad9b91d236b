"""The inc-vs-exact A/B's twin against scripts/ab_inc_exact.py on the CPU,
continued from tests/test_torch_ab_inc_exact.py (its engine makers, dev-tiny
with JAX's f32 weights bridged through numpy):

- ``run_decoder_ab``: the unquantized arm's gate frames and committed
  texts exactly, the f8 arm's committed tokens by agreement, and the
  result dict the script's;
- the events route on a ``save_params`` npz fills ``vs_truth``;
- ``main`` writes the runs and the device.
"""

import json

import torch

from test_torch_ab_inc_exact import AB, J, _engine_makers, vocab, weights  # noqa: F401
from whisperlivekit_tpu_torch.harness import train_structured as TS
from whisperlivekit_tpu_torch.models.whisper import model as TM
from whisperlivekit_tpu_torch.models.whisper.dims import MODEL_DIMS
from whisperlivekit_tpu_torch.models.whisper.tokenizer import get_tokenizer as get_torch_tokenizer

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6


def _record_arms(monkeypatch, mod):
    """Wrap ``make_inc_session`` of a script so each session records, per
    engine, the gate frame and committed texts of its ticks."""
    arms = {}
    real = mod.make_inc_session

    def make(engine, group_width=1):
        s = real(engine, group_width)
        log = arms.setdefault(id(engine), [])
        finish = s.finish_tick

        def recorded(ti, out):
            words = finish(ti, out)
            log.append((int(out.last_attend), [w.text for w in words]))
            return words
        s.finish_tick = recorded
        return s
    monkeypatch.setattr(mod, "make_inc_session", make)
    return arms


def test_run_decoder_ab_arms_equal_the_script(vocab, weights, monkeypatch):  # noqa: F811
    """The unquantized arm's gate frames and committed texts equal the
    script's exactly; the f8 arm's committed tokens agree within the f8
    sessions' bar (tests/test_torch_large_session.py commits identical
    ids), so the whole result dict is the script's."""
    jbuild, tbuild = _engine_makers(weights, vocab, False)
    monkeypatch.setattr(J, "build_engine", jbuild)
    monkeypatch.setattr(AB, "build_engine", tbuild)
    jarms, tarms = _record_arms(monkeypatch, J), _record_arms(monkeypatch, AB)
    want = J.run_decoder_ab("dev-tiny", 12 / 60, 1, "bf16")
    got = AB.run_decoder_ab("dev-tiny", 12 / 60, 1, "bf16", device="cpu")
    (jb, jf), (tb, tf) = jarms.values(), tarms.values()
    assert tb == jb and len(tb) == 12
    toks = lambda log: [t for _, texts in log for x in texts for t in vocab.encode(x)]  # noqa: E731
    assert AB._tok_agreement(toks(tf), toks(jf)) == 1.0
    assert got.pop("wall_s") >= 0 and want.pop("wall_s") >= 0
    assert got == want
    assert got["committed_tokens"]["n_bf16"] > 0


def test_events_route_fills_vs_truth(vocab, tmp_path):  # noqa: F811
    """``--weights`` with a save_params npz: the bf16 checkpoint loads with
    the fallback alignment heads and the event stream's words give each
    arm's truth agreement."""
    model = TM.init_params(MODEL_DIMS["dev-tiny"], torch.Generator().manual_seed(3), torch.bfloat16)
    path = tmp_path / "w.npz"
    TS.save_params(model, "dev-tiny", path)
    r = AB.run_model("dev-tiny", 6 / 60, 1, "bf16", 5, weights=str(path), audio_kind="events",
                     reset_every_s=4, device="cpu")
    tok = get_torch_tokenizer(True, language="en", task="transcribe")
    words, _ = TS.word_vocab(tok)
    n_truth = sum(len(tok.encode(" " + w)) for w in TS.events_words(7, 0.0, 6.0, words))
    assert r["vs_truth"]["n_truth_tokens"] == n_truth > 0
    for key in ("inc_vs_truth_agreement", "exact_vs_truth_agreement"):
        assert 0.0 <= r["vs_truth"][key] <= 1.0
    assert r["audio"] == "events" and r["reset_every_s"] == 4 and r["weights"] == str(path)
    assert r["n_ticks_compared"] == 6


def test_main_writes_runs_and_device(vocab, weights, monkeypatch, tmp_path, capsys):  # noqa: F811
    _, tbuild = _engine_makers(weights, vocab, False)
    monkeypatch.setattr(AB, "build_engine", tbuild)
    out = tmp_path / "ab.json"
    assert AB.main(["--models", "dev-tiny", "--minutes", str(6 / 60), "--decoder-ab", "--out", str(out)],
                   device="cpu") == 0
    art = json.loads(out.read_text())
    assert art["device"] == "cpu" and len(art["runs"]) == 1
    assert art["runs"][0]["comparison"] == "decoder_bf16_vs_f8" and art["runs"][0]["n_ticks"] == 6
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == art["runs"][0]
