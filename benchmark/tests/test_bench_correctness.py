"""``correct`` on the CPU at a tiny size: a sound run passes; the program's
own f8 path (the control) and each fault a serving cell can have fail.

The tiny cell serves float32, so a sound run's mean logit gap against
the float32 reference is 0; its f8 path read 5.9e-4 on the CPU, and
``tiny.json``'s limit is 1e-4."""

from __future__ import annotations

import pytest

from harness import run_tiny


def test_sound_run_is_correct():
    res = run_tiny()
    assert res["correct"], res["checks"]
    assert res["info"]["tokens_compared"] >= 20
    assert res["checks"]["mean_logit_gap"]["value"] == 0.0


def test_f8_control_is_refused():
    res = run_tiny(control="f8")
    assert not res["correct"], res["checks"]
    assert res["checks"]["mean_logit_gap"]["value"] > res["checks"]["mean_logit_gap"]["limit"]


def _state_unchanged(monkeypatch):
    """The inc tick's cross-KV splice returns the pool as it was."""
    from whisperlivekit_tpu_torch.ops import xkv_merge

    monkeypatch.setattr(xkv_merge, "xkv_splice", lambda pk, pv, tk, tv, win: (pk, pv))


def _half_batch(monkeypatch):
    """The second half of a tick's lanes answer with the first half's outputs."""
    from whisperlivekit_tpu_torch.streaming import dispatch

    orig = dispatch._scatter_outputs

    def half(raw, n, max_steps):
        outs = orig(raw, n, max_steps)
        h = max(n // 2, 1)
        return outs[:h] + [outs[i % h] for i in range(h, n)]

    monkeypatch.setattr(dispatch, "_scatter_outputs", half)


def _token_altered(monkeypatch):
    """Each lane's first token is changed where the tick produces it."""
    from whisperlivekit_tpu_torch.streaming import dispatch

    orig = dispatch._scatter_outputs

    def altered(raw, n, max_steps):
        outs = orig(raw, n, max_steps)
        for o in outs:
            o.new_tokens[0] = (o.new_tokens[0] + 1) % 50257
        return outs

    monkeypatch.setattr(dispatch, "_scatter_outputs", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _token_altered],
                         ids=["state_unchanged", "half_batch", "token_altered"])
def test_fault_is_refused(monkeypatch, fault):
    fault(monkeypatch)
    res = run_tiny()
    assert not res["correct"], res["checks"]
