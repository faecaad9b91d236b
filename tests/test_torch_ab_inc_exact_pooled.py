"""The inc-vs-exact A/B's twin against scripts/ab_inc_exact.py on the CPU,
continued from tests/test_torch_ab_inc_exact.py (its engine makers, dev-tiny
with JAX's f32 weights bridged through numpy):

- ``run_model`` over 12 ticks with the cross-KV pools forced on: the inc
  and anchor sessions serve from cross-KV groups; every integer field
  equals the script's, every float within 2e-5 relative to
  ``exact_frame_rms``.
"""

import torch

from test_torch_ab_inc_exact import check_run_model, vocab, weights  # noqa: F401

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6


def test_run_model_pooled_equals_the_script(vocab, weights, monkeypatch):  # noqa: F811
    check_run_model(vocab, weights, monkeypatch, True)
