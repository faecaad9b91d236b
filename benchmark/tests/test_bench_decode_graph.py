"""``decode_graph_share.causal`` from planted tracer counters: the share of
decode steps that replayed the step's CUDA graph, and nothing where the
window has no decode step or the program no graph counters."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from harness import run


def _ctx(counters):
    return SimpleNamespace(window=SimpleNamespace(stats={"trace": {"counters": counters}}))


@pytest.mark.parametrize("counters, share", [
    ({"causal.decode_steps": 200, "causal.graph_replays": 194}, 97.0),
    ({"causal.decode_steps": 48, "causal.graph_replays": 47, "causal.graph_captures": 1}, 100.0 * 47 / 48),
    ({"causal.decode_steps": 10, "causal.graph_captures": 1}, 0.0),  # captured, never replayed
    ({"causal.decode_steps": 0, "causal.graph_replays": 0}, None),
    ({"causal.graph_replays": 5}, None),
    ({"causal.decode_steps": 100}, None),  # a program without the graph counters
    ({}, None),
])
def test_decode_graph_share_reads_replays_over_steps(counters, share):
    got = run.reader("decode_graph_share.causal")(_ctx(counters))
    assert got == (None if share is None else pytest.approx(share))


def test_decode_graph_share_reads_nothing_without_the_tracer():
    assert run.reader("decode_graph_share.causal")(SimpleNamespace(window=SimpleNamespace(stats={}))) is None
