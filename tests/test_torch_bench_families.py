"""The benchmark's model families in tier-1: the causal audio-LLM family's
groups of ``benchmark/tests/test_bench_families.py`` (runs in the closed and
the open loop, faults refused, no control, the reference against the port)
and every test of ``benchmark/tests/test_bench_unimoe.py`` (the
``grin_qwen2_vl`` family: Uni-MoE-2.0-Omni at a tiny size) and of
``benchmark/tests/test_bench_decode_graph.py`` (the decode graph's share),
loaded from their files by path and run on the CPU as they are.

The runs that end by checking that no module of JAX or of the JAX package
was loaded cannot make that check in this process, where the suite's other
files load them: each runs in a pytest process of its own."""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

ROOT = Path(__file__).resolve().parents[1]
BENCH_TESTS = ROOT / "benchmark" / "tests"
if str(BENCH_TESTS) not in sys.path:
    sys.path.insert(0, str(BENCH_TESTS))  # their ``harness``


@pytest.fixture(autouse=True)
def _environment_restored():
    """``run._env`` sets cache directories in the environment for its run;
    the suite's other files, in the same worker, must not see them."""
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"bench_tests_{name}", BENCH_TESTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_families = _load("test_bench_families")
test_causal_fault_is_refused = _families.test_causal_fault_is_refused
test_causal_family_rejects_a_control = _families.test_causal_family_rejects_a_control
test_causal_reference_matches_the_port_at_tiny_widths = _families.test_causal_reference_matches_the_port_at_tiny_widths

_unimoe = _load("test_bench_unimoe")
test_draw_is_the_seeds_and_the_system_holds_it = _unimoe.test_draw_is_the_seeds_and_the_system_holds_it
test_draw_raises_first_on_a_program_without_the_model = _unimoe.test_draw_raises_first_on_a_program_without_the_model
test_unimoe_fault_is_refused = _unimoe.test_unimoe_fault_is_refused

_graph = _load("test_bench_decode_graph")
test_decode_graph_share_reads_replays_over_steps = _graph.test_decode_graph_share_reads_replays_over_steps
test_decode_graph_share_reads_nothing_without_the_tracer = _graph.test_decode_graph_share_reads_nothing_without_the_tracer


@pytest.mark.parametrize("node", [
    "test_bench_families.py::test_causal_family_runs_correct[closed]",
    "test_bench_families.py::test_causal_family_runs_correct[open]",
    "test_bench_unimoe.py::test_unimoe_family_runs_correct_and_feeds_its_readers",
])
def test_runs_in_a_process_without_jax(node):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-m", "pytest", "-p", "no:cacheprovider", "-p", "no:randomly",
                          str(BENCH_TESTS / node)], cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    assert "1 passed" in out.stdout
