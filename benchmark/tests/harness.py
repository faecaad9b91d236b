"""Shared set-up of the benchmark's CPU tests: a manifest with a tiny cell
appended (``tiny.json``: Whisper's layout at 64 wide, two layers each side,
float32, two lanes a group; or ``tiny_causal.json``: the causal audio-LLM
family at the port's DEV_TINY widths), and one run of it on the CPU."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import run  # noqa: E402

SEED = 3_000_000_019  # over 32 signed bits, as a check's seeds are


def tiny_manifest(traffic: str, config: str = "tiny.json") -> dict:
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny", "source": "tests", "file": f"benchmark/tests/{config}",
                           "reduced": [], "why": "tests"})
    man["workloads"].append({"name": "tiny-cell", "config": "tiny", "traffic": traffic, "chips": 1,
                             "why": "tests"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + ["tiny-cell"]
    return man


def run_tiny(traffic: str = "steady-closed", seconds: float = 3.0, seed: int = SEED, config: str = "tiny.json",
             device: str = "cpu", **kw) -> dict:
    run._env()
    return run.run_once(copy.deepcopy(tiny_manifest(traffic, config)), "tiny-cell", seed, seconds, False, device, **kw)
