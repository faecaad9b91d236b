"""Benchmark of whisperlivekit_tpu_torch: one cell, one run.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the repository's root on a machine with the cards the cell asks
for. Everything a cell is made of is found by name from ``BENCHMARK.json``:
its configuration file, its traffic mix (``benchmark/traffic/<mix>.json``),
the loop that mix names (``benchmark/traffic/loops/<loop>.py``), each
metric's reader (``benchmark/metrics/<metric>.py``) and the family of the
configuration's ``model_type`` (``benchmark/families/<model_type>.py``:
its system under test, weights and judge; ``families/__init__.py`` has the
contract). A model of a new kind is a family file, a plain reference under
``benchmark/reference/`` and a configuration file; no file here changes.
The last line of standard output is the result (JSON); the checks of
``correct``, each number beside its limit, are the last lines of standard
error.

``--trace 1`` reports the cell's per-layer metrics instead of its
end-to-end ones, from a run that traces a span of the same load right
after the window; the span's pace is set beside the window's and flagged
where it is more than ``SPAN_SLOWER`` slower. ``--control f8`` runs the
Whisper family's own f8 path (f8 decoder linears and cross-KV pools) in
the program's place, which the check must refuse (a family without such a
path raises); ``--sessions`` overrides an open-loop mix's session count
(the knee sweep). Neither is used by a check.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "whisperlivekit_tpu")
SPAN_SLOWER = 0.05  # a traced span this much slower than the window is flagged


def _env() -> None:
    """Fixed cache directories inside the checkout, set before torch loads."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv"), ("WLK_TPU_ASSET_DIR", "assets")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    if str(ROOT) not in sys.path:
        sys.path.insert(1, str(ROOT))


def load_cell(manifest: dict, workload: str):
    cell = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, cfg, traffic


def metrics_for(manifest: dict, workload: str, trace: bool) -> list:
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """A per-layer or end-to-end metric's reader, ``metrics/<name>.py``."""
    return _module(BENCH / "metrics" / f"{name}.py", f"bench_metric_{name.replace('.', '_')}").read


def loop(name: str):
    """An arrival shape, ``traffic/loops/<name>.py`` (see ``lib/drive.py``)."""
    return _module(BENCH / "traffic" / "loops" / f"{name}.py", f"bench_loop_{name.replace('.', '_')}")


def family(cfg: dict):
    """The family of a configuration's ``model_type``,
    ``families/<model_type>.py``; a type with no file there raises."""
    name = cfg.get("model_type")
    path = BENCH / "families" / f"{name}.py"
    if not isinstance(name, str) or not path.is_file():
        raise LookupError(f"no family for model_type {name!r}: looked for {path}")
    key = f"bench_family_{name}"
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod  # a family's dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _lag_halves(ctx) -> list:
    """Median lag of the window's first and second halves: a backlog that
    grows shows as a second half above the first (the knee sweep)."""
    from lib.context import percentile

    mid = (ctx.window.w0 + ctx.window.w1) / 2
    done = [r for r in ctx.done_in_window() if r.due is not None]
    return [percentile([(r.t_done - r.due) * 1e3 for r in done if (r.t_done < mid) == first], 50)
            for first in (True, False)]


def span_pace(ctx) -> dict:
    """The traced span's pace beside the window's: audio seconds a second
    (closed loops) and mean seconds a tick (every loop). The profiler's
    work on each launch can slow the host, and with it the idle share it
    reads."""
    from lib.context import audio_rate, mean_tick_s

    s0, s1 = ctx.window.span
    w0, w1 = ctx.window.w0, ctx.window.w1
    out = {"audio_s_per_s": [audio_rate(ctx.records, w0, w1), audio_rate(ctx.records, s0, s1)],
           "tick_s": [mean_tick_s(ctx.records, w0, w1), mean_tick_s(ctx.records, s0, s1)]}
    slower = []
    if ctx.traffic.get("loop") == "closed" and None not in out["audio_s_per_s"]:
        slower.append(out["audio_s_per_s"][0] / out["audio_s_per_s"][1] - 1)
    if None not in out["tick_s"]:
        slower.append(out["tick_s"][1] / out["tick_s"][0] - 1)
    out["slower"] = max(slower) if slower else None
    out["flagged"] = bool(out["slower"] is None or out["slower"] > SPAN_SLOWER)
    return out


def run_once(manifest: dict, workload: str, seed: int, seconds: float, trace: bool, device,
             control=None, sessions=None) -> dict:
    """One run of a cell; returns the result object (with ``checks``)."""
    import torch

    from lib import drive
    from lib.context import Context
    from lib.trace import DeviceTrace, KernelCalls

    _, cfg, traffic = load_cell(manifest, workload)
    fam = family(cfg)
    assets = fam.assets(CACHE / "assets")
    dtype = getattr(torch, cfg["serving"]["dtype"])
    sd = fam.draw(cfg, seed, device, dtype)
    system = fam.System(cfg, sd, device, control=control)
    calls = tracer = None
    if trace:
        calls = KernelCalls()
        calls.install()
        tracer = DeviceTrace(calls)
    arrivals = loop(traffic["loop"])

    async def main():
        return await arrivals.run(system, traffic, seed, seconds, trace=tracer, sessions=sessions)

    win = asyncio.run(main())
    setup_s = win.w0 - T_PROCESS
    if calls is not None:
        calls.uninstall()
    dev = torch.device(device)
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    fields = fam.context(system, cfg)
    records = system.recorder.records
    trace_sum = None
    if tracer is not None and tracer.window_s:
        trace_sum = tracer.summary()
        trace_sum.update(k1_least_s=calls.k1_least_s, k1_calls=calls.k1_calls,
                         k2_least_s=calls.k2_least_s, k2_calls=calls.k2_calls)
    ctx = Context(cfg=cfg, traffic=traffic, workload=workload, window=win, records=records,
                  setup_s=setup_s, trace=trace_sum, **fields)
    metrics = {}
    for m in metrics_for(manifest, workload, trace):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    attempted = sum(1 for r in records if win.w0 <= r.t_prep <= win.w1)
    failed = int(win.stats.get("n_failed_ticks", 0)) + int(win.phases.get("pool_recovery", (0,))[0])
    system.close()
    del system
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # correctness: the reference replays a sample of the served sessions
    jt = traffic.get("judge", {})
    voices = drive.voices_for(traffic, seed)

    def audio_of(sid, n):
        v, s = win.streams[sid]
        return voices.read(v, s, 0, n)

    limit = cfg["check"].get("mean_logit_gap")
    t_judge = time.perf_counter()
    try:
        verdict = fam.judge(records, win.w0, win.w1, seed, cfg, sd, audio_of, fields["tail_frames"], assets,
                            device, tokens=int(jt.get("tokens", 400)), max_sessions=int(jt.get("max_sessions", 8)))
        err = None
    except ValueError as e:
        verdict, err = {"mean_logit_gap": None, "tokens_compared": 0}, str(e)
    judge_s = time.perf_counter() - t_judge
    gap = verdict["mean_logit_gap"]
    checks = {
        "mean_logit_gap": {"value": gap, "limit": limit},
        "failed_ticks": {"value": failed, "limit": 0},
    }
    correct = gap is not None and limit is not None and gap <= limit and failed == 0
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": int(memory_peak),
    }
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace_sum is not None:
        device_info["busy_s"] = trace_sum["busy_s"]
        device_info["window_s"] = trace_sum["window_s"]
        if trace_sum["breakdown"]:
            result["breakdown"] = trace_sum["breakdown"]
    result["info"] = {
        "seed": seed, "control": control, "sessions": win.sessions,
        "tokens_compared": verdict["tokens_compared"], "judged_sessions": verdict.get("sessions"),
        "gap_stats": {k: verdict.get(k) for k in ("max_logit_gap", "p99_logit_gap", "flip_share")},
        "ticks_replayed": verdict.get("ticks_replayed"), "judge_error": err, "judge_s": judge_s,
        "anchor_reasons": win.reasons, "feeder_late_s": win.feeder_late_s,
        "window_lane_ticks": len(ctx.done_in_window()),
        "window_anchor_lane_ticks": sum(r.mode == "anchor" for r in ctx.done_in_window()),
        "kept_per_lane_tick": (sum(r.n_keep for r in ctx.done_in_window())
                               / max(1, len(ctx.done_in_window()))),
        "lag_p50_halves_ms": _lag_halves(ctx),
    }
    if trace_sum is not None and win.span is not None:
        result["info"]["trace_span"] = span_pace(ctx)
    result["checks"] = checks  # last: the numbers compared, each beside its limit
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("f8",), default=None)
    ap.add_argument("--sessions", type=int, default=None)
    args = ap.parse_args(argv)
    _env()
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    seconds = args.seconds if args.seconds is not None else manifest["run_seconds"]

    import torch

    cell = next((w for w in manifest["workloads"] if w["name"] == args.workload), None)
    need = cell["chips"] if cell else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_once(manifest, args.workload, args.seed, seconds, bool(args.trace), "cuda",
                      control=args.control, sessions=args.sessions)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return 3
    pace = result["info"].get("trace_span")
    if pace is not None:
        print(f"traced span against the window: audio_s_per_s {pace['audio_s_per_s']}, "
              f"tick_s {pace['tick_s']}, slower by {pace['slower']}"
              + (" (flagged: the idle share includes the profiler's cost)" if pace["flagged"] else ""),
              file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
