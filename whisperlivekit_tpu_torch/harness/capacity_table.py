"""Render the port's capacity sweep and e2e summary as one Markdown table.

    python -m whisperlivekit_tpu_torch.harness.capacity_table SWEEP.json [--e2e E2E.json]
        [--out docs/perf/CAPACITY_torch.md]

Port of the repository's ``scripts/gen_capacity_table.py``. ``SWEEP.json``
is a ``harness/capacity.py --out`` artifact, ``E2E.json`` a
``harness/e2e_serving.py --out`` summary; each names the card it ran on
(its name and power limit), and the page is stamped with it. The table
rows (model, B, pool dtype, inc / anchor / amortized wall ms, streams) and
the peak lines are the JAX script's, as are the e2e section's rows.

Differences from the JAX script: both inputs are explicit paths (it never
globs ``docs/perf/``, whose artifacts are the JAX package's); it writes
``--out``, by default ``docs/perf/CAPACITY_torch.md``, and refuses the JAX
generator's page ``docs/perf/CAPACITY.md``; the page carries no history of
earlier rounds. ``device`` in ``main``'s signature is the harness's common
one: rendering runs on no device. Imports neither torch nor JAX.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

NORTH_STAR = 64  # BASELINE.json: >=64 real-time large-v3 streams per chip
DEFAULT_OUT = "docs/perf/CAPACITY_torch.md"
#: the JAX generator's page, which this program never writes
JAX_PAGE = Path(__file__).resolve().parents[2] / "docs" / "perf" / "CAPACITY.md"


def render(art: dict, src_name: str) -> str:
    """The page's capacity part from a sweep artifact: the headline, one
    row per arm and one line per model's peak."""
    subs = art["sub_metrics"]
    head = art["headline"]
    # both north-star clauses: >=64 streams AND p50 word emission <= 500 ms;
    # the sweep's peak picker enforces the latency clause, so
    # headline.value is the latency-honest peak and the unconstrained max
    # stands beside it
    hl_tick = subs.get("large-v3_peak_tick_ms")
    hl_raw = subs.get("large-v3_peak_streams_unconstrained")
    met = "**MET**" if head["value"] >= NORTH_STAR else "**NOT MET**"
    lines = [
        "# Capacity of the PyTorch/CUDA port (generated — do not edit)",
        "",
        f"Source: `{src_name}` (harness/capacity.py sweep, round {art.get('round')}, "
        f"device {art.get('device')}).",
        "Regenerate with `python -m whisperlivekit_tpu_torch.harness.capacity_table "
        f"{src_name} [--e2e E2E.json]`.",
        "",
        f"**Headline: {head['value']} concurrent real-time large-v3 streams "
        f"per card at <= 500 ms p50 tick latency**"
        + (f" (amortized tick {hl_tick} ms; " if hl_tick is not None else " (")
        + f"{head['vs_baseline']}x the reference's best large-model "
        "streaming figure — faster-whisper SimulStreaming large-v3-turbo "
        "compute-aware RTF 0.144 on H100, BASELINE.md). "
        + (f"Unconstrained peak ignoring the latency clause: {hl_raw} streams. "
           if hl_raw is not None and hl_raw != head["value"] else "")
        + f"North-star (>= {NORTH_STAR} @ large-v3 AND p50 <= 500 ms): {met}.",
        "",
        "| model | B | pool | inc tick | anchor | amortized | streams |",
        "|---|---|---|---|---|---|---|",
    ]
    peaks = []
    for key, v in subs.items():
        if key.endswith("_peak_streams"):
            peaks.append((key[: -len("_peak_streams")], v))
            continue
        if key.endswith("_peak_streams_unconstrained") or key.endswith("_peak_tick_ms"):
            continue
        model, Bs, dt = key.rsplit("_", 2)
        if not isinstance(v, dict):
            lines.append(f"| {model} | {Bs[1:]} | {dt} | — | — | — | {v} |")
            continue
        lines.append(
            f"| {model} | {Bs[1:]} | {dt} | {v['inc_ms']} ms | "
            f"{v['anchor_ms']} ms | {v['amortized_ms']} ms | "
            f"**{v['streams']}** |"
        )
    lines.append("")
    for model, v in peaks:
        tick = subs.get(f"{model}_peak_tick_ms")
        raw = subs.get(f"{model}_peak_streams_unconstrained")
        extra = f" (amortized tick {tick} ms)" if tick is not None else ""
        if raw is not None and raw != v:
            extra += f"; unconstrained {raw}"
        lines.append(f"- {model} peak @ <= 500 ms p50: **{v} streams**{extra}")
    lines += [
        "",
        "Capacity model: streams = B / amortized tick time; one tick consumes "
        "1 s of audio per lane; whole-group re-anchor amortized once per "
        "eviction block (15 ticks). Tick times are the host's wall clock, "
        "each call ending with the read of its packed output. Pool dtypes: "
        "enc = the base form's encoder-row cache; bf16 = bf16 cross-KV "
        "pool; f8 = float8_e4m3fn cross-KV pool; f8d = f8 pool + weight-only "
        "f8 decoder linears (kept out of the peaks; its quality gate is "
        "`harness/ab_inc_exact.py --decoder-ab`). `SKIPPED` arms failed the "
        "resident-pool memory precheck, `FAILED OutOfMemoryError` arms ran "
        "out of card memory.",
    ]
    return "\n".join(lines) + "\n"


def e2e_section(path) -> list:
    """The measured end-to-end co-headline from an e2e summary at
    ``path``: the sustained counts and one row per run."""
    src = Path(path)
    d = json.loads(src.read_text())
    lines = [
        "",
        "## Measured end-to-end serving (same card, live sessions)",
        "",
        f"Source: `{src.name}` (harness/e2e_serving.py — real asyncio "
        "sessions through the scheduler: staggered admission, VAD, "
        "real-time audio pacing, word emission on the session clock; "
        f"model {d.get('model')}, {d.get('xkv_dtype')} pools, VAD "
        f"{d.get('vad')}, device {d.get('device')}).",
        "",
        f"- **{d['max_sustained_streams_at_500ms_p50']} streams at "
        "<= 500 ms p50 word-emission** (the north-star latency clause, "
        "measured end-to-end rather than tick-modeled)",
        f"- **{d['max_sustained_streams']} streams sustained** (drift "
        "criterion: emission lag not growing)",
        "",
        "| n | keep up | word p50 | word p95 | sched tick p50 |",
        "|---|---|---|---|---|",
    ]
    for r in d["runs"]:
        s = r["scheduler"]
        lines.append(
            f"| {r['n_sessions']} | {r['keep_up']} | "
            f"{r['word_emission_p50_ms']:.0f} ms | "
            f"{r['word_emission_p95_ms']:.0f} ms | {s['tick_ms_p50']:.0f} ms |"
        )
    lines += [
        "",
        "Each run measures `duration_s` seconds of real-time audio per session "
        "after its warm pour and shakeout; the scheduler's counters in the "
        "summary (`tick_phases`, `anchor_reasons`, lanes per tick) say where "
        "the e2e figure departs from the tick model.",
    ]
    return lines


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("capacity", help="a harness/capacity.py --out artifact")
    ap.add_argument("--e2e", default=None, help="a harness/e2e_serving.py --out summary")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    out = Path(args.out)
    if out.resolve() == JAX_PAGE:
        raise SystemExit(f"refusing to write {JAX_PAGE}: the JAX package's page")
    src = Path(args.capacity)
    text = render(json.loads(src.read_text()), src.name)
    if args.e2e:
        text += "\n".join(e2e_section(args.e2e)) + "\n"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
