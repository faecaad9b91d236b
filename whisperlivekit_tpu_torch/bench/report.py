"""Benchmark report: per-language/per-dataset aggregation + tables + JSON
(the port's copy of whisperlivekit_tpu/bench/report.py, host-only).

Role of reference benchmark/report.py — the offline quality dashboard:
WER / RTF / first-word latency grouped by (language, dataset), rendered as
aligned text tables and exported as JSON.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional


def _mean(xs: List[float]) -> Optional[float]:
    xs = [x for x in xs if x is not None]
    return sum(xs) / len(xs) if xs else None


def aggregate(results: List[Dict]) -> List[Dict]:
    """Per-(language, dataset) aggregate rows from per-sample results."""
    groups: Dict[tuple, List[Dict]] = defaultdict(list)
    for r in results:
        groups[(r.get("language", "?"), r.get("dataset", "local"))].append(r)
    rows = []
    for (lang, ds), items in sorted(groups.items()):
        rows.append({
            "language": lang,
            "dataset": ds,
            "n": len(items),
            "audio_s": round(sum(i.get("duration_s") or 0 for i in items), 1),
            "wer": _round(_mean([i.get("wer") for i in items]), 4),
            "rtf": _round(_mean([i.get("rtf") for i in items]), 3),
            "first_word_s": _round(_mean([i.get("first_word_latency") for i in items]), 3),
        })
    return rows


def _round(x, nd):
    return round(x, nd) if x is not None else None


def render_table(rows: List[Dict], columns: Optional[List[str]] = None) -> str:
    """Aligned fixed-width text table."""
    if not rows:
        return "(no results)"
    columns = columns or list(rows[0].keys())
    cells = [[_fmt(r.get(c)) for c in columns] for r in rows]
    widths = [max(len(c), *(len(row[i]) for row in cells)) for i, c in enumerate(columns)]
    sep = "  "
    head = sep.join(c.ljust(w) for c, w in zip(columns, widths))
    bar = sep.join("-" * w for w in widths)
    body = "\n".join(sep.join(v.rjust(w) for v, w in zip(row, widths)) for row in cells)
    return f"{head}\n{bar}\n{body}"


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.3f}".rstrip("0").rstrip(".") or "0"
    return str(v)


def build_report(results: List[Dict], config_summary: Optional[Dict] = None) -> Dict:
    """Full report document: per-sample results + per-language aggregates."""
    rows = aggregate(results)
    return {
        "config": config_summary or {},
        "per_language": rows,
        "results": results,
        "overall": {
            "n": len(results),
            "wer": _round(_mean([r.get("wer") for r in results]), 4),
            "rtf": _round(_mean([r.get("rtf") for r in results]), 3),
        },
    }


def print_report(report: Dict, file=None) -> None:
    import sys

    file = file or sys.stdout
    print(render_table(report["per_language"]), file=file)
    o = report["overall"]
    wer = f"{o['wer']:.2%}" if o.get("wer") is not None else "-"
    rtf = o.get("rtf")
    print(f"\noverall: n={o['n']} wer={wer} rtf={rtf}", file=file)


def save_report(report: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
