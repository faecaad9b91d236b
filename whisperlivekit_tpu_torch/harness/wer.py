"""Text normalization + WER (reference metrics.py:12-82 parity, pure python).

``compute_wer(..., english=True)`` applies the OpenAI EnglishTextNormalizer
(harness/normalizers.py) so numbers are comparable with published Whisper
WERs — the reference benchmark methodology (round-1 VERDICT item 5/6).
A host copy of whisperlivekit_tpu/harness/wer.py.
"""

from __future__ import annotations

import re
import unicodedata
from functools import lru_cache
from typing import Dict


def normalize_text(text: str) -> str:
    """Lowercase, NFC-normalize, strip punctuation, collapse whitespace."""
    text = unicodedata.normalize("NFC", text.lower())
    text = re.sub(r"[^\w\s\-']", " ", text)
    return re.sub(r"\s+", " ", text).strip()


@lru_cache(maxsize=1)
def _english_normalizer():
    from .normalizers import EnglishTextNormalizer

    return EnglishTextNormalizer()


def compute_wer(reference: str, hypothesis: str, english: bool = False) -> Dict:
    """Word-level Levenshtein WER with sub/ins/del breakdown."""
    norm = _english_normalizer() if english else normalize_text
    ref = norm(reference).split()
    hyp = norm(hypothesis).split()
    n, m = len(ref), len(hyp)
    if n == 0:
        return {
            "wer": 0.0 if m == 0 else float(m),
            "substitutions": 0,
            "insertions": m,
            "deletions": 0,
            "ref_words": 0,
            "hyp_words": m,
        }

    # rows: (distance, subs, ins, dels)
    prev = [(j, 0, j, 0) for j in range(m + 1)]
    for i in range(1, n + 1):
        cur = [(i, 0, 0, i)] + [None] * m
        for j in range(1, m + 1):
            if ref[i - 1] == hyp[j - 1]:
                cur[j] = prev[j - 1]
            else:
                s = prev[j - 1]
                a = cur[j - 1]
                d = prev[j]
                cand = (
                    (s[0] + 1, s[1] + 1, s[2], s[3]),
                    (d[0] + 1, d[1], d[2], d[3] + 1),
                    (a[0] + 1, a[1], a[2] + 1, a[3]),
                )
                cur[j] = min(cand, key=lambda x: x[0])
        prev = cur

    dist, subs, ins, dels = prev[m]
    return {
        "wer": dist / n,
        "substitutions": subs,
        "insertions": ins,
        "deletions": dels,
        "ref_words": n,
        "hyp_words": m,
    }
