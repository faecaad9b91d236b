"""Inputs for the decode step's DRY penalty (``ops/dry.py``, kernel K4),
made from a seed: token rows planted with every case the penalty's rule
distinguishes, and a greedy decode loop in which the penalty decides the
tokens. ``tests/test_torch_dry_kernel.py`` and ``chip_smoke.py`` use both.
"""

from __future__ import annotations

import numpy as np
import torch

EOT = 50257

#: one kind of planted row per lane, in turn (see planted_rows)
KINDS = ("run_20", "run_49", "run_120", "empty", "short", "last_special", "shared_equal",
         "shared_unequal", "wrap", "special_in_chain", "next_special", "one_token", "small_alphabet")


def _plant(row, end, i, r, nxt):
    """Make position i a candidate whose match run behind it is r long and
    whose next token is nxt: copy the suffix tokens[end-r .. end] to
    [i-r .. i], break the match one further back."""
    row[i - r: i + 1] = row[end - r: end + 1]
    row[i + 1] = nxt
    if i - r - 1 >= 0:
        row[i - r - 1] = row[end - r - 1] + 1 if row[end - r - 1] < 40000 else 7


def planted_rows(B: int, V: int, seed: int, L: int = 448) -> tuple:
    """(logits [B,V] f32, tokens [B,L] int64, cur_len [B] int64) on the CPU:
    row b is of kind KINDS[b % len(KINDS)] over random text ids (the planted
    positions need L of 400 or more, and V above 4242): runs behind one
    candidate under, at and over the 50-token cap; an empty lane (its last
    token wraps to column L-1); a lane of 4 tokens; a special last token;
    two candidates sharing a next id at equal and at unequal lengths;
    cur_len L+1 (the suffix ends at column 0, a candidate at L-1); a special
    id inside a run; a special next token; one token over the whole row; a
    four-token alphabet. The logits hold -inf (suppressed ids) and -0.0."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 50000, (B, L))
    cur_len = np.zeros(B, np.int64)
    for b in range(B):
        kind, row = KINDS[b % len(KINDS)], tokens[b]
        end = L - 60 - (b % 7)
        cur_len[b] = end + 1
        if kind.startswith("run_"):
            r = int(kind[4:])
            _plant(row, end, r + 5, r, 123)
        elif kind == "empty":
            _plant(row, L - 1, 200, 10, 5)
            cur_len[b] = 0
        elif kind == "short":
            row[:4] = [9, 9, 9, 9]
            cur_len[b] = 4
        elif kind == "last_special":
            _plant(row, end, 100, 20, 77)
            row[end] = row[100] = EOT + 3
        elif kind == "shared_equal":
            _plant(row, end, 60, 12, 4242)
            _plant(row, end, 160, 12, 4242)
        elif kind == "shared_unequal":  # lengths 6 and 10 on one id, 4 on another
            _plant(row, end, 60, 5, 4242)
            _plant(row, end, 160, 9, 4242)
            _plant(row, end, 260, 3, 31)
        elif kind == "wrap":
            cur_len[b] = L + 1
            row[L - 8:] = 555
            row[0] = 555
            row[1] = 556
        elif kind == "special_in_chain":
            _plant(row, end, 150, 30, 99)
            row[150 - 10] = row[end - 10] = EOT + 1
        elif kind == "next_special":
            _plant(row, end, 150, 30, EOT)
        elif kind == "one_token":
            row[:] = 321
        elif kind == "small_alphabet":
            row[:] = rng.integers(0, 4, L)
    logits = rng.standard_normal((B, V)).astype(np.float32)
    logits[:, rng.integers(0, V, 64)] = -np.inf
    logits[:, 11] = -0.0
    return torch.from_numpy(logits), torch.from_numpy(tokens), torch.from_numpy(cur_len)


def greedy_loop_args(B: int, dims, p_max: int, seed: int, device) -> dict:
    """Keyword arguments of ``alignatt._tick_core`` (all but the model and
    ``max_steps``) for one greedy decode loop at ``dims``' widths in which
    the DRY penalty decides the tokens: random encoder rows (bf16), three
    text ids allowed, each lane's prefix (p_max - 8 - b % 8 tokens) cycling
    them from its own phase, and nothing (gate, rewind, no-speech, end of
    text, the cap) that stops a lane before ``max_steps``."""
    g = torch.Generator(device=device).manual_seed(seed)
    enc = torch.randn(B, dims.n_audio_ctx, dims.n_audio_state, generator=g, device=device)
    allowed = torch.tensor([400, 401, 402])
    prefix = torch.full((B, p_max), EOT, dtype=torch.int32)
    prefix_len = torch.tensor([p_max - 8 - b % 8 for b in range(B)], dtype=torch.int32)
    for b in range(B):
        n = int(prefix_len[b])
        prefix[b, :n] = allowed[(torch.arange(n) + b) % 3]
    suppress = torch.full((dims.n_vocab,), float("-inf"))
    suppress[allowed] = 0.0
    full = lambda v, dt: torch.full((B,), v, dtype=dt, device=device)  # noqa: E731
    return dict(
        enc=enc.to(torch.bfloat16), prefix=prefix.to(device), prefix_len=prefix_len.to(device),
        sot_index=full(0, torch.int32), content_frames=full(dims.n_audio_ctx, torch.int32),
        last_attend=full(-200, torch.int32), is_last=full(False, torch.bool),
        max_new=full(50, torch.int32), suppress_mask=suppress.to(device),
        align_layers=torch.tensor([2, 3], device=device), align_heads=torch.tensor([4, 7], device=device),
        frame_threshold=-100000, rewind_threshold=100000, nonspeech_prob=2.0,
        active_in=full(True, torch.bool), cif_w=torch.zeros(dims.n_audio_state, device=device),
        cif_b=0.0, dims=dims, p_max=p_max, eot=EOT, ts_begin=50365, no_speech_tok=50363,
        space_tok=220,
    )
