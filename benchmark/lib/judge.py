"""Whether what the timed path served is correct.

Once the window has closed and the program's state is freed, a sample of
sessions drawn from the seed (with the one that served the most tokens in
the window always in it) is replayed by the plain reference
(``reference/whisper_ref.py``) from its first tick. Every token that a tick
completed inside the window served is scored: the gap between the
reference's best filtered logit and the served token's (0 where the
reference puts the served token first). The number compared is the mean
gap over the scored tokens; its limit is the configuration's
(``check.mean_logit_gap``). The widest gap is reported beside it: it is
set by the rare near-ties that any rounding flips, and separates the
program from its own f8 path by less than three times.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np

from reference import whisper_ref as R

from .system import TickRecord


def ref_dims(cfg: dict) -> R.Dims:
    return R.Dims(n_mels=cfg["num_mel_bins"], n_audio_ctx=cfg["max_source_positions"],
                  d=cfg["d_model"], n_head=cfg["decoder_attention_heads"],
                  n_enc=cfg["encoder_layers"], n_dec=cfg["decoder_layers"],
                  n_vocab=cfg["vocab_size"], n_text_ctx=cfg["max_target_positions"])


def choose(records: List[TickRecord], w0: float, w1: float, seed: int, max_steps: int,
           tokens: int, max_sessions: int) -> List[int]:
    scored: Dict[int, int] = {}
    for r in records:
        if w0 <= r.t_done <= w1:
            n = R.served_count(_tick(r, True), max_steps)
            scored[r.sid] = scored.get(r.sid, 0) + n
    return pick(scored, seed, tokens, max_sessions)


def pick(scored: Dict[int, int], seed: int, tokens: int, max_sessions: int) -> List[int]:
    """Sessions to replay, from the tokens each served in the window: the
    one that served the most, then others in an order drawn from the seed
    until ``tokens`` are covered or ``max_sessions`` are chosen."""
    cands = sorted(s for s, n in scored.items() if n > 0)
    if not cands:
        return []
    longest = max(cands, key=lambda s: (scored[s], -s))
    rest = [s for s in cands if s != longest]
    order = list(np.random.default_rng([seed, 13]).permutation(len(rest)))
    chosen, total = [longest], scored[longest]
    for i in order:
        if total >= tokens or len(chosen) >= max_sessions:
            break
        chosen.append(rest[i])
        total += scored[rest[i]]
    return chosen


def _tick(r: TickRecord, scored: bool) -> R.Tick:
    return R.Tick(mode=r.mode, fed=r.fed, win=r.win, prefix=r.prefix, tail_start=r.tail_start,
                  write_start=r.write_start, refresh=r.refresh, new_tokens=r.new_tokens,
                  n_keep=r.n_keep, reason=r.reason, scored=scored)


def judge(records: List[TickRecord], w0: float, w1: float, seed: int, cfg: dict, state_dict,
          audio_of, tail_frames: int, vocab_file: Path, device, tokens: int = 400,
          max_sessions: int = 8) -> dict:
    """-> {"mean_logit_gap", "max_logit_gap", "p99_logit_gap", "flip_share",
    "tokens_compared", "sessions", "ticks_replayed"}.
    ``audio_of(sid, n)`` gives the first ``n`` samples a session was fed."""
    max_steps = int(cfg["serving"]["max_steps"])
    eot = int(cfg["eos_token_id"])
    chosen = choose(records, w0, w1, seed, max_steps, tokens, max_sessions)
    model = R.Whisper(state_dict, ref_dims(cfg), device)
    space = R.space_token(vocab_file)
    gaps: List[float] = []
    replayed = 0
    for sid in chosen:
        mine = sorted((r for r in records if r.sid == sid), key=lambda r: r.t_prep)
        bad = [r.mode for r in mine if not r.pooled or r.mode not in ("anchor", "inc")]
        if bad:
            raise ValueError(f"session {sid} ran ticks the reference does not follow: {sorted(set(bad))}")
        ticks = [_tick(r, w0 <= r.t_done <= w1) for r in mine]
        audio = audio_of(sid, max(r.fed for r in mine))
        out = R.replay_session(model, audio, ticks, tail_frames, max_steps, eot, space)
        gaps += out.gaps
        replayed += out.ticks
    return verdict(gaps, chosen, replayed)


def verdict(gaps: List[float], chosen: List[int], replayed: int) -> dict:
    """The judge's result over the scored tokens' logit gaps."""
    g = sorted(gaps)
    return {
        "max_logit_gap": g[-1] if g else None,
        "mean_logit_gap": sum(g) / len(g) if g else None,
        "p99_logit_gap": g[min(len(g) - 1, int(0.99 * len(g)))] if g else None,
        "flip_share": sum(x > 0 for x in g) / len(g) if g else None,
        "tokens_compared": len(gaps),
        "sessions": len(chosen),
        "ticks_replayed": replayed,
    }
