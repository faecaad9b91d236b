"""Train structured (non-random) Whisper weights on a synthetic aligned task
(port of scripts/train_structured_weights.py).

Random weights never emit end-of-text and attend everywhere at once, so a
serving run on them says little about decode steps or the AlignAtt gate.
This trainer builds weights that behave like a model: a deterministic
synthetic language of ~24 words, each a formant-synthesized syllable
(identity carried by an (F1, F2) pair), at a fixed one-second cadence in
30 s windows, labelled in Whisper's serving prompt format
(sot_sequence_including_notimestamps ... eot). Training is teacher-forced
CE (``parallel/train.py``) from an alignment-scaffolded init, plus
supervision of the alignment heads the serving gate reads; the eval pass
reports greedy word-token accuracy and cross-attention sharpness (mean max
probability of those heads' rows).

The data, the schedule and the numbers are the JAX script's. Differences:

- the mel comes from the port's ``audio/mel.py``, on the training device;
- the dataset is cached only under ``--cache-dir`` (none by default);
- ``--out`` is required, and ``--out-native`` writes the port's native
  directory (``dims.json`` + ``params.pt``, what ``wlk-torch serve
  --model-path`` loads) where JAX writes an orbax directory;
- the random init is ``torch.Generator`` seed 0, not ``PRNGKey(0)``;
- where no word of ``WORD_POOL`` is one token (the stand-in vocabulary of
  ``harness/vocab.py`` has no 4-byte token), the words come from
  ``STANDIN_POOL``.

The npz (flat ``/``-joined JAX keys, bf16, and ``__dims__``) is the JAX
script's format: its ``load_params``, ``scripts/bench_e2e_serving.py
--weights`` and this module's ``load_params`` read it.

Usage (on the card; ``main(argv, device="cpu")`` from Python on the CPU)::

    python -m whisperlivekit_tpu_torch.harness.train_structured --model base \\
        --steps 400 --out structured_base.npz [--out-native DIR] [--report R.json]
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

SR = 16000
WIN_S = 30.0

# Candidate words; filtered at runtime to those that encode to ONE BPE token
# with a leading space (so committed-token streams compare word-for-word).
WORD_POOL = [
    "the", "and", "one", "two", "red", "blue", "green", "stone", "river",
    "light", "dark", "wind", "fire", "water", "earth", "moon", "sun",
    "bird", "tree", "road", "house", "door", "hand", "eye", "night", "day",
    "gold", "iron", "north", "south", "east", "west",
]
# Two-letter words: one token with a leading space in Whisper's BPE and in
# the stand-in vocabulary, whose rank file holds every " xy" but no 4-byte
# string, so that WORD_POOL finds no word there.
STANDIN_POOL = [
    "go", "up", "in", "on", "to", "we", "me", "my", "no", "so", "do", "he",
    "be", "at", "by", "it", "is", "of", "or", "an", "as", "if", "us", "am",
]


def word_vocab(tok, n_max: int = 24):
    """(words, token_ids) for pool words that are single tokens with ' '."""

    def pick(pool):
        words, ids = [], []
        for w in pool:
            enc = tok.encode(" " + w)
            if len(enc) == 1:
                words.append(w)
                ids.append(enc[0])
            if len(words) >= n_max:
                break
        return words, ids

    words, ids = pick(WORD_POOL)
    return (words, ids) if words else pick(STANDIN_POOL)


# ---------------------------------------------------------------------------
# Syllable synthesis: each word is a fixed (F1, F2, pitch) triple on a grid.
# Analytic functions of absolute time so streamed chunks stitch continuously.
# ---------------------------------------------------------------------------


def _word_formants(widx: int, n_words: int):
    g1 = widx % 5
    g2 = widx // 5
    F1 = 300.0 + 120.0 * g1          # 300..780 Hz
    F2 = 1000.0 + 350.0 * g2         # 1000..2400+ Hz
    pitch = 95.0 + 8.0 * (widx % 3)
    return F1, F2, pitch


def syllable(widx: int, n: int, t_abs: np.ndarray, n_words: int) -> np.ndarray:
    """Render one word's syllable over absolute-time samples ``t_abs``."""
    from scipy import signal

    F1, F2, pitch = _word_formants(widx, n_words)
    src = signal.sawtooth(2 * np.pi * pitch * t_abs, width=0.9)
    y = src
    for F, bw in ((F1, 90.0), (F2, 120.0), (2800.0, 200.0)):
        r = np.exp(-np.pi * bw / SR)
        th = 2 * np.pi * F / SR
        y = signal.lfilter([1 - r], [1, -2 * r * np.cos(th), r * r], y)
    # raised-cosine onset/offset envelope over the event duration
    u = np.linspace(0, 1, n)
    env = np.sin(np.pi * np.clip(u, 0, 1)) ** 0.5
    return (y * env * 40.0).astype(np.float32)


EVENT_S = 0.55          # syllable duration
CADENCE_S = 1.0         # fixed word cadence


def schedule(seed: int, horizon_s: float, n_words: int, start_s: float = 0.25):
    """Deterministic event schedule [(t_start, word_idx), ...] up to horizon,
    one word per second at a constant offset: output position k then reads
    a fixed audio region, and which word fills it is read through
    cross-attention."""
    rng = np.random.default_rng(seed)
    out, t = [], start_s
    while t + EVENT_S < horizon_s:
        out.append((t, int(rng.integers(0, n_words))))
        t += CADENCE_S
    return out


def render_events(events, seconds: float, t0: float, n_words: int) -> np.ndarray:
    """Render the audio of ``events`` over [t0, t0+seconds) absolute time."""
    n = int(SR * seconds)
    out = 0.004 * np.random.default_rng(
        (int(round(t0 * SR)), 777)).standard_normal(n).astype(np.float32)
    for (ts, widx) in events:
        te = ts + EVENT_S
        if te <= t0 or ts >= t0 + seconds:
            continue
        ne = int(EVENT_S * SR)
        t_evt = ts + np.arange(ne) / SR      # absolute time over the event
        wav = syllable(widx, ne, t_evt, n_words)
        lo = int(round((ts - t0) * SR))
        src_lo = max(0, -lo)
        dst_lo = max(0, lo)
        dst_hi = min(n, lo + ne)
        if dst_hi > dst_lo:
            out[dst_lo:dst_hi] += wav[src_lo : src_lo + (dst_hi - dst_lo)]
    return out


def events_audio(seconds: float, seed: int, t0: float, n_words: int = 24,
                 horizon_s: float = 1e4) -> np.ndarray:
    """Streaming chunk API (chunks stitch)."""
    return render_events(
        schedule(seed, horizon_s, n_words), seconds, t0, n_words
    )


def events_words(seed: int, t_lo: float, t_hi: float, words,
                 horizon_s: float = 1e4):
    """Ground-truth words fully inside [t_lo, t_hi) (for WER-style checks)."""
    return [
        words[w] for (ts, w) in schedule(seed, horizon_s, len(words))
        if ts >= t_lo and ts + EVENT_S <= t_hi
    ]


# ---------------------------------------------------------------------------
# Training data
# ---------------------------------------------------------------------------


def _device(device) -> torch.device:
    from ..engine.core import default_device

    return torch.device(device) if device is not None else default_device()


def _mel_batch(audio: np.ndarray, n_mels: int, device=None) -> np.ndarray:
    """One batched log-mel call on the device."""
    from ..audio.mel import log_mel_spectrogram

    x = torch.from_numpy(np.ascontiguousarray(audio)).to(_device(device))
    return log_mel_spectrogram(x, n_mels=n_mels).float().cpu().numpy()


def make_batch(tok, word_ids, n_words, seeds, tok_len: int, n_mels: int, device=None):
    """(mel [B, n_mels, 3000] f32, tokens [B, tok_len] int32 with -1 pad)."""
    prompt = list(tok.sot_sequence_including_notimestamps)
    audio, toks = [], []
    for s in seeds:
        ev = schedule(int(s), WIN_S - 1.0, n_words)
        audio.append(render_events(ev, WIN_S, 0.0, n_words))
        seq = prompt + [word_ids[w] for (_, w) in ev] + [tok.eot]
        seq = seq[:tok_len] + [-1] * max(0, tok_len - len(seq))
        toks.append(seq)
    return _mel_batch(np.stack(audio), n_mels, device), np.asarray(toks, np.int32)


def build_dataset(tok, word_ids, n_words, n_batches: int, batch: int,
                  tok_len: int, n_mels: int, model: str,
                  cache_dir: Optional[str] = None, device=None) -> tuple:
    """Pregenerate the training set (the formant synthesis costs host time
    per example; the task is low-entropy, so batches repeat across epochs).
    Cached under ``cache_dir`` when given, as float16 mels."""
    cache = None
    if cache_dir:
        cache = Path(cache_dir) / (f"structured_ds_v2_{model}_{n_batches}x{batch}_"
                                   f"{n_words}w_{tok_len}t.npz")
        if cache.exists():
            z = np.load(cache)
            return z["mel"].astype(np.float32), z["tokens"]
    mels = np.zeros((n_batches, batch, n_mels, 3000), np.float16)
    toks = np.zeros((n_batches, batch, tok_len), np.int32)
    t0 = time.time()
    for i in range(n_batches):
        seeds = 10_000 + np.arange(batch) + batch * i
        m, t = make_batch(tok, word_ids, n_words, seeds, tok_len, n_mels, device)
        mels[i], toks[i] = m.astype(np.float16), t
        if i % 16 == 0:
            print(f"[data] batch {i}/{n_batches} ({time.time()-t0:.0f}s)", flush=True)
    if cache is not None:
        cache.parent.mkdir(parents=True, exist_ok=True)
        np.savez(cache, mel=mels, tokens=toks)
        print(f"[data] cached {cache}", flush=True)
    return mels.astype(np.float32), toks


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _flat(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, key)
        else:
            yield key, v


def save_params(params, dims_name: str, path) -> None:
    """The npz of the JAX script's ``save_params``: flat ``/``-joined keys
    of the JAX pytree and ``__dims__``; bfloat16 weights are stored as their
    raw 2-byte words, as numpy saves JAX's bfloat16 arrays."""
    from ..models.whisper import model as wm

    bf16 = params.dtype == torch.bfloat16
    flat = {}
    for key, a in _flat(wm.params_to_jax_numpy(params, params.dims)):
        # a bfloat16 value widened to float32 has 16 zero low bits
        flat[key] = (a.view(np.uint32) >> 16).astype(np.uint16).view("V2") if bf16 else a
    np.savez(path, __dims__=dims_name, **flat)


def load_params(path, device=None):
    """(bfloat16 ``Whisper`` module, dims name) from a ``save_params`` npz;
    ``device`` None means the card."""
    from ..models.whisper import model as wm
    from ..models.whisper.dims import MODEL_DIMS

    z = np.load(path)
    dims_name = str(z["__dims__"])
    tree: dict = {}
    for key in z.files:
        if key == "__dims__":
            continue
        a = z[key]
        if a.dtype.kind == "V" and a.dtype.itemsize == 2:  # bfloat16 words
            a = (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a
    model = wm.params_from_jax_numpy(tree, MODEL_DIMS[dims_name], dtype=torch.bfloat16,
                                     device=_device(device))
    return model, dims_name


# ---------------------------------------------------------------------------
# Evaluation and the alignment scaffold
# ---------------------------------------------------------------------------


@torch.no_grad()
def greedy_eval(params, dims, tok, word_ids, n_words, seeds, tok_len):
    """Teacher-free greedy decode accuracy + alignment-head sharpness, on
    ``params``' device and dtype (the encoder takes the flash kernel where it
    runs)."""
    from ..models.whisper import model as wm
    from ..models.whisper.dims import default_alignment_heads

    dev = params.device
    mel, tokens = make_batch(tok, word_ids, n_words, seeds, tok_len, dims.n_mels, dev)
    B = mel.shape[0]
    enc = wm.encode(params, torch.from_numpy(mel).to(dev), dims)
    xkv = wm.cross_kv(params, enc, dims)
    cache = wm.init_cache(dims, B, dtype=enc.dtype, width=tok_len + 8, device=dev)
    prompt = torch.tensor(
        [list(tok.sot_sequence_including_notimestamps)] * B, dtype=torch.long, device=dev)
    logits, _, cache = wm.decode(
        params, prompt, torch.zeros((B,), dtype=torch.long, device=dev), xkv, cache, dims)
    pos = torch.full((B,), prompt.shape[1], dtype=torch.long, device=dev)
    cur = torch.argmax(logits[:, -1], -1)
    outs = [cur]
    # sharpness over the upper-half-layer fallback head set: the trained
    # checkpoint is served with this set (published tables index heads of
    # the OpenAI checkpoints, meaningless for fresh weights)
    align = wm.AlignSpec.from_pairs(default_alignment_heads(dims), device=dev)
    sharp = []
    for _ in range(tok_len - prompt.shape[1]):
        logits, aprob, cache = wm.decode(params, cur[:, None], pos, xkv, cache, dims, align)
        if aprob is not None:
            sharp.append(float(torch.mean(torch.amax(aprob, dim=-1))))
        cur = torch.argmax(logits[:, -1], -1)
        outs.append(cur)
        pos = pos + 1
    hyp = torch.stack(outs, 1).cpu().numpy()  # [B, S]
    n_ok = n_tot = 0
    P = prompt.shape[1]
    for b in range(B):
        ref = [t for t in tokens[b][P:] if t >= 0]
        h = []
        for t in hyp[b]:
            h.append(int(t))
            if t == tok.eot:
                break
        n_tot += len(ref)
        n_ok += sum(1 for x, y in zip(h, ref) if x == y)
    return (n_ok / max(n_tot, 1),
            float(np.mean(sharp)) if sharp else None)


@torch.no_grad()
def align_scaffold(params, dims, prompt_len: int):
    """Alignment-scaffolded init, in place: from-scratch encoder-decoder ASR
    spends thousands of steps discovering monotonic alignment before any
    word becomes learnable, so start it aligned:

    - decoder pos_emb row p := the encoder's sinusoid row at the audio frame
      of the word that position p reads (a pure function of p at the fixed
      cadence);
    - tie each cross-attention's q/k projections: for W ~ N(0, 1/d),
      W W^T ~ I, so score(s, t) ~ pos_s . enc_t, and enc_t keeps its
      additive sinusoid through the residual stream: cross-attention starts
      pointed at the right frames and training sharpens it;
    - tie the encoder self-attention's q/k too, so encoder attention starts
      local (word identity is local)."""
    from ..models.whisper.model import sinusoids

    d = dims.n_text_state
    pe = sinusoids(dims.n_audio_ctx, d)
    pos = np.zeros((dims.n_text_ctx, d), np.float32)
    for p in range(dims.n_text_ctx):
        # row p holds input token w_j for j = p - prompt_len; the AlignAtt
        # gate reads THAT row's attention as "where is w_j's audio"
        j = p - prompt_len
        fr = int((0.25 + j * CADENCE_S + EVENT_S / 2) * 50)
        if j >= 0 and fr < dims.n_audio_ctx:
            pos[p] = pe[fr]
    dec = params.decoder
    dec.pos_emb.copy_(torch.from_numpy(pos))
    for blk in dec.blocks:
        blk.cross.q.weight.copy_(blk.cross.k.weight)
    for blk in params.encoder.blocks:
        blk.attn.q.weight.copy_(blk.attn.k.weight)
    return params


def align_windows(prompt_len: int, tok_len: int, n_events: int):
    """Per-input-row supervision windows (lo, hi) [S] int32, -1 = none.

    Input row s holds token ``inputs[s]``; for s = prompt_len + j that is
    word j, whose query row the AlignAtt gate reads: supervise it to the
    frames of word j's audio event (fixed cadence: t = 0.25 + j)."""
    S = tok_len - 1
    lo = np.full((S,), -1, np.int32)
    hi = np.full((S,), -1, np.int32)
    for j in range(n_events):
        s = prompt_len + j
        if s >= S:
            break
        lo[s] = int((0.25 + j * CADENCE_S) * 50)
        hi[s] = min(int((0.25 + j * CADENCE_S + EVENT_S) * 50) + 1, 1500)
    return lo, hi


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="base")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dataset-batches", type=int, default=64,
                    help="pregenerated batches cycled across epochs")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--tok-len", type=int, default=48)
    ap.add_argument("--n-words", type=int, default=24)
    ap.add_argument("--no-scaffold", action="store_true",
                    help="disable the alignment-scaffolded init")
    ap.add_argument("--align-weight", type=float, default=1.0,
                    help="weight of the attention-supervision loss on the "
                    "serving gate's head set (0 disables)")
    ap.add_argument("--cache-dir", default=None, help="cache the generated dataset here")
    ap.add_argument("--out", required=True, help="the npz (the JAX script's format)")
    ap.add_argument("--out-native", default=None,
                    help="also write the port's native checkpoint dir "
                    "(loadable via --model-path)")
    ap.add_argument("--report", default=None, help="write a JSON training report")
    return ap


def main(argv: Optional[List[str]] = None, device=None) -> dict:
    """Train, evaluate and save; returns the report (with every step's
    loss). ``device`` None means the card."""
    args = build_parser().parse_args(argv)
    from ..models.whisper import model as wm
    from ..models.whisper.dims import MODEL_DIMS, default_alignment_heads
    from ..models.whisper.load import save_native
    from ..models.whisper.tokenizer import get_tokenizer
    from ..parallel import train as T

    dev = _device(device)
    dims = MODEL_DIMS[args.model]
    tok = get_tokenizer(not args.model.endswith(".en"), language="en", task="transcribe")
    words, word_ids = word_vocab(tok, args.n_words)
    n_words = len(words)
    print(f"[train] {args.model}: {n_words}-word vocab: {words}", flush=True)

    sched = T.warmup_cosine_decay_schedule(
        0.0, args.lr, warmup_steps=min(200, args.steps // 10),
        decay_steps=args.steps, end_value=args.lr * 0.05,
    )
    tx = T.make_optimizer(sched)
    state = T.init_train_state(dims, None, tx, dtype=torch.float32, device=dev)
    prompt_len = len(tok.sot_sequence_including_notimestamps)
    if not args.no_scaffold:
        align_scaffold(state.params, dims, prompt_len)

    mels, tokens_all = build_dataset(
        tok, word_ids, n_words, args.dataset_batches, args.batch,
        args.tok_len, dims.n_mels, args.model, args.cache_dir, dev)

    align_args = ()
    if args.align_weight > 0:
        # supervise the exact head set the serving gate reads for fresh
        # checkpoints (upper-half layers, all heads)
        align = wm.AlignSpec.from_pairs(default_alignment_heads(dims), device=dev)
        n_events = len(schedule(0, WIN_S - 1.0, n_words))
        lo, hi = align_windows(prompt_len, args.tok_len, n_events)
        align_args = (align, torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev),
                      float(args.align_weight))
    t0 = time.time()
    losses = []
    for i in range(args.steps):
        j = i % args.dataset_batches
        state, loss = T.train_step(
            state, torch.from_numpy(mels[j]).to(dev), torch.from_numpy(tokens_all[j]).to(dev),
            dims, tx, *align_args)
        losses.append(float(loss))
        if i % 50 == 0 or i == args.steps - 1:
            print(f"[train] step {i}: loss {losses[-1]:.4f} ({time.time()-t0:.0f}s)", flush=True)
    train_s = time.time() - t0

    # eval on held-out seeds, in bf16
    params_bf16 = copy.deepcopy(state.params)
    for p in params_bf16.parameters():
        p.grad = None
    params_bf16 = params_bf16.to(torch.bfloat16).requires_grad_(False)
    acc, sharp = greedy_eval(
        params_bf16, dims, tok, word_ids, n_words,
        seeds=90_000 + np.arange(8), tok_len=args.tok_len)
    print(f"[train] greedy token accuracy (held-out): {acc:.3f}  "
          f"align sharpness: {sharp}", flush=True)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    save_params(params_bf16, args.model, args.out)
    print(f"[train] saved {args.out}", flush=True)
    if args.out_native:
        save_native(params_bf16, dims, args.out_native)
        print(f"[train] saved native checkpoint {args.out_native}", flush=True)
    report = {
        "model": args.model, "steps": args.steps, "batch": args.batch,
        "lr": args.lr, "n_words": n_words, "words": words,
        "loss_first": losses[0], "loss_last": losses[-1],
        "loss_p10_last": float(np.mean(losses[-10:])),
        "greedy_token_accuracy": round(acc, 4),
        "align_sharpness_mean_maxp": sharp,
        "train_s": round(train_s, 1),
        "ms_per_step": round(1e3 * train_s / max(args.steps, 1), 2),
        "wall_s": round(time.time() - t0, 1),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        "out": args.out,
        "losses": losses,
    }
    if args.report:
        Path(args.report).write_text(json.dumps(report, indent=2) + "\n")
    return report


if __name__ == "__main__":
    main()
