"""A/B of the port's incremental encode against the exact full re-encode.

    python -m whisperlivekit_tpu_torch.harness.ab_inc_exact --models base large-v3 --minutes 5 [--out FILE]
    python -m whisperlivekit_tpu_torch.harness.ab_inc_exact --models large-v3 --decoder-ab [--xkv-dtype f8]

Port of the repository's ``scripts/ab_inc_exact.py``. The default serving
mode approximates the reference's exact re-encode (the reference's
simul_whisper recomputes the encoder over the full audio window every
chunk): each inc tick re-encodes only a window tail of ``enc_tail_frames``
frames with tail-local attention against cached anchor-time frames
(``alignatt_tick_inc*``), and a full re-anchor runs once per eviction
block. Three sessions are fed the same 1 s chunks every tick, and the
approximation is bounded three ways:

1. **Encoder-output divergence**: after every ``--enc-every``-th inc tick,
   the inc session's cached encoder rows against an exact full-window
   encode of the same audio (a twin session forced to anchor every tick
   by clearing its ``_enc_key``), over the window's valid frames: max and
   mean abs error, and the mean relative to the exact frames' RMS.
2. **Attention-gate frame flips**: the most-attended frame
   (``last_attend``, the gate's input) of the inc session against a
   legacy-program session (no pools: the full window every tick): flip
   rate and |delta frames|.
3. **Committed-token agreement** between those two sessions (difflib
   ratio and token error rate) over the whole stream.

``--decoder-ab`` compares instead two production inc sessions whose
decoders differ only in the weights' dtype: bf16 linears against
``quantize_decoder_f8`` (the f8d capacity arm's quality gate).

Weights are random from a seed (a ``torch.Generator`` on the device; the
numbers differ from JAX's ``PRNGKey``) unless ``--weights`` names a structured checkpoint
(``harness/train_structured.py``'s npz, the JAX script's format), which
takes the fallback alignment heads (``model_name=None``); absolute WER on
random weights means nothing, mode against mode does. With ``--weights``
the audio is that checkpoint's event stream and ``vs_truth`` holds each
arm's agreement with the stream's words. The flags, defaults and result
keys are the JAX script's; the output file adds ``device`` (the card's
name and power limit). ``main(argv, device="cpu")`` runs on the CPU
(tests); without ``device`` it needs CUDA. Imports no JAX.
"""

from __future__ import annotations

import argparse
import difflib
import json
import time
from pathlib import Path

import numpy as np
import torch


def build_engine(model: str, frame_threshold: int, xkv_dtype: str, decoder_dtype: str = "bf16",
                 weights: str = None, enc_tail_frames: int = 0, device=None):
    """bf16 weights of ``model`` (random, drawn on ``device`` from seed 0,
    or a structured npz) on ``device``, the decoder quantized to f8 under
    ``decoder_dtype="f8"``."""
    from ..models.whisper import model as wm
    from ..models.whisper.dims import MODEL_DIMS
    from ..models.whisper.tokenizer import get_tokenizer
    from ..streaming.alignatt import AlignAttConfig, AlignAttEngine
    from .capacity import resolve_device

    device = resolve_device(device)
    dims = MODEL_DIMS[model]
    if weights:
        # a structured checkpoint's attention is trained: the published
        # alignment heads (which name OpenAI checkpoints' heads) do not apply
        from .train_structured import load_params

        params, dims_name = load_params(weights, device=device)
        assert dims_name == model, (dims_name, model)
        model_name = None
    else:
        params = wm.init_params(dims, torch.Generator(device).manual_seed(0), torch.bfloat16, device)
        model_name = model
    if decoder_dtype == "f8":
        params = wm.quantize_decoder_f8(params)
    tok = get_tokenizer(True, language="en", task="transcribe")
    cfg = AlignAttConfig(language="en", frame_threshold=frame_threshold, xkv_cache_dtype=xkv_dtype,
                         enc_tail_frames=enc_tail_frames)
    # model_name routes to the published alignment-head table (10 pairs at
    # large-v3); without it the fallback takes every head of the upper half
    # of the decoder (320 pairs at large-v3), a ~30x larger gate recompute
    return AlignAttEngine(params, dims, tok, cfg, model_name=model_name)


def make_inc_session(engine, group_width: int = 1):
    """A session wired the way the scheduler wires serving lanes: an audio
    pool and an encoder-row pool, and for d >= 1280 models a group-resident
    cross-KV pool, all on the engine's device."""
    from ..ops.f8 import F8
    from ..streaming.alignatt import AlignAttSession, AudioPool, EncPool, XKVAllocator

    s = AlignAttSession(engine)
    s.pool = AudioPool(capacity=4, device=engine.device)
    dtype = engine.model.dtype
    s.enc_pool = EncPool(3, engine.dims, dtype=dtype, device=engine.device)
    cfg = engine.cfg
    use_xkv = (cfg.xkv_cache == "auto" and engine.dims.n_audio_state >= 1280) or cfg.xkv_cache is True
    if use_xkv and not engine.use_cif:
        xdt = F8 if cfg.xkv_cache_dtype == "f8" else dtype
        s.xkv_alloc = XKVAllocator.for_engine(engine, group_width, dtype=xdt)
    return s


def enc_err_fn():
    """(pool_a, lane_a, pool_c, lane_c, win) -> [max |a - c|, mean |a - c|,
    RMS of c] in f32 over the window's first ``win`` frames, on the pools'
    device: one read of three floats per sample."""

    @torch.no_grad()
    def err(pool_a, lane_a, pool_c, lane_c, win):
        a = pool_a[lane_a].float()
        c = pool_c[lane_c].float()
        mask = (torch.arange(a.shape[0], device=a.device) < win)[:, None].float()
        d = (a - c).abs() * mask
        n = torch.clamp(mask.sum() * a.shape[1], min=1.0)
        rms = torch.sqrt(((c * mask) ** 2).sum() / n)
        return torch.stack([d.max(), d.sum() / n, rms])

    return err


def _tok_agreement(a, b):
    sm = difflib.SequenceMatcher(a=a, b=b, autojunk=False)
    matched = sum(bl.size for bl in sm.get_matching_blocks())
    return matched / max(len(a), len(b), 1)


def _audio_source(audio_kind: str):
    if audio_kind == "events":
        from .train_structured import events_audio

        return lambda sec, t: events_audio(sec, seed=7, t0=t)
    from .e2e_serving import speech_like

    return lambda sec, t: speech_like(sec, seed=7, t0=t)


def _truth_tokens(tok, n_ticks: int) -> list:
    """The event stream's words over the run, as tokens."""
    from .train_structured import events_words, word_vocab

    words, _ = word_vocab(tok)
    ref_toks = []
    for w in events_words(7, 0.0, float(n_ticks), words):
        ref_toks.extend(tok.encode(" " + w))
    return ref_toks


def run_model(model: str, minutes: float, frame_threshold: int, xkv_dtype: str, enc_every: int,
              weights: str = None, audio_kind: str = "speech", reset_every_s: int = 0,
              enc_tail_frames: int = 0, device=None) -> dict:
    """The inc-vs-exact comparison over ``minutes`` of 1 s ticks.
    ``reset_every_s > 0`` re-creates all three sessions every N seconds:
    structured checkpoints are trained on fixed-format 30 s windows, and a
    free-scrolling session leaves that format after the first eviction in
    both arms, so resetting at the training window keeps the truth
    agreement a measure of the encode mode."""
    from ..streaming.alignatt import AlignAttSession, run_tick_batch

    engine = build_engine(model, frame_threshold, xkv_dtype, weights=weights,
                          enc_tail_frames=enc_tail_frames, device=device)
    tok = engine.tokenizer
    s_inc = make_inc_session(engine)          # the serving incremental mode
    s_exact = AlignAttSession(engine)         # the legacy full window (exact)
    s_anchor = make_inc_session(engine)       # exact encoder rows for (1)
    err = enc_err_fn()

    n_ticks = int(minutes * 60)
    toks_inc, toks_exact = [], []
    attend_inc, attend_exact = [], []
    keep_inc = keep_exact = 0
    enc_samples = []   # (tick, max_err, mean_err, ref_rms)
    mode_counts = {"inc": 0, "anchor": 0}
    gen = _audio_source(audio_kind)
    t0 = time.perf_counter()
    for i in range(n_ticks):
        if reset_every_s and i and i % reset_every_s == 0:
            s_inc = make_inc_session(engine)
            s_exact = AlignAttSession(engine)
            s_anchor = make_inc_session(engine)
        audio = gen(1.0, float(i))
        rows = {}
        for name, s in (("inc", s_inc), ("exact", s_exact), ("anchor", s_anchor)):
            s.insert_audio(audio.copy())
            if name == "anchor":
                s._enc_key = None  # forces the exact full-window anchor program
            ti = s.prepare_tick(False)
            if ti is None:
                rows[name] = None
                continue
            if name == "inc" and ti.enc_mode in mode_counts:
                mode_counts[ti.enc_mode] += 1
            outs = run_tick_batch(engine, [ti], tok, pool=s.pool, enc_pool=s.enc_pool, xkv=s.xkv_alloc)
            words = s.finish_tick(ti, outs[0])
            rows[name] = (ti, outs[0], words)
        if rows["inc"] is not None and rows["exact"] is not None:
            attend_inc.append(rows["inc"][1].last_attend)
            attend_exact.append(rows["exact"][1].last_attend)
            keep_inc += rows["inc"][1].n_keep
            keep_exact += rows["exact"][1].n_keep
            for t in rows["inc"][2]:
                toks_inc.extend(tok.encode(t.text))
            for t in rows["exact"][2]:
                toks_exact.extend(tok.encode(t.text))
        if (
            rows["inc"] is not None
            and rows["anchor"] is not None
            and i % enc_every == 0
            and rows["inc"][0].enc_mode == "inc"
        ):
            win = rows["inc"][0].content_frames
            m = err(s_inc.enc_pool.pool, s_inc.enc_lane, s_anchor.enc_pool.pool, s_anchor.enc_lane,
                    win).tolist()
            enc_samples.append((i, m[0], m[1], m[2]))
    wall = time.perf_counter() - t0

    flips = sum(1 for a, b in zip(attend_inc, attend_exact) if a != b)
    deltas = [abs(a - b) for a, b in zip(attend_inc, attend_exact)]
    sm = difflib.SequenceMatcher(a=toks_inc, b=toks_exact, autojunk=False)
    matched = sum(bl.size for bl in sm.get_matching_blocks())
    denom = max(len(toks_inc), len(toks_exact), 1)
    truth = None
    if audio_kind == "events":
        # with trained weights a per-mode accuracy against the stream's words
        ref_toks = _truth_tokens(tok, n_ticks)
        truth = {
            "n_truth_tokens": len(ref_toks),
            "inc_vs_truth_agreement": round(_tok_agreement(toks_inc, ref_toks), 4),
            "exact_vs_truth_agreement": round(_tok_agreement(toks_exact, ref_toks), 4),
        }
    max_errs = [m for (_, m, _, _) in enc_samples]
    mean_errs = [m for (_, _, m, _) in enc_samples]
    rms = [r for (_, _, _, r) in enc_samples]
    return {
        "model": model,
        "minutes": minutes,
        "frame_threshold": frame_threshold,
        "weights": weights,
        "audio": audio_kind,
        "reset_every_s": reset_every_s or None,
        "enc_tail_frames": enc_tail_frames or "default",
        "xkv_dtype": xkv_dtype if s_inc.xkv_alloc is not None else None,
        "n_ticks_compared": len(attend_inc),
        "vs_truth": truth,
        "inc_tick_mix": mode_counts,
        "encoder_divergence": {
            "n_samples": len(enc_samples),
            "max_abs_err": max(max_errs) if max_errs else None,
            "p50_max_abs_err": float(np.median(max_errs)) if max_errs else None,
            "mean_abs_err": float(np.mean(mean_errs)) if mean_errs else None,
            "exact_frame_rms": float(np.mean(rms)) if rms else None,
            "mean_rel_err": float(np.mean(mean_errs) / np.mean(rms)) if rms else None,
        },
        "gate_frames": {
            "flip_rate": round(flips / max(len(attend_inc), 1), 4),
            "mean_abs_delta_frames": round(float(np.mean(deltas)), 2) if deltas else None,
            "p95_abs_delta_frames": round(float(np.quantile(deltas, 0.95)), 1) if deltas else None,
        },
        "committed_tokens": {
            "n_inc": len(toks_inc),
            "n_exact": len(toks_exact),
            "agreement": round(matched / denom, 4),
            "token_error_rate": round(1.0 - matched / denom, 4),
            "kept_per_tick_inc": round(keep_inc / max(len(attend_inc), 1), 2),
            "kept_per_tick_exact": round(keep_exact / max(len(attend_inc), 1), 2),
        },
        "wall_s": round(wall, 1),
    }


def run_decoder_ab(model: str, minutes: float, frame_threshold: int, xkv_dtype: str, weights: str = None,
                   audio_kind: str = "speech", reset_every_s: int = 0, device=None) -> dict:
    """The f8d capacity arm's quality gate: two serving inc sessions fed the
    same audio, one with bf16 decoder linears and one with
    ``quantize_decoder_f8``'s, compared on the gate frame and the committed
    tokens. Both run the same encode path and cross-KV dtype."""
    from ..streaming.alignatt import run_tick_batch

    eng_a = build_engine(model, frame_threshold, xkv_dtype, "bf16", weights, device=device)
    eng_b = build_engine(model, frame_threshold, xkv_dtype, "f8", weights, device=device)
    tok = eng_a.tokenizer
    arms = {"bf16": (eng_a, make_inc_session(eng_a)), "f8": (eng_b, make_inc_session(eng_b))}

    gen = _audio_source(audio_kind)
    n_ticks = int(minutes * 60)
    toks = {"bf16": [], "f8": []}
    attend = {"bf16": [], "f8": []}
    t0 = time.perf_counter()
    for i in range(n_ticks):
        if reset_every_s and i and i % reset_every_s == 0:
            arms = {name: (eng, make_inc_session(eng)) for name, (eng, _) in arms.items()}
        audio = gen(1.0, float(i))
        for name, (eng, s) in arms.items():
            s.insert_audio(audio.copy())
            ti = s.prepare_tick(False)
            if ti is None:
                continue
            outs = run_tick_batch(eng, [ti], tok, pool=s.pool, enc_pool=s.enc_pool, xkv=s.xkv_alloc)
            words = s.finish_tick(ti, outs[0])
            attend[name].append(outs[0].last_attend)
            for t in words:
                toks[name].extend(tok.encode(t.text))
    wall = time.perf_counter() - t0

    pairs = list(zip(attend["bf16"], attend["f8"]))
    flips = sum(1 for a, b in pairs if a != b)
    sm = difflib.SequenceMatcher(a=toks["bf16"], b=toks["f8"], autojunk=False)
    matched = sum(bl.size for bl in sm.get_matching_blocks())
    denom = max(len(toks["bf16"]), len(toks["f8"]), 1)
    truth = None
    if audio_kind == "events":
        ref_toks = _truth_tokens(tok, n_ticks)
        truth = {
            "bf16_vs_truth_agreement": round(_tok_agreement(toks["bf16"], ref_toks), 4),
            "f8_vs_truth_agreement": round(_tok_agreement(toks["f8"], ref_toks), 4),
        }
    return {
        "comparison": "decoder_bf16_vs_f8",
        "model": model,
        "minutes": minutes,
        "weights": weights,
        "audio": audio_kind,
        "reset_every_s": reset_every_s or None,
        "xkv_dtype": xkv_dtype,
        "vs_truth": truth,
        "n_ticks": len(pairs),
        "gate_flip_rate": round(flips / max(len(pairs), 1), 4),
        "committed_tokens": {
            "n_bf16": len(toks["bf16"]),
            "n_f8": len(toks["f8"]),
            "agreement": round(matched / denom, 4),
        },
        "wall_s": round(wall, 1),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--models", nargs="+", default=["base", "large-v3"])
    ap.add_argument("--minutes", type=float, default=5.0)
    ap.add_argument("--frame-thresholds", type=int, nargs="+", default=None,
                    help="sweep: one full inc-vs-exact run per threshold")
    ap.add_argument("--weights", default=None,
                    help="structured checkpoint (.npz) from harness/train_structured.py; "
                    "audio defaults to the paired event stream")
    ap.add_argument("--audio", default=None, choices=["speech", "events"],
                    help="audio source (default: events when --weights is given, speech otherwise)")
    ap.add_argument("--frame-threshold", type=int, default=1,
                    help="permissive gate so tokens flow under random weights "
                    "(gate-frame stats are threshold-independent)")
    ap.add_argument("--xkv-dtype", default="bf16", choices=["bf16", "f8"],
                    help="bf16 isolates the tail-encode approximation; f8 adds the storage-dtype "
                    "drift on top")
    ap.add_argument("--enc-every", type=int, default=5, help="sample encoder divergence every K ticks")
    ap.add_argument("--decoder-ab", action="store_true",
                    help="run the decoder bf16-vs-f8 quality gate instead of the inc-vs-exact comparison")
    ap.add_argument("--enc-tail-frames", type=int, default=0,
                    help="inc-mode tail re-encode length (enc frames); 0 = model default. The quality "
                    "dial: a longer tail shrinks the inc approximation at linear encode cost")
    ap.add_argument("--reset-every", type=int, default=0,
                    help="re-create sessions every N seconds (structured checkpoints are trained on "
                    "fixed 30 s windows; pass 30 to keep every window in-format so truth agreement "
                    "measures the encode mode, not format drift)")
    ap.add_argument("--out", default=None)
    return ap


def main(argv=None, device=None) -> int:
    from .capacity import card_label, resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(device)
    audio_kind = args.audio or ("events" if args.weights else "speech")
    thresholds = args.frame_thresholds or [args.frame_threshold]
    results = []
    for m in args.models:
        for ft in thresholds:
            if args.decoder_ab:
                print(f"[ab] {m}: decoder bf16 vs f8, {args.minutes} min ...", flush=True)
                r = run_decoder_ab(m, args.minutes, ft, args.xkv_dtype, weights=args.weights,
                                   audio_kind=audio_kind, reset_every_s=args.reset_every, device=device)
            else:
                print(f"[ab] {m}: {args.minutes} min, ft={ft} xkv={args.xkv_dtype} audio={audio_kind} ...",
                      flush=True)
                r = run_model(m, args.minutes, ft, args.xkv_dtype, args.enc_every, weights=args.weights,
                              audio_kind=audio_kind, reset_every_s=args.reset_every,
                              enc_tail_frames=args.enc_tail_frames, device=device)
            results.append(r)
            print(json.dumps(r), flush=True)
    out = {"runs": results, "device": card_label(device)}
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=2) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
