"""Capacity of the port's Qwen3-ASR causal path on one card, at 0.6B widths.

    python -m whisperlivekit_tpu_torch.harness.capacity_qwen3 [--out FILE]

Port of the repository's ``scripts/bench_qwen3_tpu.py``. Per second of
audio per lane the causal mode costs half of one 2 s block's append (the
tower's append-only KV and the block's audio tokens through the text
decoder) plus one greedy hypothesis of ``HYP_TOKENS`` tokens. One tick
here is one block appended and one hypothesis decoded for B packed lanes
(``append_audio_block``, ``decode_hypothesis``), B in 8, 16, 32 and 64,
and streams = B x block seconds / tick time. The dims, the inputs (drawn
from ``np.random.default_rng(0)`` in the script's order), the B sweep and
the streams formula are the JAX script's; the weights are random bf16 from
a ``torch.Generator`` on the device, seed 0 (the numbers differ from JAX's
``PRNGKey``).

Timing: a warm call (it builds the kernels of first use), then the mean
of 3 calls on the host's wall clock, each ending with the read of its
result. Both packages' decode loops stop once every lane has ended, so a
tick's cost follows its data: each B records ``decode_steps``, the tokens
the hypothesis loop ran in each timed call (``min(HYP_TOKENS, max(n) +
1)``, the JAX loop's iterations; the port skips the last step's unread
forward), beside ``tick_ms``.

Differences from the JAX script: only ``torch.cuda.OutOfMemoryError``
fails a B (recorded as ``FAILED OutOfMemoryError``, and the sweep stops,
as the script's does); any other exception propagates, where the script
catches every ``Exception``. It writes ``--out`` (the script writes a
fixed file under ``/tmp``), and ``device`` is the card's name and power
limit. ``main(argv, device="cpu")`` runs on the CPU (tests); without
``device`` it needs CUDA. Imports no JAX.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch

from ..models import llama as lm
from ..models import qwen3_asr as qm

# Qwen3-ASR-0.6B: a ~0.6B text tower and a ~300M audio tower
TEXT = lm.LlamaDims(
    vocab_size=151936, hidden_size=1024, n_layers=28, n_heads=16, n_kv_heads=8,
    intermediate_size=3072, head_dim=128, qk_norm=True,
)
DIMS = qm.Qwen3ASRDims(
    text=TEXT, n_mels=128, d_audio=1024, audio_heads=16, audio_layers=24,
    audio_ff=4096, downsample=4, block_frames=100, max_frames=750,  # 15 s window
)
HYP_TOKENS = 8  # ~4 words/s of hypothesis re-decode per tick
B_SWEEP = (8, 16, 32, 64)
EOS = 0


def timeit(fn, iters: int = 3) -> tuple:
    """(mean wall seconds per call, each call's result): a warm call, then
    ``iters`` timed calls, each ending with the read of its result."""
    fn().cpu()
    outs = []
    t0 = time.perf_counter()
    for _ in range(iters):
        outs.append(fn().cpu())
    return (time.perf_counter() - t0) / iters, outs


def make_tick(model, dims, B: int, rng, dtype=torch.bfloat16, device="cpu"):
    """One lane batch's state, drawn as the JAX script draws it, and its
    tick: append one block, decode one hypothesis; returns a tensor
    ``[sum of n, decode steps]`` on the device."""
    window_tokens = dims.max_frames // dims.downsample
    cache_len = 8 + window_tokens + HYP_TOKENS + 8
    mel = torch.from_numpy(
        rng.standard_normal((B, dims.n_mels, 2 * dims.block_frames)).astype(np.float32)
    ).to(device)
    state = {
        "tower": qm.init_tower_cache(dims, B, dtype=dtype, device=device),
        "text": lm.init_cache(dims.text, B, cache_len, dtype=dtype, device=device),
    }
    start = torch.full((B,), dims.block_frames, dtype=torch.int32, device=device)
    tpos = torch.full((B,), 8 + dims.block_tokens, dtype=torch.int32, device=device)
    hyp = torch.full((B, 1), 4, dtype=torch.long, device=device)

    def tick():
        tw, tx, _ = qm.append_audio_block(model, mel, state["tower"], state["text"], start, tpos, dims)
        _, n, tx = qm.decode_hypothesis(model, tx, hyp, tpos + dims.block_tokens, EOS, dims,
                                        max_new=HYP_TOKENS)
        state["tower"], state["text"] = tw, tx
        return torch.stack([n.sum(), torch.clamp(n.max() + 1, max=HYP_TOKENS)])

    return tick


def sweep(model, dims, results: dict, device, dtype=torch.bfloat16) -> float:
    """Time each B of B_SWEEP in turn into ``results`` (the script's keys,
    plus ``decode_steps``); returns the peak streams."""
    rng = np.random.default_rng(0)
    best = (0.0, 0)
    for B in B_SWEEP:
        tick = None
        try:
            tick = make_tick(model, dims, B, rng, dtype, device)
            dt, outs = timeit(tick)
            # one tick = one 2 s block appended + one hypothesis decode
            streams = B * (dims.block_samples / 16000) / dt
            results[f"B{B}"] = {"tick_ms": round(dt * 1e3, 1), "streams": round(streams, 1),
                                "decode_steps": [int(o[1]) for o in outs]}
            print(f"B={B}: tick={dt*1e3:.1f} ms -> {streams:.1f} streams", file=sys.stderr, flush=True)
            if streams > best[0]:
                best = (streams, B)
        except torch.cuda.OutOfMemoryError as e:
            results[f"B{B}"] = f"FAILED {type(e).__name__}"
            print(f"B={B}: FAILED {e}", file=sys.stderr, flush=True)
            break
        finally:
            tick = None  # noqa: F841 (the lane batch's caches go before the next B)
            gc.collect()
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
    return best[0]


def main(argv=None, device=None) -> int:
    from .capacity import card_label, resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the results as a JSON file")
    args = ap.parse_args(argv)
    device = resolve_device(device)
    results = {"device": card_label(device)}
    model = qm.init_params(DIMS, torch.Generator(device).manual_seed(0), dtype=torch.bfloat16, device=device)
    results["peak_streams"] = sweep(model, DIMS, results, device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
