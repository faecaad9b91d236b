"""Where one streaming tick of the port spends its time on the GPU.

    python -m whisperlivekit_tpu_torch.harness.profile_tick [--model base|large-v3]
        [--lanes 8] [--ticks 4] [--full-steps] [--f8] [--beams N] [--trace DIR]

Builds ``random:<model>`` (bf16, seeded) on the card, runs ``--lanes``
AlignAtt sessions through ``run_tick_batch`` with an AudioPool and an
EncPool, and for the large form (large-v3) an XKVAllocator of one
``--lanes``-wide group (one anchor tick, then inc ticks, 1 s of
speech-like audio per tick), times ``--ticks`` inc ticks untraced, then
traces as many with ``torch.profiler`` (the difference is the tracing
cost). With random weights, lanes stop after different numbers of decode
steps, so ticks vary; ``--full-steps`` turns the stop conditions off (no
end-of-text, no-speech, gate or rewind stop), so every lane decodes
``max_steps`` tokens every tick and runs at different lane counts do the
same work per lane. ``--f8`` serves the f8 large form (the decoder's
block linears quantized, float8_e4m3fn cross-KV pools); ``--beams N``
serves beam sessions, whose ticks run one session each through
``run_tick_batch_beam`` (no pools, as the engine serves them): a "tick"
is then every session's beam tick in turn. Prints the top operators by device time and by host time, then one
JSON line with the tick's wall time, device-busy time (the kernels' summed
device time), idle share, kernel launches per tick and the shares of K1
(flash_encoder_attn: its kernels of either body, launches by body) and
K2 (xkv_splice). ``idle_share`` holds the busy
time against the UNTRACED mean tick (the profiler slows the host, not the
kernels); ``idle_share_traced`` against the traced ticks' wall. Needs
CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np
import torch

# K1's kernels: the f32 body, the bf16 body and its key-split combine
K1_KERNELS = ("flash_encoder_kernel", "flash_wgmma_kernel", "flash_combine_kernel")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="base", choices=("base", "large-v3"))
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--ticks", type=int, default=4, help="inc ticks timed, then traced")
    ap.add_argument("--full-steps", action="store_true",
                    help="no lane stops early: every tick decodes max_steps tokens per lane")
    ap.add_argument("--f8", action="store_true", help="f8 decoder weights and f8 cross-KV pools")
    ap.add_argument("--beams", type=int, default=1, help="beam sessions with this many beams")
    ap.add_argument("--trace", default=None, help="directory for a Chrome trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_tick: needs a CUDA device", file=sys.stderr)
        return 1

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..models.whisper.dims import MODEL_DIMS
    from ..models.whisper.tokenizer import get_tokenizer

    from ..models.whisper import model as wm
    from ..ops.flash_encoder import flash_encoder_attn
    from ..ops.xkv_merge import xkv_splice
    from ..streaming import alignatt as A
    from ..streaming.alignatt_beam import run_tick_batch_beam
    from ..streaming.dispatch import run_tick_batch
    from ..streaming.pools import AudioPool, EncPool, XKVAllocator
    from .vocab import install_standin_vocab

    dims = MODEL_DIMS[args.model]
    with tempfile.TemporaryDirectory(prefix="wlk_vocab_") as vocab_dir:
        install_standin_vocab(vocab_dir)
        tok = get_tokenizer(True, num_languages=dims.num_languages, language="en",
                            task="transcribe")
    model = wm.init_params(dims, torch.Generator().manual_seed(0), torch.bfloat16, "cuda")
    if args.f8:
        wm.quantize_decoder_f8(model)
    # the model's published alignment heads, as TranscriptionEngine serves it
    kw = dict(language="en", xkv_cache_dtype="f8" if args.f8 else "bf16")
    if args.beams > 1:
        kw.update(decoder_type="beam", beam_size=args.beams)
    if args.full_steps:  # no-speech, gate and rewind never fire
        kw.update(nonspeech_prob=2.0, frame_threshold=-(1 << 20), rewind_threshold=1 << 20)
    cfg = A.AlignAttConfig(**kw)
    engine = A.AlignAttEngine(model, dims, tok, cfg, model_name=args.model)
    if args.full_steps:  # and end-of-text is never sampled
        engine.suppress_mask[tok.eot] = float("-inf")
    apool = AudioPool(args.lanes, device="cuda")
    epool = EncPool(args.lanes + 1, dims, dtype=torch.bfloat16, device="cuda")
    # the large form: one group of all lanes; no epoch anchor inside the run
    xkv = XKVAllocator.for_engine(engine, args.lanes) if engine.cfg.xkv_cache and args.beams == 1 else None
    beam = args.beams > 1
    sessions = []
    for _ in range(args.lanes):
        s = A.AlignAttSession(engine)
        if not beam:
            s.pool, s.enc_pool, s.xkv_alloc = apool, epool, xkv
        sessions.append(s)
    rng = np.random.default_rng(0)

    def tick():
        tis = []
        for i, s in enumerate(sessions):
            t = np.arange(16000) / 16000
            a = 0.3 * np.sin(2 * np.pi * (150 + 20 * i) * t) * (1 + 0.4 * np.sin(2 * np.pi * 3.1 * t))
            s.insert_audio((a + 0.02 * rng.standard_normal(t.shape)).astype(np.float32))
            tis.append(s.prepare_tick(False))
        t0 = time.perf_counter()
        if beam:
            outs = [run_tick_batch_beam(engine, [ti], tok, args.beams)[0] for ti in tis]
        else:
            outs = run_tick_batch(engine, tis, tok, pool=apool, enc_pool=epool, xkv=xkv)
        torch.cuda.synchronize()
        for s, ti, o in zip(sessions, tis, outs):
            s.finish_tick(ti, o)
        wall = time.perf_counter() - t0
        # decode steps run >= the most tokens any lane kept; refresh rows
        # (large form): 8 for the slim plan, more for the full one
        shape = dict(steps=max(o.n_keep for o in outs),
                     refresh_rows=max(0 if ti.skv_refresh_tokens is None else len(ti.skv_refresh_tokens)
                                  for ti in tis))
        return wall, [ti.enc_mode for ti in tis], shape

    first = tick()[0]  # anchor (builds the kernel)
    tick()
    untraced, untraced_shape = [], []
    for _ in range(args.ticks):  # tracing off: the wall to trust
        w, _, sh = tick()
        untraced.append(w)
        untraced_shape.append(sh)
    flash_encoder_attn.launches = 0
    flash_encoder_attn.bodies.clear()
    xkv_splice.launches = 0
    walls, modes, traced_shape = [], [], []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.ticks):
            w, m, sh = tick()
            walls.append(w)
            modes += m
            traced_shape.append(sh)
    ev = prof.key_averages()
    # kernel rows only: an operator row repeats the time of the kernels it launched
    kernels = [e for e in ev if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    k1_us = sum(e.self_device_time_total for e in kernels if any(n in e.key for n in K1_KERNELS))
    k2_us = sum(e.self_device_time_total for e in kernels if "xkv_splice_kernel" in e.key)
    launches = sum(e.count for e in ev if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    print(ev.table(sort_by="self_device_time_total", row_limit=15))
    print(ev.table(sort_by="self_cpu_time_total", row_limit=15))
    if args.trace:
        prof.export_chrome_trace(f"{args.trace}/profile_tick.json")
    busy_s = device_us / 1e6 / args.ticks
    print(json.dumps({
        "model": f"random:{args.model} bf16", "f8": args.f8, "beams": args.beams,
        "lanes": args.lanes, "ticks": args.ticks,
        "full_steps": args.full_steps, "max_steps": engine.cfg.max_steps,
        "modes": sorted(set(modes)), "first_tick_ms": round(1e3 * first, 2),
        "tick_ms_untraced": [round(1e3 * w, 2) for w in untraced],
        "untraced_ticks": untraced_shape,
        "tick_ms_traced": [round(1e3 * w, 2) for w in walls],
        "traced_ticks": traced_shape,
        "device_busy_ms_per_tick": round(device_us / 1e3 / args.ticks, 3),
        "idle_share": round(1 - busy_s / (sum(untraced) / len(untraced)), 4),
        "idle_share_traced": round(1 - busy_s / (sum(walls) / len(walls)), 4),
        "kernel_launches_per_tick": launches / args.ticks,
        "kernels_per_tick": sum(e.count for e in kernels) / args.ticks,
        "k1_ms_per_tick": round(k1_us / 1e3 / args.ticks, 3),
        "k1_launches": flash_encoder_attn.launches,
        "k1_launches_by_body": dict(flash_encoder_attn.bodies),
        "k2_ms_per_tick": round(k2_us / 1e3 / args.ticks, 3),
        "k2_launches": xkv_splice.launches,
        "device": torch.cuda.get_device_name(0),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
