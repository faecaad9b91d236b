"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --k3-ab build/parent/log_mel.cu

The second form builds the kernels, then times only K3 against PR 3/4's
DFT-by-product kernel (another log_mel.cu, e.g. the parent commit's copy in
a directory .gitignore lists) in turns, old, new, new, old, at B 1, 2, 4
and 8, 80 and 128 mels, the 30 s window and a ragged 2 s length: both held
to the plain version, timed by events and by graph replay, beside the new
kernel's bound and its share of it, and its check below.

Phases (each prints lines; any failure raises and exits non-zero):

1. device  — needs CUDA (there is no CPU path); prints the card's name and
             power limit; builds every kernel of the main paths from csrc/,
             one nvcc per source, all started together, and prints each
             source's build seconds and ptxas report (registers, spills; the
             bf16 K1 body's shared memory beside it). TF32 is off for
             matrix products and convolutions, so every plain version a
             kernel is held against runs in full f32.
2. kernels — each kernel against its plain PyTorch version on the card, at
             the shapes the main paths give it, with the kernel's, the plain
             version's and (K1) the library call's time (CUDA events over
             back-to-back calls; for K1 and the library call also the device
             time alone, from a CUDA graph's replay): K1
             (flash_encoder_attn) at the base shapes, every prefill bucket,
             and a ragged T whose padding holds 1e4, inf and nan, in f32 and
             in bf16, in the encoder's and the pool's layout. Each K1 record
             names the body it took (k1_plan) and its key splits.
3. main    — the base form: an f32 tick on the card against the CPU, then
             Whisper ``base`` at full width (random weights from a seed):
             TranscriptionEngine + AudioProcessor sessions fed speech-like
             PCM, and one ``WS /asr`` stream through the port's server on
             localhost. Checks that every session got words, that anchor and
             inc ticks ran, that no tick failed and nothing logged a failure,
             and that K1 launched during the run.
4. front   — the full-window front end: a base f32 anchor with the fused
             mel (K3) and a language detection on the card against the CPU,
             then ``random:base`` bf16 with ``mel_pallas=True`` and
             ``language="auto"``: AudioProcessor sessions and one ``WS /asr``
             stream. Checks that every session detected a language (read
             from its server-side session; a transcript line that carries a
             language carries that one) and got words, that K3 launched once
             on every full-window tick, and that no tick failed.
5. large   — the large form: one whole-group anchor (fused mel at 128 mels)
             and two pooled inc ticks in f32 at large-v3 widths (4+4 layers)
             on the card against the CPU, then ``random:large-v3`` bf16 at
             full width with ``mel_pallas=True`` and ``language="auto"``:
             AudioProcessor sessions (two joining late) and one ``WS /asr``
             stream in one 8-wide lane group. Checks that the whole-group
             anchor, the chunked anchor and the pooled inc tick each ran,
             that K1, K2 and K3 launched during the run, that every session
             detected a language and got words, and that no tick failed and
             no group recovered.
6. kernels — the large form's kernels at the shapes its engine gives them:
             K1 at the encoder's two shapes, every prefix bucket over the
             dense cross-KV and over the pool, and both refresh widths, and
             at every (S, T) the large run launched; K2 against its plain
             version exactly, bf16 and f32, at the run's group width and at
             24 lanes, with edge and idle lanes. Then K3 at every lane count
             the runs launched (and 4 and 8), at 80 and 128 mels, with a
             speech-like lane, an all-zero lane and a lane silent past 5 s;
             at a ragged length (rows not 16-byte aligned) at 1, 2 and 3
             lanes, and from a row 4 bytes past alignment, both taking the
             gather route; timed beside two front ends the port does not
             run in its place (cuFFT's torch.stft chain, and audio/mel.py's
             log_mel_spectrogram, the main path's without mel_pallas).

The front and large phases also time each language detection on the
host's clock. The line before the last is the card's name and power limit,
the one before it the kernels' JSON record, with each kernel's bound: the
larger of its bytes over 3.35 TB/s and the operations its function needs
over the peak rate of their type (for K3 a real FFT of each frame, which
the kernel computes, and as bytes the audio, the log-mel and the filters'
nonzero weights; its ``dft_bound_ms`` counts the TPU kernel's
DFT-by-product formulation). K3 must take the bulk-copy route on every
main-path launch (30 s rows, 16-byte aligned).
The last line is ``{"ok": true, "device": {...}}``. Imports no JAX.
"""

from __future__ import annotations

import argparse
import asyncio
import ctypes
import json
import logging
import math
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from whisperlivekit_tpu_torch.ops import cuda_build
from whisperlivekit_tpu_torch.ops.flash_encoder import (
    _lib as _k1_lib,
    _strides_bhtd,
    flash_encoder_attn,
    flash_encoder_attn_plain,
    k1_plan,
)
from whisperlivekit_tpu_torch.audio.mel import _const, log_mel_spectrogram
from whisperlivekit_tpu_torch.harness.signals import speech_like
from whisperlivekit_tpu_torch.ops.mel_pallas import (
    _floor_and_scale,
    _log10_mel,
    _log10_mel_plain,
    _mel_compact,
    _mel_ranges,
    _plain_tables,
    k3_plan,
    log_mel_pallas,
    log_mel_pallas_plain,
)
from whisperlivekit_tpu_torch.ops.xkv_merge import W_SPLICE, xkv_splice, xkv_splice_plain
from whisperlivekit_tpu_torch.streaming.alignatt import AlignAttEngine

PREFIX_BUCKETS = AlignAttEngine.PREFIX_BUCKETS  # prefill S at call site 3
CARD = "cuda"  # the reference phases run each program here and on the CPU

B, H, DH = 8, 8, 64  # Whisper base: 8 heads of 64; 8 concurrent lanes
# (label, S, T, v_transposed): the three call sites of the base form
K1_SHAPES = (
    ("encoder full window", 1500, 1500, False),
    ("encoder tail", 384, 384, False),
    ("prefill cross-attention", 64, 1500, True),
)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # the JAX suite's bars
KERNELS = {  # name -> (sources, the first the main paths' (bf16) body; the TPU kernel it replaces)
    "flash_encoder_attn": (("whisperlivekit_tpu_torch/csrc/flash_encoder_wgmma.cu",
                            "whisperlivekit_tpu_torch/csrc/flash_encoder.cu"),
                           "whisperlivekit_tpu/ops/flash_encoder.py:73"),
    "xkv_splice": (("whisperlivekit_tpu_torch/csrc/xkv_splice.cu",),
                   "whisperlivekit_tpu/ops/xkv_merge.py:73"),
    "log_mel_pallas": (("whisperlivekit_tpu_torch/csrc/log_mel.cu",),
                       "whisperlivekit_tpu/ops/mel_pallas.py:73"),
}
SOURCES = [src for srcs, _ in KERNELS.values() for src in srcs]
WGMMA_BODIES = ("wgmma_tma", "wgmma_cpasync")  # K1's bf16 bodies (tensor cores)
# the card's published peaks (H100 SXM data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12,   # tensor cores
              torch.float32: 67e12}     # f32 FMA on CUDA cores


def bound_ms(ops: float, nbytes: float, dtype=torch.float32) -> dict:
    """The least time the card could take: operations over the peak rate of
    their type, or bytes (each input read once, each output written once)
    over the memory rate, whichever is larger."""
    t_ops, t_bytes = ops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")

# large-v3: 20 heads of 64, a lane group of 8 (max_batch_sessions below)
LG, LH = 8, 20
# K2 lanes: idle (0), the clip at both ends, every side of a 128 boundary;
# the main path's 8-lane group takes the first 8, a 24-lane group all
K2_WIN = (0, 128, 129, 640, 1407, 1408, 1500, 0,
          1, 127, 255, 256, 257, 383, 384, 999,
          1000, 1279, 1280, 1409, 1499, 700, 1200, 0)


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


class LogWatch(logging.Handler):
    """Keeps every WARNING-or-worse record. The serving stack logs a failed
    tick or session (some at WARNING) and carries on, so the smoke reads
    the log to see it: any such record fails the run unless it is one of
    the expected notices below."""

    EXPECTED = (
        "Initializing RANDOM weights",  # the smoke runs random weights
        "[SimulStreaming guard]",       # policy reset on a looping hypothesis
        "Audio buffer too large",       # backpressure at 10x real-time feed
    )

    def __init__(self):
        super().__init__(level=logging.WARNING)
        self.expected = 0
        self.failures: list = []

    def emit(self, record: logging.LogRecord) -> None:
        msg = record.getMessage()
        if record.levelno < logging.ERROR and msg.startswith(self.EXPECTED):
            self.expected += 1
        else:
            self.failures.append(f"{record.levelname} {record.name}: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this smoke runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 comparisons stay f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t0 = time.perf_counter()

    def build(src):
        t = time.perf_counter()
        lib = cuda_build.build(src.rsplit("/", 1)[1][:-3])
        return lib, time.perf_counter() - t
    with ThreadPoolExecutor(len(SOURCES)) as ex:  # one nvcc per source, together
        built = list(ex.map(build, SOURCES))
    log("device", card=repr(card), torch=torch.__version__, cuda=torch.version.cuda,
        build_s=round(time.perf_counter() - t0, 2), libs=[lib.name for lib, _ in built],
        tf32_matmul=torch.backends.cuda.matmul.allow_tf32, tf32_cudnn=torch.backends.cudnn.allow_tf32)
    for src, (lib, secs) in zip(SOURCES, built):
        report = lib.with_suffix(".ptxas.txt")
        ptxas = report.read_text() if report.exists() else ""
        # ptxas's informational notes (e.g. C7519: a wgmma fence it inserted), counted
        notes = Counter(w.strip("()") for w in ptxas.split() if w.startswith("(C"))
        log("device", source=src, build_s=round(secs, 2), ptxas_notes=dict(notes))
        for ln in ptxas.splitlines():
            if "Used" in ln or "spill" in ln:
                log("device", lib=lib.name, ptxas=repr(ln.strip()))
    wgmma = _k1_lib("flash_encoder_wgmma")
    log("device", kernel="flash_encoder_attn bf16 (wgmma)",
        dynamic_smem_bytes={dh: wgmma.wlk_flash_wgmma_smem_bytes(dh) for dh in (64, 128)})
    return card


def _qkv(S, T, vt, dtype, seed, b=B, h=H):
    """Inputs in the layouts the main path hands the kernel: q, k, v as
    strided views of [B, T, H, Dh] projections; at the prefill, k and v as
    the contiguous [B, H, Dh, T] cross-KV."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda", dtype=torch.float32).to(dtype)  # noqa: E731
    q = rnd(b, S, h, DH).transpose(1, 2)
    if vt:
        return q, rnd(b, h, DH, T), rnd(b, h, DH, T)
    return q, rnd(b, T, h, DH).permute(0, 2, 3, 1), rnd(b, T, h, DH).transpose(1, 2)


def _time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _time_graph_ms(fn, reps: int = 20) -> float:
    """Device time alone: ``reps`` calls captured in one CUDA graph, then
    replayed (no host work between launches). Warm ``fn`` up first: the
    capture must not be a kernel's first launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * reps)


def _host_us(fn, n: int = 200) -> float:
    """The host's cost of one call: back-to-back calls on the host's clock,
    without waiting for the device (the queue absorbs the launches)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def _k1_plan(q, k, v, t_valid: int, vt: bool):
    return k1_plan(q.dtype, q.shape, k.shape[-1], t_valid, q.stride(), _strides_bhtd(k, True),
                   _strides_bhtd(v, vt), (q.data_ptr(), k.data_ptr(), v.data_ptr()))


def _sdpa(q, k, v, t_valid: int, vt: bool):
    """The library call that computes K1's function: PyTorch's fused
    attention on k transposed, the keys past t_valid cut off (the key mask).
    Timed beside K1 as its yardstick; the port never calls it."""
    kt = k.transpose(-1, -2)[..., :t_valid, :]
    vv = (v.transpose(-1, -2) if vt else v)[..., :t_valid, :]
    return torch.nn.functional.scaled_dot_product_attention(q, kt, vv)


def _check_k1(label: str, model: str, S: int, T: int, t_valid: int, vt: bool, dtype, b: int, h: int) -> dict:
    """K1 against its plain version at one call site's shape: checked
    within the tolerance, timed with its plain version and the library call
    (CUDA events over back-to-back calls, the device time alone from a
    graph's replay, and the host's cost of a call), bounded, logged with
    the body and splits it took."""
    q, k, v = _qkv(S, T, vt, dtype, seed=S + T, b=b, h=h)
    if t_valid < T:  # a pool's padding columns hold zeros
        k[..., t_valid:] = 0
        v[..., t_valid:] = 0
    plan = _k1_plan(q, k, v, t_valid, vt)
    got = flash_encoder_attn(q, k, v, t_valid=t_valid, v_transposed=vt)
    want = flash_encoder_attn_plain(q, k, v, t_valid=t_valid, v_transposed=vt)
    lib_err = (_sdpa(q, k, v, t_valid, vt).float() - want.float()).abs().max().item()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ok = bool(torch.isfinite(got.float()).all().item()) and err <= TOL[dtype]
    k1 = lambda: flash_encoder_attn(q, k, v, t_valid=t_valid, v_transposed=vt)  # noqa: E731
    lib = lambda: _sdpa(q, k, v, t_valid, vt)  # noqa: E731
    ms = _time_ms(k1)
    device_ms = _time_graph_ms(k1)
    plain_ms = _time_ms(lambda: flash_encoder_attn_plain(q, k, v, t_valid=t_valid, v_transposed=vt))
    library_ms = _time_ms(lib)
    library_device_ms = _time_graph_ms(lib)
    host_us, library_host_us = _host_us(k1), _host_us(lib)
    # QK^T and PV over the valid keys; q, k, v read once, the output written once
    bound = bound_ms(4 * b * h * S * t_valid * DH,
                     (q.numel() + k.numel() + v.numel() + got.numel()) * q.element_size(), dtype)
    dt = str(dtype).replace("torch.", "")
    log("kernels", kernel="flash_encoder_attn", model=model, shape=f"B{b}xH{h}xS{S}xT{T}xDh{DH}",
        t_valid=t_valid, call_site=repr(label), dtype=dt, body=plan.body, n_split=plan.n_split,
        max_abs_err=err, tol=TOL[dtype], ms=round(ms, 4), device_ms=round(device_ms, 4),
        plain_ms=round(plain_ms, 4), library_ms=round(library_ms, 4),
        library_device_ms=round(library_device_ms, 4), host_us=round(host_us, 1),
        library_host_us=round(library_host_us, 1), library_abs_err=lib_err,
        bound_ms=round(bound["bound_ms"], 4), bound_by=bound["bound_by"], ok=ok)
    if not ok:
        raise AssertionError(f"flash_encoder_attn disagrees at {model} {label} {dt}: {err}")
    return dict(max_abs_err=err, ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=library_ms,
                library_device_ms=library_device_ms, host_us=host_us, library_host_us=library_host_us,
                body=plan.body, n_split=plan.n_split, **bound)


def _check_k1_poisoned(layout: str, dtype, poison: float) -> float:
    """K1 with t_valid < T and the padding columns of k and v holding
    ``poison``: they must have no effect. "enc": the encoder's strided views,
    1400 of 1500 keys valid; "pool": the [G,H,Dh,1536] cross-KV pool, 1500
    valid, under a 96-row prefill."""
    if layout == "enc":
        q, k, v = _qkv(1500, 1500, False, dtype, seed=7)
        t_valid, vt = 1400, False
    else:
        q, k, v = _qkv(96, 1536, True, dtype, seed=8, b=LG, h=LH)
        t_valid, vt = 1500, True
    k, v = k.clone(), v.clone()
    k[..., t_valid:] = poison
    (v[..., t_valid:] if vt else v[:, :, t_valid:]).fill_(poison)
    plan = _k1_plan(q, k, v, t_valid, vt)
    got = flash_encoder_attn(q, k, v, t_valid=t_valid, v_transposed=vt)
    want = flash_encoder_attn_plain(q, k[..., :t_valid], v[..., :t_valid] if vt else v[:, :, :t_valid],
                                    t_valid=t_valid, v_transposed=vt)
    err = (got.float() - want.float()).abs().max().item()
    finite = bool(torch.isfinite(got.float()).all().item())
    dt = str(dtype).replace("torch.", "")
    log("kernels", kernel="flash_encoder_attn", case=f"{layout} t_valid={t_valid} of {k.shape[-1]}, padding={poison}",
        dtype=dt, body=plan.body, n_split=plan.n_split, max_abs_err=err, finite=finite)
    if not (finite and err <= TOL[dtype]):
        raise AssertionError(f"masked columns leak into the output ({layout}, {dt}, {poison}): {err}")
    return err


def phase_kernels() -> dict:
    """K1 against its plain version at the base form's three main-path
    shapes, both dtypes, plus ragged T with poisoned padding (f32 and bf16,
    both layouts); returns per-shape records."""
    records = {}
    for label, S, T, vt in K1_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            rec = _check_k1(label, "base", S, T, T, vt, dtype, B, H)
            records[(S, T, str(dtype).replace("torch.", ""))] = rec
    # every other prefill bucket the main path may hand the kernel
    for S in PREFIX_BUCKETS:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _qkv(S, 1500, True, dtype, seed=S)
            got = flash_encoder_attn(q, k, v, t_valid=1500, v_transposed=True)
            want = flash_encoder_attn_plain(q, k, v, t_valid=1500, v_transposed=True)
            err = (got.float() - want.float()).abs().max().item()
            if not (bool(torch.isfinite(got.float()).all().item()) and err <= TOL[dtype]):
                raise AssertionError(f"flash_encoder_attn disagrees at prefill S={S} {dtype}: {err}")
    log("kernels", kernel="flash_encoder_attn", case="prefill buckets x T1500, v_transposed",
        S=list(PREFIX_BUCKETS), ok=True)
    # ragged T with poisoned padding columns: masked columns have no effect
    for poison in (1e4, float("inf"), float("nan")):
        _check_k1_poisoned("enc", torch.float32, poison)
        for layout in ("enc", "pool"):
            _check_k1_poisoned(layout, torch.bfloat16, poison)
    return records


def k1_large_cases(geom: dict) -> list:
    """(label, S, T, t_valid, v_transposed) of every K1 call the large
    form's engine can make: the encoder's full window and tail, each prefix
    bucket's prefill over the dense cross-KV (chunked anchor, EncPool and
    legacy ticks) and over the pool (whole-group anchor), and the two
    refresh widths over the pool (pooled inc tick)."""
    T, Tp, tail = geom["n_audio_ctx"], geom["pool_t"], geom["tail_frames"]
    cases = [("encoder full window", T, T, T, False), ("encoder tail", tail, tail, tail, False)]
    for S in geom["prefix_buckets"]:
        cases.append((f"prefill over dense cross-KV, bucket {S}", S, T, T, True))
        cases.append((f"prefill over the pool, bucket {S}", S, Tp, T, True))
    for R in geom["refresh_rows"]:
        cases.append((f"refresh over the pool, {R} rows", R, Tp, T, True))
    return cases


def _check_k2(shape, win_list, dtype) -> dict:
    """K2 against its plain version at one pool shape, bit for bit, idle
    lanes untouched; timed (CUDA events), logged."""
    win = torch.tensor(win_list, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)  # noqa: E731
    pk, pv = rnd(*shape), rnd(*shape)
    tk, tv = rnd(*shape[:-1], W_SPLICE), rnd(*shape[:-1], W_SPLICE)
    want_k, want_v = xkv_splice_plain(pk, pv, tk, tv, win)
    idle = [i for i, w in enumerate(win_list) if w == 0]
    idle_before = pk[:, idle].clone()
    xkv_splice(pk, pv, tk, tv, win)
    torch.cuda.synchronize()
    ibits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    exact = (torch.equal(pk.view(ibits), want_k.view(ibits))
             and torch.equal(pv.view(ibits), want_v.view(ibits))
             and torch.equal(pk[:, idle].view(ibits), idle_before.view(ibits)))
    del want_k, want_v, idle_before
    ms = _time_ms(lambda: xkv_splice(pk, pv, tk, tv, win))
    plain_ms = _time_ms(lambda: xkv_splice_plain(pk, pv, tk, tv, win), iters=5)
    # read + write, K and V, of the lanes with win > 0
    moved = 2 * 2 * tk.numel() * tk.element_size() * (len(win_list) - len(idle)) // len(win_list)
    dt = str(dtype).replace("torch.", "")
    bound = bound_ms(0, moved)  # a copy: no arithmetic
    log("kernels", kernel="xkv_splice", shape="x".join(map(str, shape)), dtype=dt,
        win=list(win_list), exact=exact, ms=round(ms, 4), plain_ms=round(plain_ms, 4),
        GB_per_s=round(moved / ms / 1e6, 1), bound_ms=round(bound["bound_ms"], 4))
    if not exact:
        raise AssertionError(f"xkv_splice disagrees with its plain version at {shape} ({dt})")
    del pk, pv, tk, tv
    torch.cuda.empty_cache()
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None, **bound)


def phase_kernels_large(geom: dict, launched: dict) -> dict:
    """The large form's kernels at the shapes its engine gives them (see
    k1_large_cases; K2 at the run's group width and at 24 lanes). Fails if
    the large run launched K1 at an (S, T) not checked here. Returns
    per-case records."""
    records = {}
    G = geom["group_width"]
    cases = k1_large_cases(geom)
    for label, S, T, tv, vt in cases:
        for dtype in (torch.bfloat16, torch.float32):
            rec = _check_k1(label, "large-v3", S, T, tv, vt, dtype, G, LH)
            records[("flash_encoder_attn", S, T, str(dtype).replace("torch.", ""))] = rec
    unchecked = set(launched) - {(S, T) for _, S, T, _, _ in cases}
    if unchecked:
        raise AssertionError(f"the large run launched K1 at unchecked shapes {sorted(unchecked)}")
    pool = (geom["n_text_layer"], None, LH, DH, geom["pool_t"])
    for width in (G, len(K2_WIN)):
        for dtype in (torch.bfloat16, torch.float32):
            shape = (pool[0], width, *pool[2:])
            records[("xkv_splice", width, str(dtype).replace("torch.", ""))] = _check_k2(
                shape, K2_WIN[:width], dtype)
    return records


K3_TOL = dict(rtol=1e-4, atol=2e-4)  # the JAX suite's bar (tests/test_mel_pallas.py), f32 sum order


def _k3_audio(B: int, N: int, seed: int, offset: int) -> torch.Tensor:
    """[B, N] f32 on the card: a speech-like lane, an all-zero lane, a
    speech-like lane silent past 5 s, then speech-like and white-noise lanes
    in turn; ``offset`` floats past a 16-byte aligned address."""
    rng = np.random.default_rng(seed)
    lanes = np.stack([
        np.zeros(N, np.float32) if i == 1
        else (0.2 * rng.standard_normal(N)).astype(np.float32) if i >= 3 and i % 2
        else speech_like(N, seed + i, f0=120.0 + 15 * i)
        for i in range(B)])
    if B >= 3:
        lanes[2, 5 * 16000:] = 0
    flat = torch.zeros(B * N + offset, device="cuda")
    audio = flat[offset:].view(B, N)
    audio.copy_(torch.from_numpy(lanes))
    return audio


def stft_chain(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """log10 mel power through cuFFT: torch.stft, |.|^2, filterbank, log10.
    A front end the port never runs in K3's place, timed beside it."""
    spec = torch.stft(audio, 400, 160, window=torch.hann_window(400, device=audio.device), center=True,
                      pad_mode="reflect", return_complex=True)
    power = torch.view_as_real(spec[..., :-1]).square().sum(-1)
    return torch.log10(torch.clamp(_const("mel", n_mels, audio.device) @ power, min=1e-10))


def k3_bound(B: int, N: int, n_mels: int) -> tuple:
    """(bound, dft_bound) of K3's function at audio [B, N]. The bound counts
    what the log-mel function needs: a real FFT of each 400-tap frame (2.5 n
    log2 n, half the 5 n log2 n of a complex one), the power of its 201
    bins, the filters' nonzero weights; audio in, the filters' nonzero
    weights and their bin ranges in, log-mel out. The bytes rule at every
    shape checked here. ``dft_bound`` is the same for the TPU kernel's
    DFT-by-product formulation (the PR 3/4 kernel's): 402 outputs of 400
    taps, with the padded basis and dense filterbank read once."""
    T = N // 160
    nnz = _mel_compact(n_mels)[0].size
    io_bytes = 4 * (B * N + B * n_mels * T)
    ops = B * T * (2.5 * 400 * math.log2(400) + 3 * 201 + 2 * nnz)
    dft_ops = 2 * B * T * 400 * 402 + 3 * B * T * 201 + 2 * B * T * nnz
    return (bound_ms(ops, io_bytes + 4 * (nnz + 2 * n_mels)),
            bound_ms(dft_ops, io_bytes + 4 * (480 * 512 + 256 * 128 + 2 * n_mels)))


def _check_k3(B: int, N: int, n_mels: int, seed: int, offset: int = 0) -> dict:
    """K3 against its plain version on the card (the plain side's products
    run in full f32: TF32 is off); the kernel alone (log10 mel, without the
    floor that follows it) timed by events and as device time alone (graph
    replay), beside its plain version, cuFFT's torch.stft chain and the
    default front end (audio/mel.py); bounded, logged with its plan."""
    audio = _k3_audio(B, N, seed, offset)
    plan = k3_plan(B, N, n_mels, audio.data_ptr())
    got = log_mel_pallas(audio, n_mels)
    want = log_mel_pallas_plain(audio, n_mels)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ok = bool(torch.isfinite(got).all().item()) and torch.allclose(got, want, **K3_TOL)
    k3 = lambda: _log10_mel(audio, n_mels)  # noqa: E731
    stft = lambda: stft_chain(audio, n_mels)  # noqa: E731
    front = lambda: log_mel_spectrogram(audio, n_mels)  # noqa: E731
    ms, device_ms = _time_ms(k3), _time_graph_ms(k3)
    plain_ms = _time_ms(lambda: _log10_mel_plain(audio, n_mels))
    stft_ms, stft_device_ms = _time_ms(stft), _time_graph_ms(stft)
    front_ms, front_device_ms = _time_ms(front), _time_graph_ms(front)
    bound, dft_bound = k3_bound(B, N, n_mels)
    log("kernels", kernel="log_mel_pallas", shape=f"B{B}xN{N}", n_mels=n_mels, route=plan.route,
        tiles=plan.tiles, bulk_tiles=plan.bulk_tiles, row_offset_bytes=4 * offset, max_abs_err=err,
        rtol=K3_TOL["rtol"], atol=K3_TOL["atol"], ms=round(ms, 4), device_ms=round(device_ms, 4),
        plain_ms=round(plain_ms, 4), stft_chain_ms=round(stft_ms, 4),
        stft_chain_device_ms=round(stft_device_ms, 4), default_front_ms=round(front_ms, 4),
        default_front_device_ms=round(front_device_ms, 4), bound_ms=round(bound["bound_ms"], 5),
        bound_by=bound["bound_by"], bound_share=round(bound["bound_ms"] / device_ms, 3),
        dft_bound_ms=round(dft_bound["bound_ms"], 4), ok=ok)
    if not ok:
        raise AssertionError(f"log_mel_pallas disagrees at B={B} N={N} n_mels={n_mels}: {err}")
    return dict(max_abs_err=err, ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=None,
                stft_chain_ms=stft_ms, stft_chain_device_ms=stft_device_ms, default_front_ms=front_ms,
                default_front_device_ms=front_device_ms, load_route=plan.route, **bound,
                dft_bound_ms=dft_bound["bound_ms"])


def phase_kernels_k3(launched: dict) -> dict:
    """K3 at every lane count the main paths launched it with (and 4 and 8,
    the base anchor's), at the full window, for 80 and 128 mels; at a ragged
    length whose rows are not 16-byte aligned at 1, 2 and 3 lanes; and from
    a row 4 bytes past alignment. Fails if a run launched K3 at an unchecked
    shape."""
    records = {}
    lanes = sorted({b for b, _, _ in launched} | {4, 8})
    cases = [(b, 480000, m, 0) for b in lanes for m in (80, 128)]
    cases += [(1, 32077, 80, 0), (1, 32077, 128, 0), (2, 32077, 80, 0), (3, 32077, 128, 0)]
    cases += [(2, 480000, 80, 1)]
    for i, (b, n, m, off) in enumerate(cases):
        records[(b, n, m) + (("unaligned",) if off else ())] = _check_k3(b, n, m, seed=100 + i, offset=off)
    unchecked = set(launched) - set(records)
    if unchecked:
        raise AssertionError(f"the runs launched K3 at unchecked shapes {sorted(unchecked)}")
    return records


def _dft_k3(src: str):
    """Build PR 3/4's DFT-by-product log_mel.cu (``src``, e.g. the parent
    commit's copy under build/) with the port's nvcc flags and return its
    call: CUDA audio [B, N] -> log10 mel [B, n_mels, N // 160]. Its C entry
    is wlk_log_mel(audio, dft, filters, ranges, out, B, N, n_mels, stream),
    on the plain version's padded basis and filterbank."""
    out = cuda_build.BUILD_DIR / "liblog_mel_dft.so"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out), src],
                   check=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    lib.wlk_log_mel.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.wlk_log_mel.restype = ctypes.c_int
    ranges = {m: torch.from_numpy(_mel_ranges(m)).cuda() for m in (80, 128)}  # made before any capture

    def call(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
        B, N = audio.shape
        tables = (*_plain_tables(n_mels, audio.device), ranges[n_mels])
        out = torch.empty((B, n_mels, N // 160), device=audio.device)
        rc = lib.wlk_log_mel(audio.data_ptr(), *(t.data_ptr() for t in tables), out.data_ptr(), B, N,
                             n_mels, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the DFT-by-product log_mel launch failed ({rc})")
        return out
    return call


def phase_k3_ab(src: str) -> None:
    """K3 against PR 3/4's DFT-by-product kernel in turns (old, new, new,
    old) at B 1, 2, 4 and 8, 80 and 128 mels, the 30 s window and a ragged
    2 s length, on the lanes of the smoke's K3 check: both held to the
    plain version, then timed by events and by graph replay; then the new
    kernel's own check (_check_k3: its bound, cuFFT's chain, the default
    front end) on the same lanes."""
    old = _dft_k3(src)
    for i, (N, B, m) in enumerate((n, b, m) for n in (480000, 32077) for b in (1, 2, 4, 8) for m in (80, 128)):
        audio = _k3_audio(B, N, seed=300 + i, offset=0)
        got, want = _floor_and_scale(old(audio, m)), log_mel_pallas_plain(audio, m)
        old_err = (got - want).abs().max().item()
        if not torch.allclose(got, want, **K3_TOL):
            raise AssertionError(f"the DFT-by-product K3 disagrees at B={B} N={N} n_mels={m}: {old_err}")
        fns = {"old": lambda: old(audio, m), "new": lambda: _log10_mel(audio, m)}  # noqa: B023
        times = {"old": [], "new": []}
        for name in ("old", "new", "new", "old"):
            times[name].append((_time_ms(fns[name]), _time_graph_ms(fns[name])))
        rec = _check_k3(B, N, m, seed=300 + i)  # the new kernel on the same lanes
        new_device = min(t for _, t in times["new"])
        log("k3_ab", shape=f"B{B}xN{N}", n_mels=m, old_max_abs_err=old_err,
            old_ms=[round(t, 4) for t, _ in times["old"]], old_device_ms=[round(t, 4) for _, t in times["old"]],
            new_ms=[round(t, 4) for t, _ in times["new"]], new_device_ms=[round(t, 4) for _, t in times["new"]],
            bound_ms=round(rec["bound_ms"], 5), bound_share=round(rec["bound_ms"] / new_device, 3),
            speedup_device=round(min(t for _, t in times["old"]) / new_device, 2))


def phase_reference() -> None:
    """One full-width tick of the port in f32 on the card (kernel path)
    against the same tick on the CPU (plain path): the packed integer
    outputs must be equal, no_speech_p within 1e-4."""
    from whisperlivekit_tpu_torch.engine.core import MODEL_DIMS, get_tokenizer
    from whisperlivekit_tpu_torch.models.whisper import model as wm
    from whisperlivekit_tpu_torch.streaming import alignatt as A
    from whisperlivekit_tpu_torch.streaming.dispatch import _core_device_args, _collect_lane_arrays
    from whisperlivekit_tpu_torch.streaming.session_plan import TickInputs

    dims = MODEL_DIMS["base"]
    tok = get_tokenizer(True, language="en", task="transcribe")
    pcm = speech_pcm(3.0, seed=99)
    outs, launched = {}, 0
    for side, dev in (("card", CARD), ("cpu", "cpu")):
        model = wm.init_params(dims, torch.Generator().manual_seed(1), torch.float32, dev)
        eng = A.AlignAttEngine(model, dims, tok, A.AlignAttConfig(language="en"))
        ti = TickInputs(audio=None, prefix_ids=list(tok.sot_sequence_including_notimestamps),
                        sot_index=0, content_frames=len(pcm) // 320, last_attend=-200,
                        is_last=False, max_new=50)
        arr = _collect_lane_arrays(eng, [ti], tok, 1, 32)
        args, statics = _core_device_args(eng, arr, tok, 32)
        audio = np.zeros((1, 480000), np.int16)
        audio[0, : len(pcm)] = pcm
        before = flash_encoder_attn.launches
        with torch.inference_mode():
            outs[side] = A.alignatt_tick(model, torch.from_numpy(audio).to(dev), *args, **statics).cpu().numpy()
        if side == "card":
            launched = flash_encoder_attn.launches - before
    g, c = outs["card"], outs["cpu"]
    ns_err = float(abs(g[0, -1:].view(np.float32) - c[0, -1:].view(np.float32))[0])
    ok = bool((g[:, :-1] == c[:, :-1]).all()) and ns_err <= 1e-4 and launched > 0
    log("reference", model="base f32 random", tick="alignatt_tick B=1 3s",
        gpu=g[0, :-1].tolist(), cpu=c[0, :-1].tolist(), no_speech_err=ns_err,
        kernel_launches=launched, ok=ok)
    if not ok:
        raise AssertionError("the card's tick disagrees with the CPU reference")


def speech_pcm(seconds: float, seed: int) -> np.ndarray:
    """Speech-like int16 PCM: a modulated tone with a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    f0 = 150 + 40 * (seed % 5)
    sig = 0.3 * np.sin(2 * np.pi * f0 * t) * (1 + 0.4 * np.sin(2 * np.pi * 3.1 * t))
    sig += 0.02 * rng.standard_normal(t.shape)
    return (np.clip(sig, -1, 1) * 32767).astype("<i2")


N_SESSIONS = 4       # AudioProcessor sessions in process, plus one over WS /asr
SESSION_SECONDS = 12.0
CHUNK_S = 0.5
PACE = 10.0          # audio fed at 10x real time


async def _feed_processor(processor, pcm: np.ndarray, pace: float = PACE, delay: float = 0.0) -> list:
    """Stream PCM into an in-process session; returns its last lines as
    (text, detected_language)."""
    await asyncio.sleep(delay)
    results = await processor.create_tasks()
    last = []

    async def collect():
        nonlocal last
        async for front in results:
            last = front.lines
    task = asyncio.create_task(collect())
    step = int(16000 * CHUNK_S)
    for i in range(0, len(pcm), step):
        await processor.process_audio(pcm[i : i + step].tobytes())
        await asyncio.sleep(CHUNK_S / pace)
    await processor.process_audio(b"")
    await asyncio.wait_for(task, timeout=300)
    await processor.cleanup()
    return [(ln.text, ln.detected_language) for ln in last if ln.text]


async def _feed_websocket(url: str, pcm: np.ndarray, pace: float = PACE, delay: float = 0.0) -> list:
    """Stream PCM over ``WS /asr``; returns the last lines as (text,
    detected_language)."""
    import aiohttp

    await asyncio.sleep(delay)
    texts = []
    async with aiohttp.ClientSession() as http:
        async with http.ws_connect(url) as ws:
            first = await ws.receive_json(timeout=60)
            if first.get("type") != "config":
                raise AssertionError(f"unexpected first WS message {first}")

            async def receive():
                nonlocal texts
                while True:
                    msg = await ws.receive_json(timeout=300)
                    if msg.get("type") == "ready_to_stop":
                        return
                    texts = [(ln["text"], ln.get("detected_language"))
                             for ln in msg.get("lines", []) if ln.get("text")]
            task = asyncio.create_task(receive())
            step = int(16000 * CHUNK_S)
            for i in range(0, len(pcm), step):
                await ws.send_bytes(pcm[i : i + step].tobytes())
                await asyncio.sleep(CHUNK_S / pace)
            await ws.send_bytes(b"")
            await asyncio.wait_for(task, timeout=300)
    return texts


async def _main_path() -> dict:
    from aiohttp import web

    from whisperlivekit_tpu_torch.engine.core import TranscriptionEngine, WLKConfig
    from whisperlivekit_tpu_torch.server.app import WLKServer
    from whisperlivekit_tpu_torch.session.processor import AudioProcessor
    from whisperlivekit_tpu_torch.streaming.alignatt import TICK_PHASE_STATS

    config = WLKConfig(model_size="random:base", lan="en", pcm_input=True, vac=False,
                       param_dtype="bfloat16", log_level="WARNING")
    t0 = time.perf_counter()
    engine = TranscriptionEngine(config)
    if engine.device.type != "cuda":
        raise AssertionError(f"engine landed on {engine.device}, not the card")
    runner = web.AppRunner(WLKServer(config, engine=engine).app)
    await runner.setup()  # startup runs the engine's warmup tick
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    host, port = runner.addresses[0][:2]
    setup_s = time.perf_counter() - t0
    try:
        _reset_kernel_counts()  # count only the main path's run from here
        engine.scheduler.reset_stats()
        t1 = time.perf_counter()
        pcms = [speech_pcm(SESSION_SECONDS, seed=s) for s in range(N_SESSIONS + 1)]
        procs = [AudioProcessor(transcription_engine=engine) for _ in range(N_SESSIONS)]
        texts = await asyncio.gather(
            *(_feed_processor(p, pcm) for p, pcm in zip(procs, pcms)),
            _feed_websocket(f"http://{host}:{port}/asr", pcms[-1]),
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = _kernel_counts()
        stats = engine.scheduler.stats()
        phases = dict(TICK_PHASE_STATS)
    finally:
        await runner.cleanup()
        TranscriptionEngine.reset()
    return dict(texts=texts, wall=wall, setup_s=setup_s, launches=counts["flash_encoder_attn"],
                shapes=counts["k1_shapes"], counts=counts, stats=stats, phases=phases)


def phase_main() -> int:
    import tempfile

    from whisperlivekit_tpu_torch.harness.vocab import install_standin_vocab

    with tempfile.TemporaryDirectory(prefix="wlk_vocab_") as vocab_dir:
        install_standin_vocab(vocab_dir)
        phase_reference()
        run = asyncio.run(_main_path())
    stats = run["stats"]
    words = [sum(len(t.split()) for t, _ in lines) for lines in run["texts"]]
    shapes = {f"{s}x{t}": n for (s, t), n in sorted(run["shapes"].items())}
    log("main", model="random:base bf16", sessions=len(words),
        audio_s_each=SESSION_SECONDS, words_per_session=words,
        wall_s=round(run["wall"], 3), setup_s=round(run["setup_s"], 3),
        ticks=stats["n_ticks"], avg_lanes=stats["avg_lanes_per_tick"],
        tick_ms_p50=stats["tick_ms_p50"], tick_ms_p95=stats["tick_ms_p95"],
        word_emission_p50_ms=stats["word_emission_p50_ms"],
        failed_ticks=stats["n_failed_ticks"])
    for key, ph in stats["tick_phases"].items():
        log("main", tick_phase=key, **ph)
    log("main", kernel="flash_encoder_attn", launches=run["launches"], launches_by_SxT=shapes,
        per_tick=round(run["launches"] / max(stats["n_ticks"], 1), 2))
    _check_k1_bodies("main", run["counts"])
    if stats["n_failed_ticks"]:
        raise AssertionError(f"{stats['n_failed_ticks']} batch ticks failed")
    if not all(words):
        raise AssertionError(f"a session got no words: {words}")
    if not {"anchor", "inc"} <= set(stats["tick_phases"]):
        raise AssertionError(f"expected anchor and inc ticks, got {list(stats['tick_phases'])}")
    seen = run["shapes"]
    prefill = [s for (s, t) in seen if t == 1500 and s < 1500]
    if not (seen.get((1500, 1500)) and seen.get((384, 384)) and prefill):
        raise AssertionError(f"K1 did not launch at all three call sites: {shapes}")
    return run["launches"]


def phase_reference_front() -> None:
    """The full-window front end in f32 on the card (K3, K1) against the
    CPU (plain versions), with the base model from one seed: a two-lane
    ``alignatt_tick_anchor`` with ``mel_pallas=True`` (integer outputs
    equal, no_speech_p within 1e-4), and language detection over both
    lanes' windows (plain mel, full encode, one decoder step: the same
    codes, every language's probability within 1e-4)."""
    from whisperlivekit_tpu_torch.audio.mel import N_SAMPLES, log_mel_spectrogram, pad_or_trim
    from whisperlivekit_tpu_torch.decoding.task import WhisperDecoder
    from whisperlivekit_tpu_torch.engine.core import MODEL_DIMS, get_tokenizer
    from whisperlivekit_tpu_torch.models.whisper import model as wm
    from whisperlivekit_tpu_torch.streaming import alignatt as A
    from whisperlivekit_tpu_torch.streaming.dispatch import _collect_lane_arrays, _core_device_args
    from whisperlivekit_tpu_torch.streaming.session_plan import TickInputs

    dims = MODEL_DIMS["base"]
    tok = get_tokenizer(True, language="en", task="transcribe")
    pcms = [speech_pcm(3.0, seed=98), speech_pcm(7.0, seed=97)]
    pcms[1][5 * 16000:] = 0  # silent past 5 s: the floor clamps there
    audio = np.zeros((2, N_SAMPLES), np.int16)
    for i, pcm in enumerate(pcms):
        audio[i, : len(pcm)] = pcm
    res, launched = {}, 0
    for side, dev in (("card", CARD), ("cpu", "cpu")):
        model = wm.init_params(dims, torch.Generator().manual_seed(1), torch.float32, dev)
        eng = A.AlignAttEngine(model, dims, tok, A.AlignAttConfig(language="en", mel_pallas=True))
        tis = [TickInputs(audio=None, prefix_ids=list(tok.sot_sequence_including_notimestamps),
                          sot_index=0, content_frames=len(pcm) // 320, last_attend=-200,
                          is_last=False, max_new=50) for pcm in pcms]
        args, statics = _core_device_args(eng, _collect_lane_arrays(eng, tis, tok, 2, 32), tok, 32)
        enc_pool = torch.zeros((3, dims.n_audio_ctx, dims.n_audio_state), device=dev)
        before = log_mel_pallas.launches
        with torch.inference_mode():
            packed, _ = A.alignatt_tick_anchor(
                model, torch.from_numpy(audio).to(dev), enc_pool, torch.tensor([1, 2], device=dev),
                *args, **statics)
            mel = torch.stack([
                pad_or_trim(log_mel_spectrogram(
                    torch.from_numpy(pcm.astype(np.float32) / 32768.0).to(dev),
                    n_mels=dims.n_mels, padding=N_SAMPLES - len(pcm)), 2 * dims.n_audio_ctx)
                for pcm in pcms])
            codes, probs = WhisperDecoder(model, dims).detect_language(wm.encode(model, mel, dims), tok)
        if side == "card":
            launched = log_mel_pallas.launches - before
        res[side] = (packed.cpu().numpy(), codes, probs)
    (g, gcodes, gprobs), (c, ccodes, cprobs) = res["card"], res["cpu"]
    ns_err = float(np.abs(g[:, -1:].view(np.float32) - c[:, -1:].view(np.float32)).max())
    p_err = max(abs(a[k] - b[k]) for a, b in zip(gprobs, cprobs) for k in a)
    ok = (bool((g[:, :-1] == c[:, :-1]).all()) and ns_err <= 1e-4 and launched == 1
          and gcodes == ccodes and p_err <= 1e-4)
    log("reference", model="base f32 random", tick="alignatt_tick_anchor mel_pallas B=2 (3 s, 7 s)",
        gpu=g[:, :-1].tolist(), cpu=c[:, :-1].tolist(), no_speech_err=ns_err,
        k3_launches=launched, languages=gcodes, cpu_languages=ccodes, language_prob_err=p_err, ok=ok)
    if not ok:
        raise AssertionError("the card's front end disagrees with the CPU reference")


FRONT_SESSIONS = 4     # AudioProcessor sessions in process, plus one over WS /asr
FRONT_SECONDS = 16.0
# wall seconds (audio runs at 10x): sessions join one by one, each with a
# full-window anchor. The window does not evict: a session detects its
# language once its window reaches 2 s past its first timestamp, which is
# not moved by eviction, as in the JAX package
FRONT_DELAYS = (0.0, 0.3, 0.6, 0.9)
FRONT_WS_DELAY = 0.15


async def _main_path_front() -> dict:
    from aiohttp import web

    from whisperlivekit_tpu_torch.engine.core import TranscriptionEngine, WLKConfig
    from whisperlivekit_tpu_torch.server.app import WLKServer
    from whisperlivekit_tpu_torch.session.processor import AudioProcessor

    config = WLKConfig(model_size="random:base", lan="auto", pcm_input=True, vac=False,
                       param_dtype="bfloat16", log_level="WARNING")
    t0 = time.perf_counter()
    engine = TranscriptionEngine(config)
    engine.asr.cfg.mel_pallas = True  # an AlignAttConfig field: WLKConfig has no flag for it
    if engine.device.type != "cuda":
        raise AssertionError(f"engine landed on {engine.device}, not the card")
    runner = web.AppRunner(WLKServer(config, engine=engine).app)
    await runner.setup()  # startup runs the engine's warmup tick
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    host, port = runner.addresses[0][:2]
    setup_s = time.perf_counter() - t0
    try:
        with Instrumented(FULL_WINDOW) as ins:
            _reset_kernel_counts()
            engine.scheduler.reset_stats()
            t1 = time.perf_counter()
            pcms = [speech_pcm(FRONT_SECONDS, seed=60 + s) for s in range(FRONT_SESSIONS + 1)]
            procs = [AudioProcessor(transcription_engine=engine) for _ in range(FRONT_SESSIONS)]
            texts = await asyncio.gather(
                *(_feed_processor(p, pcm, PACE, d) for p, pcm, d in zip(procs, pcms, FRONT_DELAYS)),
                _feed_websocket(f"http://{host}:{port}/asr", pcms[-1], PACE, FRONT_WS_DELAY),
            )
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            counts = _kernel_counts()
        langs, line_langs = _session_languages(ins, procs, texts)
        stats = engine.scheduler.stats()
    finally:
        await runner.cleanup()
        TranscriptionEngine.reset()
    return dict(texts=texts, langs=langs, line_langs=line_langs, wall=wall, setup_s=setup_s, counts=counts,
                stats=stats, calls=ins.calls, phase_ms=ins.phase_ms, detect_ms=ins.detect_ms)


def phase_front() -> dict:
    import tempfile

    from whisperlivekit_tpu_torch.harness.vocab import install_standin_vocab

    with tempfile.TemporaryDirectory(prefix="wlk_vocab_") as vocab_dir:
        install_standin_vocab(vocab_dir)
        phase_reference_front()
        run = asyncio.run(_main_path_front())
    stats, counts = run["stats"], run["counts"]
    words = [sum(len(t.split()) for t, _ in lines) for lines in run["texts"]]
    log("front", model="random:base bf16, mel_pallas, language auto", sessions=len(words),
        audio_s_each=FRONT_SECONDS, words_per_session=words,
        wall_s=round(run["wall"], 3), setup_s=round(run["setup_s"], 3),
        ticks=stats["n_ticks"], avg_lanes=stats["avg_lanes_per_tick"],
        tick_ms_p50=stats["tick_ms_p50"], tick_ms_p95=stats["tick_ms_p95"],
        word_emission_p50_ms=stats["word_emission_p50_ms"],
        word_emission_p95_ms=stats["word_emission_p95_ms"], failed_ticks=stats["n_failed_ticks"])
    for key, ms in sorted(run["phase_ms"].items()):
        log("front", tick_phase=key, n=len(ms), p50_ms=_quantile(ms, 0.5), p95_ms=_quantile(ms, 0.95),
            mean_lanes=stats["tick_phases"].get(key, {}).get("mean_lanes"))
    log("front", programs=run["calls"], anchor_reasons=stats["anchor_reasons"])
    log("front", kernel="flash_encoder_attn", launches=counts["flash_encoder_attn"],
        launches_by_SxT={f"{s}x{t}": n for (s, t), n in sorted(counts["k1_shapes"].items())},
        per_tick=round(counts["flash_encoder_attn"] / max(stats["n_ticks"], 1), 2))
    _check_k1_bodies("front", counts)
    if stats["n_failed_ticks"]:
        raise AssertionError(f"{stats['n_failed_ticks']} batch ticks failed")
    _check_languages("front", run)
    if not all(words):
        raise AssertionError(f"a session got no words: {words}")
    if not {"anchor", "inc"} <= set(stats["tick_phases"]):
        raise AssertionError(f"expected anchor and inc ticks, got {list(stats['tick_phases'])}")
    _check_front_kernels("front", run)
    if not counts["flash_encoder_attn"]:
        raise AssertionError("K1 never launched in the front phase")
    return run


def phase_reference_large(tok_for) -> None:
    """One whole-group anchor (the fused mel at 128 mels) then two pooled
    inc ticks, two sessions, f32, large-v3 widths with the depth cut to 4+4
    layers, on the card (K1, K2, K3) and on the CPU (plain versions) in
    lockstep: the modes and the integer outputs must be equal, no_speech_p
    within 1e-4."""
    from dataclasses import replace

    from whisperlivekit_tpu_torch.engine.core import MODEL_DIMS
    from whisperlivekit_tpu_torch.models.whisper import model as wm
    from whisperlivekit_tpu_torch.streaming import alignatt as A
    from whisperlivekit_tpu_torch.streaming.dispatch import run_tick_batch

    dims = replace(MODEL_DIMS["large-v3"], n_audio_layer=4, n_text_layer=4)
    tok = tok_for(dims)
    sides = {}
    for side, dev in (("card", CARD), ("cpu", "cpu")):
        model = wm.init_params(dims, torch.Generator().manual_seed(3), torch.float32, dev)
        # the large-v3 tail (the cut depth would pick another model class's)
        eng = A.AlignAttEngine(model, dims, tok, A.AlignAttConfig(language="en", enc_tail_frames=160,
                                                                  mel_pallas=True))
        pool, enc_pool = A.AudioPool(4, device=dev), A.EncPool(5, dims, torch.float32, dev)
        xkv = A.XKVAllocator.for_engine(eng, 2, epoch_period=50)
        sessions = [A.AlignAttSession(eng) for _ in range(2)]
        for s in sessions:
            s.pool, s.enc_pool, s.xkv_alloc = pool, enc_pool, xkv
        sides[side] = (eng, pool, enc_pool, xkv, sessions)
    pcms = [speech_pcm(8.0, seed=40 + i).astype(np.float32) / 32768.0 for i in range(2)]
    calls = {}
    launched = {"flash_encoder_attn": 0, "xkv_splice": 0, "log_mel_pallas": 0}
    for tick, (a0, a1) in enumerate(((0, 96000), (96000, 112000), (112000, 128000))):
        res = {}
        for side, (eng, pool, enc_pool, xkv, sessions) in sides.items():
            tis = []
            for s, pcm in zip(sessions, pcms):
                s.insert_audio(pcm[a0:a1])
                tis.append(s.prepare_tick(False))
            before = (flash_encoder_attn.launches, xkv_splice.launches, log_mel_pallas.launches)
            A.TICK_PHASE_STATS.clear()
            with torch.inference_mode():
                outs = run_tick_batch(eng, tis, tok, pool=pool, enc_pool=enc_pool, xkv=xkv)
            for s, ti, o in zip(sessions, tis, outs):
                s.finish_tick(ti, o)
            if side == "card":
                launched["flash_encoder_attn"] += flash_encoder_attn.launches - before[0]
                launched["xkv_splice"] += xkv_splice.launches - before[1]
                launched["log_mel_pallas"] += log_mel_pallas.launches - before[2]
            res[side] = (tuple(t.enc_mode for t in tis), outs, sorted(A.TICK_PHASE_STATS))
        (gm, go, gp), (cm, co, cp) = res["card"], res["cpu"]
        ints = lambda o: (o.new_tokens, [int(f) for f in o.frames], o.n_keep, o.reason,  # noqa: E731
                          o.last_attend, o.fire)
        ns_err = max(abs(a.no_speech_p - b.no_speech_p) for a, b in zip(go, co))
        ok = gm == cm and gp == cp and all(ints(a) == ints(b) for a, b in zip(go, co)) and ns_err <= 1e-4
        log("reference", model="large-v3 widths, 4+4 layers, f32 random", tick=tick, modes=gm,
            phases=gp, gpu=[ints(o) for o in go], cpu=[ints(o) for o in co],
            no_speech_err=ns_err, ok=ok)
        if not ok:
            raise AssertionError(f"the card's pooled tick {tick} disagrees with the CPU reference")
        calls.setdefault(gm, 0)
        calls[gm] += 1
    want = {("anchor", "anchor"): 1, ("inc", "inc"): 2}
    if calls != want or not all(launched.values()):
        raise AssertionError(f"expected one whole-group anchor, two inc ticks and all three kernels: "
                             f"{calls} {launched}")
    log("reference", model="large-v3 widths", kernel_launches=launched, ok=True)


LARGE_SESSIONS = 5       # AudioProcessor sessions in process, plus one over WS /asr
LARGE_SECONDS = 20.0
LARGE_PACE = 2.0         # slow enough that windows evict and epochs pass
LARGE_DELAYS = (0.0, 0.0, 0.0, 0.0, 3.0)  # the fifth joins late: a chunked anchor
LARGE_WS_DELAY = 6.0
LARGE_PROGRAMS = ("alignatt_tick_anchor_group", "alignatt_tick_anchor_pooled",
                  "alignatt_tick_inc_skv")
# the programs that encode a full window, where the fused mel (K3) runs
FULL_WINDOW = ("alignatt_tick", "alignatt_tick_anchor", "alignatt_tick_anchor_pooled",
               "alignatt_tick_anchor_group")


def _quantile(xs, q):
    xs = sorted(xs)
    return round(xs[min(int(q * len(xs)), len(xs) - 1)], 1) if xs else None


class Instrumented:
    """Counts the calls of the named tick programs (wrapped on the alignatt
    facade, where the dispatch looks them up), records the peak device
    memory over each call of ``peak_of``, times every dispatched group
    from dispatch to fetch, by mode, and times each language detection on
    the host's clock (the mel, the batch-1 encode and the decoder step,
    which run outside the scheduler's batched tick). Restores everything on
    exit."""

    def __init__(self, programs, peak_of=None):
        from whisperlivekit_tpu_torch.streaming import alignatt as A
        from whisperlivekit_tpu_torch.streaming import dispatch as D

        from whisperlivekit_tpu_torch.streaming.session_plan import AlignAttSession

        self.A, self.D, self.S, self.peak_of = A, D, AlignAttSession, peak_of
        self.calls = dict.fromkeys(programs, 0)
        self.peaks, self.phase_ms, self.detect_ms = [], {}, []
        self.sessions = {}  # id -> every AlignAttSession that prepared a tick, in order

    def _wrap(self, name, real):
        def wrapped(*a, **k):
            self.calls[name] += 1
            if name != self.peak_of:
                return real(*a, **k)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = real(*a, **k)
            torch.cuda.synchronize()
            self.peaks.append(torch.cuda.max_memory_allocated())
            return out
        return wrapped

    def __enter__(self):
        self.reals = {name: getattr(self.A, name) for name in self.calls}
        self.real_dispatch = self.D.dispatch_tick_batch

        def timed_dispatch(*a, **k):
            pends = []
            for mk, idxs, fetch, t_g in self.real_dispatch(*a, **k):
                def timed(fetch=fetch, mk=mk, t_g=t_g):
                    res = fetch()
                    self.phase_ms.setdefault(mk, []).append((time.perf_counter() - t_g) * 1e3)
                    return res
                pends.append((mk, idxs, timed, t_g))
            return pends

        for name, real in self.reals.items():
            setattr(self.A, name, self._wrap(name, real))
        self.D.dispatch_tick_batch = timed_dispatch
        self.real_detect = self.S._maybe_detect_language

        def timed_detect(sess, audio):
            self.sessions.setdefault(id(sess), sess)
            before, t = sess.detected_language, time.perf_counter()
            self.real_detect(sess, audio)
            if before is None and sess.detected_language is not None:
                self.detect_ms.append((time.perf_counter() - t) * 1e3)

        self.S._maybe_detect_language = timed_detect
        return self

    def __exit__(self, *exc):
        for name, fn in self.reals.items():
            setattr(self.A, name, fn)
        self.D.dispatch_tick_batch = self.real_dispatch
        self.S._maybe_detect_language = self.real_detect


def _reset_kernel_counts() -> None:
    """Every kernel's launch counts to 0: the main path's run counts from here."""
    flash_encoder_attn.launches = 0
    flash_encoder_attn.shapes.clear()
    flash_encoder_attn.bodies.clear()
    flash_encoder_attn.splits.clear()
    xkv_splice.launches = 0
    log_mel_pallas.launches = 0
    log_mel_pallas.shapes.clear()
    log_mel_pallas.routes.clear()


def _kernel_counts() -> dict:
    return dict(flash_encoder_attn=flash_encoder_attn.launches, xkv_splice=xkv_splice.launches,
                log_mel_pallas=log_mel_pallas.launches, k1_shapes=dict(flash_encoder_attn.shapes),
                k1_bodies=dict(flash_encoder_attn.bodies), k1_splits=dict(flash_encoder_attn.splits),
                k3_shapes=dict(log_mel_pallas.shapes), k3_routes=dict(log_mel_pallas.routes))


def _check_k1_bodies(phase: str, counts: dict) -> None:
    """Every K1 launch of a bf16 main path took a tensor-core (wgmma) body."""
    bodies, launches = counts["k1_bodies"], counts["flash_encoder_attn"]
    log(phase, kernel="flash_encoder_attn", launches_by_body=bodies,
        launches_by_split={str(k): n for k, n in sorted(counts["k1_splits"].items())})
    if sum(bodies.get(b, 0) for b in WGMMA_BODIES) != launches:
        raise AssertionError(f"{phase}: K1 launches off the wgmma bodies: {bodies} of {launches}")


async def _main_path_large() -> dict:
    from aiohttp import web

    from whisperlivekit_tpu_torch.engine.core import TranscriptionEngine, WLKConfig
    from whisperlivekit_tpu_torch.server.app import WLKServer
    from whisperlivekit_tpu_torch.session.processor import AudioProcessor
    from whisperlivekit_tpu_torch.streaming import alignatt as A

    # one 8-wide lane group; an 8 s window evicts every 4 s, and a group
    # epoch passes every 4 pooled inc ticks
    config = WLKConfig(model_size="random:large-v3", lan="auto", pcm_input=True, vac=False,
                       param_dtype="bfloat16", log_level="WARNING", max_batch_sessions=LG,
                       audio_max_len=8.0)
    t0 = time.perf_counter()
    engine = TranscriptionEngine(config)
    engine.asr.cfg.mel_pallas = True  # an AlignAttConfig field: WLKConfig has no flag for it
    init_s = time.perf_counter() - t0
    if engine.device.type != "cuda":
        raise AssertionError(f"engine landed on {engine.device}, not the card")
    runner = web.AppRunner(WLKServer(config, engine=engine).app)
    await runner.setup()  # startup runs the engine's warmup tick
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    host, port = runner.addresses[0][:2]
    setup_s = time.perf_counter() - t0
    try:
        with Instrumented(LARGE_PROGRAMS + FULL_WINDOW[:2], peak_of="alignatt_tick_anchor_group") as ins:
            _reset_kernel_counts()
            engine.scheduler.reset_stats()
            t1 = time.perf_counter()
            pcms = [speech_pcm(LARGE_SECONDS, seed=20 + s) for s in range(LARGE_SESSIONS + 1)]
            procs = [AudioProcessor(transcription_engine=engine) for _ in range(LARGE_SESSIONS)]
            texts = await asyncio.gather(
                *(_feed_processor(p, pcm, LARGE_PACE, d) for p, pcm, d in zip(procs, pcms, LARGE_DELAYS)),
                _feed_websocket(f"http://{host}:{port}/asr", pcms[-1], LARGE_PACE, LARGE_WS_DELAY),
            )
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            counts = _kernel_counts()
        langs, line_langs = _session_languages(ins, procs, texts)
        stats = engine.scheduler.stats()
        phases = dict(A.TICK_PHASE_STATS)
        eng, xkv = engine.scheduler.engine, engine.scheduler.xkv
        geom = dict(n_audio_ctx=eng.dims.n_audio_ctx, n_text_layer=eng.dims.n_text_layer,
                    pool_t=xkv.groups[0].k.shape[-1], tail_frames=eng.cfg.enc_tail_frames,
                    prefix_buckets=eng.prefix_buckets, group_width=xkv.group_width,
                    refresh_rows=(A.SKV_REFRESH_ROWS, A._skv_full_refresh_rows(eng, xkv.skv_width)))
    finally:
        await runner.cleanup()
        TranscriptionEngine.reset()
    return dict(texts=texts, langs=langs, line_langs=line_langs, wall=wall, init_s=init_s,
                setup_s=setup_s, counts=counts,
                stats=stats, phases=phases, calls=ins.calls, peaks=ins.peaks,
                phase_ms=ins.phase_ms, detect_ms=ins.detect_ms, geom=geom)


def _check_front_kernels(phase: str, run: dict) -> None:
    """K3 launched once on every full-window tick of the run, and on some,
    each time on the bulk-copy route (30 s rows, 16-byte aligned)."""
    full = sum(run["calls"][name] for name in FULL_WINDOW)
    k3, routes = run["counts"]["log_mel_pallas"], run["counts"]["k3_routes"]
    log(phase, kernel="log_mel_pallas", launches=k3, full_window_ticks=full, launches_by_route=routes,
        launches_by_B_N_mels={"x".join(map(str, k)): n for k, n in sorted(run["counts"]["k3_shapes"].items())})
    if not full or k3 != full:
        raise AssertionError(f"K3 launched {k3} times over {full} full-window ticks: {run['calls']}")
    if routes.get("bulk", 0) != k3:
        raise AssertionError(f"{phase}: K3 launches off the bulk route: {routes} of {k3}")


def _session_languages(ins: Instrumented, procs: list, texts: list) -> tuple:
    """Each session's detected language, read from its server-side session
    (the in-process ones, then the one behind ``WS /asr``), and the
    languages its transcript lines carry. A line carries one only when it
    holds words committed after the detection, so the lines alone cannot
    say whether a session detected."""
    own = [p.transcription.model for p in procs]
    ws = [s for s in ins.sessions.values() if all(s is not o for o in own)]
    langs = [s.detected_language for s in own + ws]
    on_lines = [sorted({lang for _, lang in lines if lang}) for lines in texts]
    return langs, on_lines


def _check_languages(phase: str, run: dict) -> None:
    ms, langs, on_lines = run["detect_ms"], run["langs"], run["line_langs"]
    log(phase, detected_languages=langs, line_languages=on_lines, detections=len(ms),
        detect_ms_p50=_quantile(ms, 0.5), detect_ms_max=_quantile(ms, 1.0))
    if len(langs) != len(on_lines) or not all(langs):
        raise AssertionError(f"a session never detected its language: {langs} over {len(on_lines)} sessions")
    if any(seen not in ([], [lang]) for lang, seen in zip(langs, on_lines)):
        raise AssertionError(f"lines carry another language than their session's: {on_lines} vs {langs}")


def phase_large() -> dict:
    import tempfile

    from whisperlivekit_tpu_torch.engine.core import get_tokenizer
    from whisperlivekit_tpu_torch.harness.vocab import install_standin_vocab

    def tok_for(dims):
        return get_tokenizer(True, num_languages=dims.num_languages, language="en", task="transcribe")

    with tempfile.TemporaryDirectory(prefix="wlk_vocab_") as vocab_dir:
        install_standin_vocab(vocab_dir)
        phase_reference_large(tok_for)
        torch.cuda.empty_cache()
        run = asyncio.run(_main_path_large())
    stats, counts = run["stats"], run["counts"]
    words = [sum(len(t.split()) for t, _ in lines) for lines in run["texts"]]
    shapes = {f"{s}x{t}": n for (s, t), n in sorted(counts["k1_shapes"].items())}
    log("large", model="random:large-v3 bf16", group_width=LG, sessions=len(words),
        audio_s_each=LARGE_SECONDS, pace=LARGE_PACE, words_per_session=words,
        wall_s=round(run["wall"], 3), engine_init_s=round(run["init_s"], 3),
        setup_s=round(run["setup_s"], 3), ticks=stats["n_ticks"],
        avg_lanes=stats["avg_lanes_per_tick"], tick_ms_p50=stats["tick_ms_p50"],
        tick_ms_p95=stats["tick_ms_p95"], word_emission_p50_ms=stats["word_emission_p50_ms"],
        word_emission_p95_ms=stats["word_emission_p95_ms"], failed_ticks=stats["n_failed_ticks"])
    for key, ms in sorted(run["phase_ms"].items()):
        log("large", tick_phase=key, n=len(ms), p50_ms=_quantile(ms, 0.5), p95_ms=_quantile(ms, 0.95),
            mean_lanes=stats["tick_phases"].get(key, {}).get("mean_lanes"))
    log("large", programs=run["calls"], anchor_reasons=stats["anchor_reasons"],
        xkv=stats.get("xkv"),
        anchor_group_peak_GB=round(max(run["peaks"]) / 2**30, 3) if run["peaks"] else None)
    log("large", kernel="flash_encoder_attn", launches=counts["flash_encoder_attn"],
        launches_by_SxT=shapes, per_tick=round(counts["flash_encoder_attn"] / max(stats["n_ticks"], 1), 2))
    _check_k1_bodies("large", counts)
    log("large", kernel="xkv_splice", launches=counts["xkv_splice"],
        per_tick=round(counts["xkv_splice"] / max(stats["n_ticks"], 1), 2))
    if stats["n_failed_ticks"]:
        raise AssertionError(f"{stats['n_failed_ticks']} batch ticks failed")
    if "pool_recovery" in run["phases"]:
        raise AssertionError(f"a lane group recovered: {run['phases']['pool_recovery']}")
    _check_languages("large", run)
    if not all(words):
        raise AssertionError(f"a session got no words: {words}")
    if not all(run["calls"][name] for name in LARGE_PROGRAMS):
        raise AssertionError(f"a pooled program never ran: {run['calls']}")
    if not all(counts[k] for k in ("flash_encoder_attn", "xkv_splice", "log_mel_pallas")):
        raise AssertionError(f"a kernel never launched: {counts}")
    _check_front_kernels("large", run)
    if not (counts["k1_shapes"].get((1500, 1500)) and counts["k1_shapes"].get((160, 160))):
        raise AssertionError(f"K1 did not launch at the encoder's call sites: {shapes}")
    log("large", geometry=run["geom"])
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k3-ab", metavar="LOG_MEL_CU", default=None,
                    help="only time K3 against PR 3/4's DFT-by-product log_mel.cu at this path, in turns")
    args = ap.parse_args(argv)
    if args.k3_ab:
        card = phase_device()
        phase_k3_ab(args.k3_ab)
        print(card, flush=True)
        return 0
    watch = LogWatch()
    logging.getLogger().addHandler(watch)
    card = phase_device()
    records = phase_kernels()
    base_launches = phase_main()
    front = phase_front()
    large = phase_large()
    large_records = phase_kernels_large(large["geom"], large["counts"]["k1_shapes"])
    k3_launched = Counter(front["counts"]["k3_shapes"]) + Counter(large["counts"]["k3_shapes"])
    k3_records = phase_kernels_k3(k3_launched)
    # K3's share of the front phase's anchor tick, at its most launched lane count
    b_front = max(front["counts"]["k3_shapes"].items(), key=lambda kv: kv[1])[0]
    anchor_p50 = _quantile(front["phase_ms"].get("anchor", []), 0.5)
    if anchor_p50:
        log("front", k3_at=f"B{b_front[0]}xN{b_front[1]}x{b_front[2]}", k3_ms=round(k3_records[b_front]["ms"], 4),
            anchor_tick_p50_ms=anchor_p50, k3_share_of_anchor=round(k3_records[b_front]["ms"] / anchor_p50, 5))
    logging.getLogger().removeHandler(watch)
    log("log", failures=len(watch.failures), expected_notices=watch.expected)
    if watch.failures:
        raise AssertionError(f"failures were logged during the run: {watch.failures[:5]}")
    jax_mods = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
    if jax_mods:
        raise AssertionError(f"the port's run imported JAX: {jax_mods[:5]}")
    k1_errs = [r["max_abs_err"] for key, r in records.items() if key[2] == "bfloat16"]
    k1_errs += [r["max_abs_err"] for key, r in large_records.items()
                if key[0] == "flash_encoder_attn" and key[3] == "bfloat16"]
    k1 = large_records[("flash_encoder_attn", 1500, 1500, "bfloat16")]
    G = large["geom"]["group_width"]
    k2 = large_records[("xkv_splice", G, "bfloat16")]
    k3 = k3_records[(8, 480000, 80)]
    fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    launches = {"flash_encoder_attn": {"base": base_launches,
                                       "front": front["counts"]["flash_encoder_attn"],
                                       "large": large["counts"]["flash_encoder_attn"]},
                "xkv_splice": {"large": large["counts"]["xkv_splice"]},
                "log_mel_pallas": {"front": front["counts"]["log_mel_pallas"],
                                   "large": large["counts"]["log_mel_pallas"]}}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0][0], "replaces": KERNELS[name][1],
         "launches": sum(launches[name].values()), "launches_by_path": launches[name],
         "max_abs_err": err, **{f: rec[f] for f in fields}, "timed_shape": shape,
         **{f: rec[f] for f in ("dft_bound_ms", "device_ms", "library_device_ms", "body", "load_route",
                                 "stft_chain_ms", "default_front_ms") if f in rec},
         **({"f32_source": KERNELS[name][0][1]} if len(KERNELS[name][0]) > 1 else {})}
        for name, rec, err, shape in (
            ("flash_encoder_attn", k1, max(k1_errs), f"B{G}xH{LH}xS1500xT1500xDh{DH} bf16"),
            ("xkv_splice", k2, 0.0, f"{large['geom']['n_text_layer']}x{G}x{LH}x{DH}"
                                    f"x{large['geom']['pool_t']} bf16"),
            ("log_mel_pallas", k3, max(r["max_abs_err"] for r in k3_records.values()),
             "B8xN480000, 80 mels, f32"),
        )
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
