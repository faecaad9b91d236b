"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):

1. device  — needs CUDA (there is no CPU path); prints the card's name and
             power limit; builds every kernel of the main path from csrc/.
2. kernels — each kernel against its plain PyTorch version on the card, at
             the shapes the main path gives it, with the kernel's and the
             plain version's time (CUDA events); then every prefill bucket
             and a ragged, poisoned T, checked without timing.
3. main    — the port's main path at the full width of Whisper ``base``
             (random weights from a seed): TranscriptionEngine +
             AudioProcessor sessions fed speech-like PCM at full speed, and
             one ``WS /asr`` stream through the port's server on localhost.
             Checks that every session got words, that anchor and inc ticks
             ran, that no tick failed and nothing logged a failure, and that
             each kernel launched during the run.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Imports no JAX.
"""

from __future__ import annotations

import asyncio
import json
import logging
import subprocess
import sys
import time

import numpy as np
import torch

from whisperlivekit_tpu_torch.ops import cuda_build
from whisperlivekit_tpu_torch.ops.flash_encoder import (
    flash_encoder_attn,
    flash_encoder_attn_plain,
)
from whisperlivekit_tpu_torch.streaming.alignatt import AlignAttEngine

PREFIX_BUCKETS = AlignAttEngine.PREFIX_BUCKETS  # prefill S at call site 3

B, H, DH = 8, 8, 64  # Whisper base: 8 heads of 64; 8 concurrent lanes
# (label, S, T, v_transposed): the three call sites of the base form
K1_SHAPES = (
    ("encoder full window", 1500, 1500, False),
    ("encoder tail", 384, 384, False),
    ("prefill cross-attention", 64, 1500, True),
)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # the JAX suite's bars
KERNEL_SOURCE = "whisperlivekit_tpu_torch/csrc/flash_encoder.cu"
KERNEL_REPLACES = "whisperlivekit_tpu/ops/flash_encoder.py:73"


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
    lib = cuda_build.build("flash_encoder")
    ptxas = lib.with_suffix(".ptxas.txt").read_text() if lib.with_suffix(".ptxas.txt").exists() else ""
    regs = [ln.strip() for ln in ptxas.splitlines() if "registers" in ln or "spill" in ln]
    log("device", card=repr(card), torch=torch.__version__, cuda=torch.version.cuda,
        build_s=round(time.perf_counter() - t0, 2), lib=lib.name)
    for ln in regs:
        log("device", ptxas=repr(ln))
    return card


def _qkv(S, T, vt, dtype, seed):
    """Inputs in the layouts the main path hands the kernel: q, k, v as
    strided views of [B, T, H, Dh] projections; at the prefill, k and v as
    the contiguous [B, H, Dh, T] cross-KV."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda", dtype=torch.float32).to(dtype)  # noqa: E731
    q = rnd(B, S, H, DH).transpose(1, 2)
    if vt:
        return q, rnd(B, H, DH, T), rnd(B, H, DH, T)
    return q, rnd(B, T, H, DH).permute(0, 2, 3, 1), rnd(B, T, H, DH).transpose(1, 2)


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


def phase_kernels() -> dict:
    """K1 against its plain version at the three main-path shapes, both
    dtypes, plus one ragged/poisoned case; returns per-shape records."""
    records = {}
    for label, S, T, vt in K1_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _qkv(S, T, vt, dtype, seed=S + T)
            got = flash_encoder_attn(q, k, v, t_valid=T, v_transposed=vt)
            want = flash_encoder_attn_plain(q, k, v, t_valid=T, v_transposed=vt)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = bool(torch.isfinite(got.float()).all().item()) and err <= TOL[dtype]
            ms = _time_ms(lambda: flash_encoder_attn(q, k, v, t_valid=T, v_transposed=vt))
            plain_ms = _time_ms(lambda: flash_encoder_attn_plain(q, k, v, t_valid=T, v_transposed=vt))
            dt = str(dtype).replace("torch.", "")
            log("kernels", kernel="flash_encoder_attn", shape=f"B{B}xH{H}xS{S}xT{T}xDh{DH}",
                call_site=repr(label), dtype=dt, max_abs_err=err, tol=TOL[dtype],
                ms=round(ms, 4), plain_ms=round(plain_ms, 4), ok=ok)
            if not ok:
                raise AssertionError(f"flash_encoder_attn disagrees at {label} {dt}: {err}")
            records[(S, T, dt)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
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
    q, k, v = _qkv(1500, 1500, False, torch.float32, seed=7)
    k = k.clone()
    v = v.clone()
    k[..., 1400:] = 1e4
    v[:, :, 1400:] = -1e4
    got = flash_encoder_attn(q, k, v, t_valid=1400)
    want = flash_encoder_attn_plain(q[..., :, :], k[..., :1400], v[:, :, :1400], t_valid=1400)
    err = (got - want).abs().max().item()
    log("kernels", kernel="flash_encoder_attn", case="t_valid=1400 poisoned", max_abs_err=err)
    if not err <= TOL[torch.float32]:
        raise AssertionError(f"masked columns leak into the output: {err}")
    return records


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
    for dev in ("cuda", "cpu"):
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
            outs[dev] = A.alignatt_tick(model, torch.from_numpy(audio).to(dev), *args, **statics).cpu().numpy()
        launched += flash_encoder_attn.launches - before
    g, c = outs["cuda"], outs["cpu"]
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


async def _feed_processor(processor, pcm: np.ndarray) -> list:
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
        await asyncio.sleep(CHUNK_S / PACE)
    await processor.process_audio(b"")
    await asyncio.wait_for(task, timeout=300)
    await processor.cleanup()
    return [ln.text for ln in last if ln.text]


async def _feed_websocket(url: str, pcm: np.ndarray) -> list:
    import aiohttp

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
                    texts = [ln["text"] for ln in msg.get("lines", []) if ln.get("text")]
            task = asyncio.create_task(receive())
            step = int(16000 * CHUNK_S)
            for i in range(0, len(pcm), step):
                await ws.send_bytes(pcm[i : i + step].tobytes())
                await asyncio.sleep(CHUNK_S / PACE)
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
        # count only the main path's run from here
        flash_encoder_attn.launches = 0
        flash_encoder_attn.shapes.clear()
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
        launches = flash_encoder_attn.launches
        shapes = dict(flash_encoder_attn.shapes)
        stats = engine.scheduler.stats()
        phases = dict(TICK_PHASE_STATS)
    finally:
        await runner.cleanup()
        TranscriptionEngine.reset()
    return dict(texts=texts, wall=wall, setup_s=setup_s, launches=launches, shapes=shapes,
                stats=stats, phases=phases)


def phase_main() -> int:
    import tempfile

    from whisperlivekit_tpu_torch.harness.vocab import install_standin_vocab

    with tempfile.TemporaryDirectory(prefix="wlk_vocab_") as vocab_dir:
        install_standin_vocab(vocab_dir)
        phase_reference()
        run = asyncio.run(_main_path())
    stats = run["stats"]
    words = [sum(len(t.split()) for t in texts) for texts in run["texts"]]
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
    log("main", kernel="flash_encoder_attn", launches=run["launches"], launches_by_SxT=shapes)
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


def main() -> int:
    watch = LogWatch()
    logging.getLogger().addHandler(watch)
    card = phase_device()
    records = phase_kernels()
    launches = phase_main()
    logging.getLogger().removeHandler(watch)
    log("log", failures=len(watch.failures), expected_notices=watch.expected)
    if watch.failures:
        raise AssertionError(f"failures were logged during the run: {watch.failures[:5]}")
    jax_mods = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
    if jax_mods:
        raise AssertionError(f"the port's run imported JAX: {jax_mods[:5]}")
    k = records[(1500, 1500, "bfloat16")]
    print(json.dumps({"kernels": [{
        "name": "flash_encoder_attn", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for key, r in records.items() if key[2] == "bfloat16"),
        "ms": k["ms"], "plain_ms": k["plain_ms"],
        "timed_shape": f"B{B}xH{H}xS1500xT1500xDh{DH} bf16",
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
