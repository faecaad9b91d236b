"""Capacity sweep of the port: concurrent real-time streams per card.

    python -m whisperlivekit_tpu_torch.harness.capacity [--out FILE] [--round R]

Port of the repository's root ``bench.py`` (the JAX package's sweep) onto
the port's tick programs. It times the AlignAtt streaming tick packed over
B lanes for whisper base, large-v3-turbo and large-v3 in the serving
configuration: the base form's encoder-row cache (``alignatt_tick_inc``,
``alignatt_tick_anchor``), and the large form's group-resident cross-KV and
self-KV pools (``alignatt_tick_inc_skv``, with the whole-group re-anchor
``alignatt_tick_anchor_group`` amortized once per eviction block), 8 pinned
decode steps a tick (the gates never fire), audio resident on the card.
Pool dtypes sweep bf16 and float8_e4m3fn (``f8``); ``f8d`` adds the
decoder's weight-only f8 linears (``quantize_decoder_f8``).

Capacity model (as ``bench.py``): a live session needs one tick per
TICK_SECONDS of audio and the scheduler rotates groups of B lanes within
the second, so sustainable streams = max over B of B / amortized tick,
where amortized = ((ANCHOR_EVERY - 1) * inc + anchor) / ANCHOR_EVERY. The
latency-honest peak only admits arms whose amortized tick fits
LATENCY_P50_BUDGET_S; the unconstrained peak stands beside it; f8d is
reported and kept out of both.

Timing: each tick call ends with the ``.cpu()`` of its packed output (the
read the scheduler makes every tick, so it syncs). The first call of each
program is a warm call: it builds the kernels at first use and allocates
cuBLAS's workspace. ``inc_ms`` / ``anchor_ms`` (and so ``streams``) are the
host's wall clock (``perf_counter``), as in ``bench.py``. Each arm also
records ``peak_alloc_gib``, its own footprint: the allocator's peak over
the arm less what was allocated when it started, plus the bytes of the
weights it runs (so neither the other form's weights nor an earlier
caller's tensors count).

Memory: before an arm runs, its resident bytes (``_arm_resident_bytes``,
as ``bench.py`` counts them) plus _TEMP_SAFETY must fit the card's free
bytes, the bytes the allocator holds unused, and the arm's weights (already
resident, and counted in the resident bytes); otherwise the arm is
SKIPPED. ``bench.py``'s ahead-of-time XLA temp probe has no
counterpart (eager PyTorch compiles nothing ahead). An arm that runs out
of card memory is recorded as ``FAILED OutOfMemoryError``, its tensors are
dropped and the sweep goes on; any other exception propagates.

Weights are random from a seed (``init_params``, drawn on the device); the
cost does not depend on them, since the decode steps are pinned. Prints ONE JSON line on stdout:
``{"metric", "value", "unit", "vs_baseline"}``; the sweep's lines and the
``sub_metrics`` line go to stderr. ``main(argv, device="cpu")`` runs on
the CPU (tests); without ``device`` it needs CUDA. Imports no JAX.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import platform
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

TICK_SECONDS = 1.0       # audio consumed per tick per lane
DECODE_STEPS = 8         # pinned decode work per tick
PREFIX_BUCKET = 64
# the pooled (large form) arms model the serving prefix policy: the decode
# prefix is capped at SERVING_PREFIX_CAP, the self-KV pool is cap + commit
# budget + steps + 2 rows, and anchors prefill at the 96 bucket with a
# near-full prefix
SERVING_PREFIX_CAP = 96
SERVING_COMMIT_BUDGET = 16
SERVING_PLEN = 90
ANCHOR_EVERY = 15.0      # ticks between full re-anchors (a 15 s eviction block)
LATENCY_P50_BUDGET_S = 0.5  # the p50 word-emission clause: the latency-honest
                            # peak admits only arms whose amortized tick fits
EOT = 50257
TS_BEGIN = 50364
NO_SPEECH = 50362
SPACE = 220
#: self-KV pool rows of a pooled arm
SERVING_WC = SERVING_PREFIX_CAP + SERVING_COMMIT_BUDGET + DECODE_STEPS + 2

# (model, lane-group widths, tail frames, pool dtypes, is_headline); the
# tails are the engine's defaults (AlignAttEngine.__init__)
SWEEP = [
    ("base", (96,), 384, ("enc",), False),       # the base form's encoder-row cache
    ("large-v3-turbo", (64,), 256, ("bf16",), False),
    # "f8d" = f8 pools + weight-only f8 decoder linears (decoder_dtype="f8")
    ("large-v3", (24, 32, 40, 48), 160, ("bf16", "f8", "f8d"), True),
]

#: the reference's best large-model streaming figure: SimulStreaming
#: large-v3-turbo, compute-aware RTF 0.144 on an H100 (BASELINE.md)
BASELINE_STREAMS = 1.0 / 0.144
METRIC = "concurrent_realtime_streams_per_chip_whisper_large_v3"
#: headroom for the programs' transients and the allocator over the resident bytes
_TEMP_SAFETY = 768 << 20


def _suppress(dims, device) -> torch.Tensor:
    s = np.zeros(dims.n_vocab, np.float32)
    s[TS_BEGIN:] = -np.inf
    return torch.from_numpy(s).to(device)


def _align(dims, name, device) -> tuple:
    from ..models.whisper.dims import default_alignment_heads

    pairs = np.asarray(default_alignment_heads(dims, name), np.int32).reshape(-1, 2)
    return (torch.from_numpy(np.ascontiguousarray(pairs[:, 0])).to(device),
            torch.from_numpy(np.ascontiguousarray(pairs[:, 1])).to(device))


def _core_args(dims, B, rng, suppress_mask, align_layers, align_heads,
               bucket=PREFIX_BUCKET, plen=20, device="cpu") -> tuple:
    """The 16 core arguments of every tick program, the prefix drawn from
    ``rng`` as ``bench.py`` draws it."""
    prefix = np.full((B, bucket), EOT, np.int32)
    prefix[:, 0:4] = [50258, 50259, 50359, 50363]
    prefix[:, 4:plen] = rng.integers(100, 40000, (B, plen - 4))

    def full(value, dtype):
        return torch.full((B,), value, dtype=dtype, device=device)

    return (
        torch.from_numpy(prefix).to(device),
        full(plen, torch.int32),
        full(0, torch.int32),                 # sot_index
        full(1500, torch.int32),              # content_frames
        full(-200, torch.int32),              # last_attend
        full(False, torch.bool),              # is_last
        full(10**6, torch.int32),             # max_new: cap disabled
        suppress_mask,
        align_layers,
        align_heads,
        -(10**9),                             # frame_threshold: the gate never fires
        10**9,                                # rewind_threshold: never rewinds
        2.0,                                  # nonspeech_prob: never stops
        full(True, torch.bool),               # active
        torch.zeros((dims.n_audio_state,), dtype=torch.float32, device=device),
        0.0,
    )


def _refresh_plan(B: int, R: int, rng) -> tuple:
    """The pooled inc tick's refresh plan: the sot row (position 0) and the
    last 7 prefix rows, as the serving plan (``_skv_refresh_plan``) makes
    it; tokens drawn from ``rng`` as ``bench.py`` draws them."""
    r_pos = np.full((B, R), SERVING_WC - 1, np.int32)
    r_pos[:, 0] = 0
    r_pos[:, 1:] = np.arange(SERVING_PLEN - 7, SERVING_PLEN)[None, :]
    r_tok = np.full((B, R), EOT, np.int32)
    r_tok[:, 0] = 50258
    r_tok[:, 1:] = rng.integers(100, 40000, (B, 7))
    return r_pos, r_tok


def _statics(dims) -> dict:
    return dict(dims=dims, p_max=PREFIX_BUCKET, max_steps=DECODE_STEPS, eot=EOT,
                ts_begin=TS_BEGIN, no_speech_tok=NO_SPEECH, space_tok=SPACE)


def pool_dtype(dt_name: str) -> torch.dtype:
    return torch.float8_e4m3fn if dt_name in ("f8", "f8d") else torch.bfloat16


class Arm:
    """One arm's inputs and pools on a device, drawn from ``rng`` in
    ``bench.py``'s order (audio, prefix, refresh tokens), and its two tick
    calls. The pooled programs update the pools in place; the base form's
    programs update the encoder-row cache in place. ``pool_dt`` and
    ``state_dt`` (default: the arm's pool dtype and bf16) let a reference
    run the same arm in f32."""

    POOLS = ("k", "v", "enc", "sk", "sv", "asum", "asq", "alast", "acount", "tok")

    def __init__(self, model, dims, B: int, dt_name: str, rng, suppress_mask, align_layers,
                 align_heads, tail_frames: int, device, pool_dt=None, state_dt=torch.bfloat16):
        from ..streaming import alignatt as A

        self.A, self.model, self.dims, self.enc = A, model, dims, dt_name == "enc"
        self.tail_frames = tail_frames
        self.audio_pool = torch.from_numpy(
            rng.integers(-3000, 3000, (B, 16000 * 30)).astype(np.int16)).to(device)
        if self.enc:
            self.core = _core_args(dims, B, rng, suppress_mask, align_layers, align_heads, device=device)
        else:
            self.core = _core_args(dims, B, rng, suppress_mask, align_layers, align_heads,
                                   bucket=SERVING_PREFIX_CAP, plen=SERVING_PLEN, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        self.lanes = torch.arange(B, **i32)
        self.enc_lanes = self.lanes + 1
        self.tail_start = torch.full((B,), 1500 - tail_frames, **i32)
        self.win = torch.full((B,), 1500, **i32)
        self.write_start = torch.full((B,), 1500 - 50 - 32, **i32)  # 1 s + margin
        T, d = dims.n_audio_ctx, dims.n_audio_state
        self.state = {"enc": torch.zeros((B + 1, T, d), dtype=state_dt, device=device)}
        if self.enc:
            self.statics = _statics(dims)
            return
        pool_dt = pool_dt or pool_dtype(dt_name)
        L, H, Dh = dims.n_text_layer, dims.n_text_head, dims.head_dim
        K_al = int(align_layers.shape[0])
        shape = (L, B, H, Dh, -(-T // 128) * 128)
        sshape = (L, B, SERVING_WC, H, Dh)
        self.state.update(
            k=torch.zeros(shape, dtype=pool_dt, device=device),
            v=torch.zeros(shape, dtype=pool_dt, device=device),
            sk=torch.zeros(sshape, dtype=state_dt, device=device),
            sv=torch.zeros(sshape, dtype=state_dt, device=device),
            asum=torch.zeros((B, K_al, T), dtype=torch.float32, device=device),
            asq=torch.zeros((B, K_al, T), dtype=torch.float32, device=device),
            alast=torch.zeros((B, K_al, T), dtype=torch.float32, device=device),
            acount=torch.zeros((B,), dtype=torch.float32, device=device),
            tok=torch.zeros((B, dims.n_text_ctx), **i32),
        )
        r_pos, r_tok = _refresh_plan(B, A.SKV_REFRESH_ROWS, rng)
        self.r_pos = torch.from_numpy(r_pos).to(device)
        self.r_tok = torch.from_numpy(r_tok).to(device)
        self.skv_statics = dict(dims=dims, max_steps=DECODE_STEPS, eot=EOT, ts_begin=TS_BEGIN,
                                no_speech_tok=NO_SPEECH, space_tok=SPACE)
        self.statics = dict(_statics(dims), p_max=SERVING_PREFIX_CAP)

    def pools(self) -> list:
        return [self.state[key] for key in self.POOLS]

    def inc_tick(self) -> tuple:
        A, s = self.A, self.state
        if self.enc:
            return A.alignatt_tick_inc(
                self.model, self.audio_pool, s["enc"], self.lanes, self.enc_lanes,
                self.tail_start, self.win, self.write_start, *self.core,
                **self.statics, tail_frames=self.tail_frames,
            )
        # core layout: prefix, prefix_len, sot_index, then the 13 arguments
        # the skv program shares from content_frames on
        return A.alignatt_tick_inc_skv(
            self.model, self.audio_pool, *self.pools(),
            self.lanes, self.enc_lanes, self.tail_start, self.win, self.write_start,
            self.r_tok, self.r_pos, self.core[1], *self.core[3:],
            **self.skv_statics, tail_frames=self.tail_frames,
        )

    def anchor_tick(self) -> tuple:
        A, s = self.A, self.state
        if self.enc:
            return A.alignatt_tick_anchor(
                self.model, self.audio_pool, s["enc"], self.enc_lanes, *self.core, **self.statics,
            )
        return A.alignatt_tick_anchor_group(
            self.model, self.audio_pool, *self.pools(), self.enc_lanes, *self.core, **self.statics,
        )


def time_call(fn, iters: int = 4) -> float:
    """Wall seconds per call of ``fn``, each call ending with the ``.cpu()``
    of its packed output. The first call is the warm call (kernel builds,
    cuBLAS's workspace) and is not timed."""
    fn()[0].cpu()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()[0].cpu()
    return (time.perf_counter() - t0) / iters


def _arm_resident_bytes(dims, B: int, pool_dt: torch.dtype, Wc: int, K_al: int) -> int:
    """Resident bytes of one pooled arm: params + cross-KV/self-KV pools +
    encoder rows + align stats + audio windows (``bench.py``'s count)."""
    Tp = -(-dims.n_audio_ctx // 128) * 128
    d = dims.n_audio_state
    p_bytes = (
        2 * (dims.n_audio_layer + dims.n_text_layer) * 12 * d * d  # qkvo+mlp
        + 2 * dims.n_vocab * d
    )
    kv = 2 * dims.n_text_layer * B * dims.n_text_head * dims.head_dim * Tp
    kv *= pool_dt.itemsize
    skv = 2 * dims.n_text_layer * B * Wc * dims.n_text_head * dims.head_dim * 2
    enc = (B + 1) * dims.n_audio_ctx * d * 2
    stats = 3 * B * K_al * dims.n_audio_ctx * 4
    audio = B * 16000 * 30 * 2
    return p_bytes + kv + skv + enc + stats + audio


def _model_bytes(model) -> int:
    """Bytes of a model's weights, scales and buffers."""
    return sum(t.numel() * t.element_size() for t in model.state_dict().values())


def _device_budget(device, model) -> Optional[int]:
    """Bytes an arm running ``model`` may hold: the card's free bytes, the
    bytes the allocator holds unused, and the model's own (already
    resident, and counted in ``_arm_resident_bytes``). None off CUDA."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    unused = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return int(free) + int(unused) + _model_bytes(model)


def resolve_device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    from ..engine.core import default_device

    return default_device()


def bench_model(name: str, widths, results: dict, tail_frames=384, dtypes=("bf16",),
                device=None) -> float:
    """Sweep one model over ``widths`` x ``dtypes``; fills ``results`` with
    ``bench.py``'s keys (plus ``peak_alloc_gib``) and returns the
    latency-honest peak streams."""
    from ..models.whisper import model as wm
    from ..models.whisper.dims import MODEL_DIMS

    device = resolve_device(device)
    dims = MODEL_DIMS[name]
    base_model = wm.init_params(dims, torch.Generator(device).manual_seed(0), torch.bfloat16, device)
    q_model = None  # built once, for the f8d arms
    rng = np.random.default_rng(0)
    suppress_mask = _suppress(dims, device)
    align_layers, align_heads = _align(dims, name, device)

    best_streams, best_B, best_lat = 0.0, 0, 0.0
    raw_streams, raw_B, raw_lat = 0.0, 0, 0.0
    for B in widths:
        for dt_name in dtypes:
            key = f"{name}_B{B}_{dt_name}"
            if dt_name == "f8d":
                if q_model is None:
                    q_model = wm.quantize_decoder_f8(copy.deepcopy(base_model))
                model = q_model
            else:
                model = base_model
            budget = _device_budget(device, model)
            if dt_name != "enc" and budget is not None:
                # an arm whose resident pools cannot fit is SKIPPED, not run
                # to an out-of-memory error
                est = _arm_resident_bytes(dims, B, pool_dtype(dt_name), SERVING_WC, int(align_layers.shape[0]))
                if est + _TEMP_SAFETY > budget:
                    results[key] = (
                        f"SKIPPED resident {est / (1 << 30):.1f}G + "
                        f"{_TEMP_SAFETY / (1 << 30):.1f}G margin > free {budget / (1 << 30):.1f}G"
                    )
                    print(f"{name} B={B} {dt_name}: skipped ({results[key][8:]})", file=sys.stderr, flush=True)
                    continue
            arm, start = None, 0
            try:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                    start = torch.cuda.memory_allocated(device)
                    torch.cuda.reset_peak_memory_stats(device)
                arm = Arm(model, dims, B, dt_name, rng, suppress_mask, align_layers, align_heads,
                          tail_frames, device)
                t_inc = time_call(arm.inc_tick)
                t_anchor = time_call(arm.anchor_tick, iters=2)
                peak = None
                if device.type == "cuda":
                    own = torch.cuda.max_memory_allocated(device) - start + _model_bytes(model)
                    peak = own / 2**30
                t_amort = ((ANCHOR_EVERY - 1) * t_inc + t_anchor) / ANCHOR_EVERY
                streams = B * TICK_SECONDS / t_amort if t_amort > 0 else 0.0
                results[key] = {
                    "inc_ms": round(t_inc * 1e3, 1),
                    "anchor_ms": round(t_anchor * 1e3, 1),
                    "amortized_ms": round(t_amort * 1e3, 1),
                    "streams": round(streams, 1),
                    "peak_alloc_gib": round(peak, 3) if peak is not None else None,
                }
                mem = f" (peak {peak:.2f} GiB)" if peak is not None else ""
                print(
                    f"{name} B={B} {dt_name}: inc={t_inc*1e3:.1f} ms anchor={t_anchor*1e3:.1f} ms "
                    f"amortized={t_amort*1e3:.1f} ms -> {streams:.1f} streams{mem}",
                    file=sys.stderr, flush=True,
                )
                # f8d (quantized decoder weights) is reported but kept out of
                # both peaks until its transcript quality is measured
                if dt_name != "f8d":
                    if streams > raw_streams:
                        raw_streams, raw_B, raw_lat = streams, B, t_amort
                    if streams > best_streams and t_amort <= LATENCY_P50_BUDGET_S:
                        best_streams, best_B, best_lat = streams, B, t_amort
            except torch.cuda.OutOfMemoryError as e:
                print(f"{name} B={B} {dt_name}: failed ({type(e).__name__})", file=sys.stderr, flush=True)
                results[key] = f"FAILED {type(e).__name__}"
            finally:
                # a failed or finished arm releases its pools before the next
                # arm is built
                arm = None  # noqa: F841
                gc.collect()
                if device.type == "cuda":
                    torch.cuda.empty_cache()
    print(
        f"{name}: peak {best_streams:.1f} streams at B={best_B} "
        f"(p50 tick latency {best_lat*1e3:.0f} ms, <= "
        f"{LATENCY_P50_BUDGET_S*1e3:.0f} ms budget; unconstrained "
        f"{raw_streams:.1f} at B={raw_B}, {raw_lat*1e3:.0f} ms)",
        file=sys.stderr, flush=True,
    )
    results[f"{name}_peak_streams"] = round(best_streams, 1)
    results[f"{name}_peak_streams_unconstrained"] = round(raw_streams, 1)
    results[f"{name}_peak_tick_ms"] = round(best_lat * 1e3, 1)
    return best_streams


def card_label(device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or the
    device's name off CUDA."""
    device = torch.device(device)
    if device.type != "cuda":
        return str(device)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return out.strip().splitlines()[device.index or 0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def headline(streams: float) -> dict:
    """The one stdout line: the headline model's latency-honest peak."""
    return {
        "metric": METRIC,
        "value": round(streams, 1),
        "unit": "streams",
        "vs_baseline": round(streams / BASELINE_STREAMS, 2),
    }


def sweep(device=None) -> tuple:
    """Run every model of SWEEP; returns (the headline JSON object, the
    sub-metrics)."""
    device = resolve_device(device)
    results: dict = {}
    value = 0.0
    for name, widths, tail, dtypes, is_headline in SWEEP:
        streams = bench_model(name, widths, results, tail_frames=tail, dtypes=dtypes, device=device)
        if is_headline:
            value = streams
    return headline(value), results


def artifact(headline_obj: dict, results: dict, device, round_=None) -> dict:
    """The ``--out`` artifact (what harness/capacity_table.py renders)."""
    return {
        "round": round_,
        "device": card_label(device),
        "platform": platform.platform(),
        "headline": headline_obj,
        "sub_metrics": results,
    }


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the full sweep as a JSON artifact")
    ap.add_argument("--round", default=None, help="stamp for --out")
    args = ap.parse_args(argv)
    device = resolve_device(device)
    headline_obj, results = sweep(device)
    print(json.dumps({"sub_metrics": results}), file=sys.stderr, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact(headline_obj, results, device, args.round), f, indent=1)
            f.write("\n")
    print(json.dumps(headline_obj), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
