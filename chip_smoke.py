"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --k3-ab build/parent/log_mel.cu
    python3 chip_smoke.py --k4

The second form builds the kernels, then times only K3 against PR 3/4's
DFT-by-product kernel (another log_mel.cu, e.g. the parent commit's copy in
a directory .gitignore lists) in turns, old, new, new, old, at B 1, 2, 4
and 8, 80 and 128 mels, the 30 s window and a ragged 2 s length: both held
to the plain version, timed by events and by graph replay, beside the new
kernel's bound and its share of it, and its check below. The third builds
the kernels and runs only the kernels_k4 phase below.

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
   kernels_k4 — K4 (dry_penalty, the decode step's DRY penalty) against its
             plain version bit for bit at turbo's vocabulary and text
             context, 64 and 96 lanes, the rows harness/dry_cases.py
             plants (runs under, at and over the 50-token cap, shared next
             ids, empty, short, special and wrapping lanes): the kernel's ms (events), device ms (a graph's replay),
             the host's enqueue of one call, the plain version's ms and
             enqueue, the launches one call of each makes (torch.profiler)
             and the byte bound. Then one decode step of _tick_core at
             large-v3-turbo's decoder widths, 64 lanes, with K4 and with
             the plain version patched in: equal packed outputs, the
             kernels and copies a step puts on the card, a step's wall ms.
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
6. f8      — the f8 large form: the large phase's reference (4+4 layers,
             f32) with the decoder quantized (quantize_decoder_f8) and
             float8_e4m3fn pools, card against CPU (integer outputs equal,
             pool bytes equal up to one f8 step where the two devices' f32
             sums straddle a rounding boundary), then the large phase's
             sessions on ``random:large-v3`` bf16 with decoder_dtype="f8"
             and xkv_cache_dtype="f8". Checks as the large phase, and that
             the pools are float8_e4m3fn at half the large phase's cross-KV
             bytes per slot, that every decoder-block linear is f8 and that
             every K2 launch took the f8 route; prints its tick, word
             emission, peak memory and weight bytes beside the large
             phase's, and what widening the f8 weights costs per step.
7. beam    — the streaming beam tick: beams 1 (equal to the greedy tick)
             and 4 in f32 on the card against the CPU, then ``random:base``
             bf16 with beams=4: AudioProcessor sessions and one ``WS /asr``
             stream, each session's ticks solo (not through the
             BatchScheduler). Checks words on every session and that K1
             launched; then K1 in bf16 against its plain version at every
             (S, T) that run launched, at its batch (the encoder at one
             lane, the prefill at 4 beams), failing on any it did not
             check.
8. load    — a large-v3-turbo checkpoint at full width (1280 wide, 32+4
             layers, 128 mels), written as an OpenAI .pt of f16 tensors
             drawn from a seed (about 1.6 GB, in a temporary directory,
             deleted at the end), loaded onto the card with load_model and
             held bit for bit to the same file loaded on the CPU (load
             seconds, peak host RSS, peak card memory); then served by
             TranscriptionEngine(model_path=...) with mel_pallas=True through
             create_app on localhost: POST /v1/audio/transcriptions twice in
             json at once, then in verbose_json; WS /v1/listen and WS /asr at
             once; and the CLI's transcribe (TestHarness) in this process.
             Checks every answer (200s, clean closes), that the two json
             posts agree, that no tick failed and no group recovered, and
             that K1 (wgmma), K2 and K3 (bulk route) launched.
9. groups  — the large form with two lane groups resident, and the
             whole-group anchor's memory budget: at large-v3-turbo widths
             with the encoder cut to 4 layers, f32, four sessions in two
             2-wide groups on the card and on the CPU; the card's engine
             measures the whole-group anchor's transient through its warm
             pass (precompile_serving_programs) and its guard decides from
             that and the card's free bytes (the CPU is handed the card's
             figures). Group 1 re-anchors while group 0 stays resident:
             both devices take the whole-group program with equal integer
             outputs, and group 0's pools keep every bit; the same anchor,
             started again from group 1's copied pools with the guard given
             one byte too few, takes the chunked program with the same
             integer outputs and pools within 1e-4. Then
             ``random:large-v3-turbo`` bf16 at full width with 8-wide
             groups: the scheduler's warm pass (each program's seconds and
             transient bytes), the transient at every prefix bucket a
             pooled anchor takes (it must not grow as the bucket shrinks),
             then 12 AudioProcessor sessions and one ``WS /asr`` stream
             joining together, in real time (two groups, 8 + 5). Checks
             that every guard decision (printed with its free bytes,
             transient, margin and answer) that ran the whole-group anchor
             with both groups resident read measured bytes, that there was
             one, that each such call's peak over its starting allocation
             stayed within its transient plus the margin, that every
             session got words, that no tick failed and no group
             recovered, and that K1 and K2 launched. Then both anchor
             routes timed at the group's width on scratch pools, in turns,
             and the transient at the default lane caps (turbo 64 lanes,
             large-v3 24 with bf16 and with f8 pools).
10. la     — offline decoding and the re-transcription policies: decode at
             temperature 0, beam_decode at 4 beams and transcribe with word
             timestamps over two windows, in f32 at base widths with 2+2
             layers, on the card (K1's f32 body) against the CPU (equal
             tokens, segments and word times); then ``random:base`` bf16
             under ``backend_policy="localagreement"``, all at once:
             AudioProcessor sessions and one ``WS /asr`` stream fed in real
             time, one session of a ``windowed`` engine, one ``POST
             /v1/audio/transcriptions`` and the CLI's ``transcribe
             --backend-policy localagreement`` in this process. Checks
             words on every session after its final flush (and logs how
             many each had committed before it), the REST status and the
             CLI's return code, that K1 launched; prints the transcribe
             calls' ms, decode attempts and steps per window, the ms of a
             greedy step and the device's busy share over one call
             (torch.profiler). Then K1 in bf16 against its plain version at
             every (S, T) that run launched, failing on any it did not
             check.
11. diar_tr — diarization and translation: Sortformer at full width
             (SortformerDims: 128 mels, an 18-layer conformer at 512, an
             18-layer head at 192, 4 speakers, spkcache and FIFO 188) over
             20 chunks and NLLB at 600M widths with 2+2 layers (the greedy
             tokens at three pad buckets), in f32 on the card against the
             CPU; then ``random:base`` bf16 with ``diarization=True`` and
             ``target_language="fr"``: Sortformer from a ``.nemo`` of seeded
             f32 tensors in NeMo's layout written at full width (about half
             a GB, in a temporary directory, deleted at the end) and
             converted onto the card at engine start, NLLB at 600M widths in
             bf16 (12+12 layers, seeded, a stand-in tokenizer) installed as
             the engine's shared model; AudioProcessor sessions and two
             ``WS /asr`` streams (one ``?target_language=de``), fed in real
             time with one pause each (``vac``: the pause commits the open
             translation on the event loop's thread). Checks words,
             Sortformer segments and speakers on every session's lines, an
             NLLB translation merged into every session, both target
             languages, that no tick failed and that K1 launched; prints the
             ms per Sortformer chunk, the translate calls (ms inside and
             waiting for the model's lock, steps, ms and launches a step,
             the ms on the loop's thread, the lag from a committed token to
             its translation), the lock A/B, each model's card memory and
             the word emission beside the main phase's. Then K1 in bf16
             against its plain version at every (S, T) that run launched
             (the encoder's full window and tail, the prefill buckets).
12. vad     — the batched Silero VAD (vad_backend="jax-batched"): a
             stand-in in Silero v6's layout written under build/ from fixed
             seeds (harness/vad_checkpoint.py, its head calibrated on audio
             of other seeds), its tower over 64 lanes x 90 frames on the
             card against the CPU (probabilities, h and c within 2e-4, the
             context exact) under the smoke's TF32 flags and under torch's
             defaults (and printed with both on), and 8 lanes stepped
             together against one-lane runs (1e-5); then ``random:base``
             bf16 with ``vac=True``: AudioProcessor sessions and one ``WS
             /asr`` stream fed in real time together. Checks words on every
             session, that every gate opened in the first voiced span,
             closed inside the pause and opened after it, that the
             scheduler stepped more than one lane at once, that no tick
             failed and that K1 launched; prints the VAD's sub-steps, lanes
             a sub-step, ms a sub-step on the event loop's thread (the read
             included), each chunk's await of the VAD, then direct
             sub-steps' ms at 1-256 lanes and kernels a sub-step
             (torch.profiler), the pool's bytes, and the word emission
             beside the main phase's. The same sessions then run on the
             host path (vad_backend="auto": torch.jit on the CPU in a
             worker thread) beside it, checked the same way. Then K1 in
             bf16 against its plain version at every (S, T) the batched run
             launched.
13. causal  — Qwen3-ASR causal: at the 0.6B model's full widths with 4+4
             layers in f32, two blocks appended and a hypothesis decoded on
             the card against the CPU (tokens and each block's top-8 ids
             equal, logits within 1e-4, and the same card run with TF32 on
             outside 1e-4), and two sessions through the pooled lanes against the same two
             on local caches on the card (equal words); then the 0.6B model
             at full width and depth (24-layer tower, 28-layer Qwen3) in
             bf16 from a checkpoint directory written from a seed (about
             1.8 GB, in a temporary directory, deleted at the end), served
             with the pooled lanes (CausalBatchService, OpBatcher):
             AudioProcessor sessions and one ``WS /asr`` stream fed in real
             time. Checks words on every session after its final flush, an
             append batch that packed two sessions or more and nothing
             logged; prints the ms of each op batch (to a synchronize) by
             op and size, decode steps, the ms and launches a step of a
             traced decode alone, the pools' bytes per lane, peak card
             memory over the weights, and the word emission (a tick's call
             to its result, p50 / p95).
14. voxtral — Voxtral: at Voxtral-Mini-3B's widths with 2+2 layers in f32
             on the card against the CPU (greedy tokens and the top-8 ids
             equal, logits within 1e-4, and the same card run with TF32 on
             outside 1e-4); then one checkpoint at those widths with 4+4
             layers in bf16 (written from a seed, deleted at the end)
             served twice: by Voxtral realtime (the causal machinery,
             pooled lanes; AudioProcessor sessions, checked and printed as
             the causal phase) and by Voxtral offline under the windowed
             policy (AudioProcessor sessions and one ``POST
             /v1/audio/transcriptions``, a stand-in decode of the token
             ids, VOX_PINNED_NEW new tokens a call). Checks words on every
             session and in the post, and that K1 launched on tensor cores;
             prints a transcribe's ms and launches a step alone and the
             backend lock's A/B. Then K1 in bf16 against its plain version
             at every (S, T) that run launched.
15. train   — the structured-weights trainer (harness/train_structured.py,
             parallel/train.py): the train step at base widths with 2+2
             layers, f32, batch 2, on the card against the CPU (every
             step's loss, every gradient of the first, the weights after
             three AdamW steps under the trainer's warmup-cosine schedule;
             without and with alignment supervision; no kernel launched);
             then the trainer through its entry point at full base width
             (6+6 layers, f32, batch 8, 30 s windows, 48 tokens) on a
             small generated dataset in a temporary directory. Checks that
             every loss is finite, that the mean of the last 10 is below
             the first, that no kernel launched inside a train step and
             that every encoder q/k/v weight got a gradient; prints ms a
             step, peak card memory, the losses, and the bf16 eval's greedy
             token accuracy and alignment sharpness (K1 may launch there).
             The npz must read back bit for bit as the native directory
             saved beside it; the native directory is then served
             (TranscriptionEngine(model_path=...), two AudioProcessor
             sessions fed the trainer's event audio in real time, with
             ``profile_dir``). Checks that no tick failed, that K1
             launched and that the first ticks' trace holds the card's
             kernels and the CPU's ops; prints each
             session's words and WER against the events' words, the kept
             tokens per lane tick and the ticks' stop reasons (end of text
             among them). Then K1 in bf16 against its plain version at every
             (S, T) that run launched.
16. capacity — the capacity sweep (harness/capacity.py, the twin of the
             repository's bench.py): one arm at large-v3-turbo widths with
             the encoder cut to 4 layers, f32, 2 lanes, on the card against
             the CPU (the whole-group anchor, then the pooled inc tick:
             packed integers equal, no_speech_p and every pool within
             1e-4); then ``bench_model`` at full width for the base form's
             arm at 96 lanes and large-v3 at 24 lanes with bf16, f8 and f8d
             pools. Prints each arm's inc, anchor and amortized wall ms, its
             own peak allocation (its weights included, nothing the phase
             or an earlier one holds besides) and the streams. Checks that every arm ran, that K1 launched on tensor
             cores and K2 in the large-v3 arms, two thirds of its launches
             (the f8 and f8d arms') on the f8 route; then K1 in bf16 against
             its plain version at every (S, T) the base arm launched, at 96
             lanes.
17. e2e    — the end-to-end serving benchmark (harness/e2e_serving.py, the
             twin of scripts/bench_e2e_serving.py) through its ``run``:
             ``random:large-v3`` with f8 pools, 16 sessions (5 s poured, 10
             s untimed, 20 s measured, after its 2-session priming run), the
             VAD on with the Silero stand-in of the vad phase. Prints the
             summary (word emission p50 / p95, keep-up, sustained streams,
             the VAD that served, the card) and the scheduler's counters.
             Checks that no session was rejected or went without output,
             that no tick failed and no group recovered in any of the
             benchmark's windows, that the stand-in served, and that K1 and
             K2 (on the f8 route) launched. The summary is kept (its --out)
             for the table phase.
18. ab     — the inc-vs-exact A/B (harness/ab_inc_exact.py, the twin of
             scripts/ab_inc_exact.py): ``run_model`` and ``run_decoder_ab``
             at base widths with 2+2 layers in f32, the same seeded weights
             on the card and on the CPU, 12 ticks, the cross-KV pools off
             and forced on (every integer field equal: tick mix, gate
             frames, committed tokens and their agreement; the float fields
             within 1e-4); then at full width ``run_model("large-v3", 0.75,
             ...)`` (45 ticks of speech-like audio, bf16 pools: the eviction
             re-anchor runs), ``run_decoder_ab("large-v3", ..., "f8")`` over
             22 ticks (bf16 against f8 decoder linears, f8 pools) and
             ``run_model("base", 1.0, ...)`` on the train phase's npz with
             its event audio, reset every 30 s. Prints each result dict
             (encoder divergence, gate-frame flips, token agreement, truth
             agreement on the trained weights). Checks that anchor and inc
             ticks both ran and the divergence has samples, that both arms
             committed tokens, that K1 launched on tensor cores in every run
             and K2 in the large-v3 runs only, on the f8 route in the f8 run
             only.
19. tick_cost — the serving tick by phase (harness/e2e_tick_cost.py, the
             twin of scripts/probe_e2e_tick_cost.py): large-v3 bf16 weights
             from a seed, f8 pools, 24 sessions wired to a BatchScheduler's
             pools, 20 ticks of 1 s. Prints every tick's lanes, modes and
             prepare / tick wall / tick device / finish ms, the summary (p50 / p95 after 5
             warm ticks, the dispatch's phases) and the scheduler's warm
             pass seconds, beside the e2e phase's scheduler tick p50 / p95.
             Checks that every tick after the first served 24 lanes, that
             the modes include anchor_xkv and inc_xkv, and that K1 (tensor
             cores) and K2 (all on the f8 route) launched.
20. table  — the capacity page (harness/capacity_table.py, the twin of
             scripts/gen_capacity_table.py) rendered from the capacity
             phase's arms and the e2e phase's summary, both written as the
             programs' --out artifacts in a temporary directory (nothing
             under docs/). Prints the page's rows. Checks that every arm the
             capacity phase ran has its row with the same numbers, that the
             e2e rows are there and that the page names the card.
21. scatter — the policy x model sweep (harness/scatter.py, the twin of
             scripts/run_scatter_benchmark.py) on ``random:base`` over a
             dataset it writes: one 4 s clip of event audio with its words
             as the reference; all three policies, aware and unaware,
             --compare-exact (8 points; the LocalAgreement and windowed
             backends pinned as in the la phase). Prints every point.
             Checks that every point has its rtf and wer, that the exact
             and incremental points are both there and that K1 launched
             on tensor cores.
22. qwen3_capacity — the causal path's capacity (harness/capacity_qwen3.py,
             the twin of scripts/bench_qwen3_tpu.py) at Qwen3-ASR-0.6B's
             full dims (24-layer tower, 28-layer Qwen3, bf16), B 8-64.
             Prints each B's tick ms, streams and decode steps. Checks that
             every B ran (none out of memory) and recorded its steps.
             Then K1 in bf16 against its plain version at every (S, T) the
             ab phase's base run and the scatter sweep launched, at one
             lane.
23. kernels — the large form's kernels at the shapes its engines give them:
             K1 at the encoder's two shapes, every prefix bucket over the
             dense cross-KV and over the pool, and both refresh widths, and
             at every (S, T) the large, f8, load, groups, capacity, e2e,
             tick_cost and ab runs launched (the ab sessions' one-lane
             groups too); K2
             against its plain version exactly, bf16, f32 and float8_e4m3fn
             pools (f8 from bf16 tails, and from f32 tails at the group's
             width; the tails then hold overflow, non-finite, boundary and
             subnormal values), at each run's pool depth and group width
             and at 24 lanes, with edge and idle lanes. Then K3 at every lane count
             the runs launched (and 4 and 8), at 80 and 128 mels, with a
             speech-like lane, an all-zero lane and a lane silent past 5 s;
             at a ragged length (rows not 16-byte aligned) at 1, 2 and 3
             lanes, and from a row 4 bytes past alignment, both taking the
             gather route; timed beside two front ends the port does not
             run in its place (cuFFT's torch.stft chain, and audio/mel.py's
             log_mel_spectrogram, the main path's without mel_pallas).

The front and large phases also time each language detection on the
host's clock. The line before the last is the card's name and power limit,
the one before it the kernels' JSON record (K2's with its f8 route's own
record under "f8"), with each kernel's bound: the
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
import contextlib
import ctypes
import json
import logging
import math
import shutil
import subprocess
import sys
import tempfile
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
from whisperlivekit_tpu_torch.harness.dry_cases import EOT, greedy_loop_args, planted_rows
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
from whisperlivekit_tpu_torch.ops.dry import dry_penalty, dry_penalty_plain
from whisperlivekit_tpu_torch.ops.f8 import to_e4m3fn
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
    "dry_penalty": (("whisperlivekit_tpu_torch/csrc/dry_penalty.cu",),
                    "none: XLA fuses whisperlivekit_tpu/streaming/alignatt.py dry_penalty"),
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
        "Audio buffer too large",       # backpressure when a feed outruns its ticks
        "No ASR output for",            # LocalAgreement's reset of a buffer that committed nothing
        "qwen3 tokenizer files absent",   # the seeded checkpoint directories hold no tokenizer
        "voxtral tokenizer files absent",
        "Voxtral tokenizer.json missing",
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


# values the f8 cast must map as JAX does: past 464 and +-inf to NaN with
# their sign, NaN, the 448/464 boundary, subnormals, -0
K2_F8_EDGES = (447.9, 448.0, 463.9, 464.0, 464.1, 1e4, -1e4, float("inf"), float("-inf"),
               float("nan"), -0.0, 2.0 ** -10, 3 * 2.0 ** -10, -2.0 ** -8, 1e-30)


def _check_k2(shape, win_list, dtype, tail_dtype=None) -> dict:
    """K2 against its plain version at one pool shape, bit for bit, idle
    lanes untouched; timed (CUDA events, and the device alone from a
    graph's replay), logged. ``dtype`` is the pools', ``tail_dtype`` the
    tails' (default the pools'); float8 pools get tails holding the edge
    values of the cast (K2_F8_EDGES) on 5 % of their elements."""
    f8 = dtype == torch.float8_e4m3fn
    tail_dtype = tail_dtype or dtype
    win = torch.tensor(win_list, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    pool = lambda: to_e4m3fn(rnd(*shape)) if f8 else rnd(*shape).to(dtype)  # noqa: E731
    pk, pv = pool(), pool()

    def tail():
        t = rnd(*shape[:-1], W_SPLICE)
        if f8:
            edges = torch.tensor(K2_F8_EDGES, device="cuda")
            pick = torch.randint(len(K2_F8_EDGES), t.shape, generator=g, device="cuda")
            t = torch.where(torch.rand(t.shape, generator=g, device="cuda") < 0.05, edges[pick], t)
        return t.to(tail_dtype)
    tk, tv = tail(), tail()
    want_k, want_v = xkv_splice_plain(pk, pv, tk, tv, win)
    idle = [i for i, w in enumerate(win_list) if w == 0]
    idle_before = pk[:, idle].clone()
    xkv_splice(pk, pv, tk, tv, win)
    torch.cuda.synchronize()
    ibits = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8}.get(dtype, torch.int32)
    exact = (torch.equal(pk.view(ibits), want_k.view(ibits))
             and torch.equal(pv.view(ibits), want_v.view(ibits))
             and torch.equal(pk[:, idle].view(ibits), idle_before.view(ibits)))
    nan_bytes = int(want_k.view(torch.uint8).bitwise_and(0x7F).eq(0x7F).sum()) if f8 else None
    del want_k, want_v, idle_before
    ms = _time_ms(lambda: xkv_splice(pk, pv, tk, tv, win))
    device_ms = _time_graph_ms(lambda: xkv_splice(pk, pv, tk, tv, win))
    plain_ms = _time_ms(lambda: xkv_splice_plain(pk, pv, tk, tv, win), iters=5)
    # the tails of the lanes with win > 0 read once and written once into
    # the pools, K and V
    live = (len(win_list) - len(idle)) / len(win_list)
    moved = int(2 * tk.numel() * (tk.element_size() + pk.element_size()) * live)
    dt = str(dtype).replace("torch.", "")
    bound = bound_ms(0, moved)  # a copy and a cast: no arithmetic to speak of
    log("kernels", kernel="xkv_splice", shape="x".join(map(str, shape)), dtype=dt,
        tail_dtype=str(tail_dtype).replace("torch.", ""), win=list(win_list), exact=exact,
        **({"nan_bytes_in_k": nan_bytes} if f8 else {}), ms=round(ms, 4), device_ms=round(device_ms, 4),
        plain_ms=round(plain_ms, 4), GB_per_s=round(moved / ms / 1e6, 1), bound_ms=round(bound["bound_ms"], 4))
    if not exact or (f8 and not nan_bytes):
        raise AssertionError(f"xkv_splice disagrees with its plain version at {shape} ({dt}, {tail_dtype})")
    del pk, pv, tk, tv
    torch.cuda.empty_cache()
    return dict(max_abs_err=0.0, ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=None, **bound)


def phase_kernels_large(geoms: dict, launched: dict) -> dict:
    """The large form's kernels at the shapes its engines give them, for
    each run's geometry (``geoms``: model -> geometry; see k1_large_cases;
    K2 at each run's pool depth and group width, and at 24 lanes). K1 is
    checked in bf16 and f32, or in the dtypes a geometry's ``k1_dtypes``
    names. Fails if a run launched K1 at an (S, T) not checked here.
    Returns per-case records, K1's keyed by (S, T, dtype, lanes)."""
    records = {}
    checked = set()
    for model, geom in geoms.items():
        G = geom["group_width"]
        for label, S, T, tv, vt in k1_large_cases(geom):
            if (S, T, tv, vt, G) in checked:
                continue
            checked.add((S, T, tv, vt, G))
            for dtype in geom.get("k1_dtypes", (torch.bfloat16, torch.float32)):
                rec = _check_k1(label, model, S, T, tv, vt, dtype, G, LH)
                records[("flash_encoder_attn", S, T, str(dtype).replace("torch.", ""), G)] = rec
        for width in (G, len(K2_WIN)):
            # pool dtype, tail dtype: bf16 and f32 pools; f8 pools from the
            # serving (bf16) tails, and from f32 tails at the group's width
            for dtype, tail_dtype in ((torch.bfloat16, None), (torch.float32, None),
                                      (torch.float8_e4m3fn, torch.bfloat16),
                                      (torch.float8_e4m3fn, torch.float32)):
                if tail_dtype == torch.float32 and width != G:
                    continue
                shape = (geom["n_text_layer"], width, LH, DH, geom["pool_t"])
                key = ("xkv_splice", shape[0], width, str(dtype).replace("torch.", ""),
                       str(tail_dtype or dtype).replace("torch.", ""))
                if key not in records:
                    # a one-lane group (the ab runs' sessions) takes a live lane
                    win = K2_WIN[:width] if width > 1 else K2_WIN[1:2]
                    records[key] = _check_k2(shape, win, dtype, tail_dtype)
    unchecked = set(launched) - {(S, T) for S, T, _, _, _ in checked}
    if unchecked:
        raise AssertionError(f"the large-form runs launched K1 at unchecked shapes {sorted(unchecked)}")
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


# K4: the decode step's DRY penalty, at turbo's vocabulary and text context
K4_V, K4_L = 51866, 448
K4_LANES = (64, 96)  # a turbo lane group's cap; the base form's capacity arm


def _cuda_launches(fn) -> int:
    """Kernels and copies one call of ``fn`` puts on the card (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def _check_k4(B: int) -> dict:
    """K4 against its plain version at B lanes, bit for bit; timed (CUDA
    events, the device alone from a graph's replay, the host's enqueue of
    one call), the launches one call of each path makes, logged. Beside
    it, the device time of the row copy alone (every lane empty: the
    kernel returns after copying) and of ``Tensor.clone`` on the logits."""
    lg, tk, cl = (t.cuda() for t in planted_rows(B, K4_V, seed=400 + B, L=K4_L))
    want = dry_penalty_plain(lg, tk, cl, EOT)
    got = dry_penalty(lg, tk, cl, EOT)
    torch.cuda.synchronize()
    exact = torch.equal(got.view(torch.int32), want.view(torch.int32))
    penalized = int((got != lg).sum())
    kernel = lambda: dry_penalty(lg, tk, cl, EOT)  # noqa: E731
    plain = lambda: dry_penalty_plain(lg, tk, cl, EOT)  # noqa: E731
    ms, device_ms, plain_ms = _time_ms(kernel), _time_graph_ms(kernel), _time_ms(plain, iters=5)
    empty = torch.zeros_like(cl)
    copy_ms = _time_graph_ms(lambda: dry_penalty(lg, tk, empty, EOT))
    clone_ms = _time_graph_ms(lambda: lg.clone())
    host_us, plain_host_us = _host_us(kernel), _host_us(plain, n=10)
    launches = dict(kernel=_cuda_launches(kernel), plain=_cuda_launches(plain))
    # the logits read once and the result written once, the token rows and lengths read
    moved = 2 * lg.numel() * 4 + tk.numel() * 8 + cl.numel() * 8
    bound = bound_ms(0, moved)
    log("kernels", kernel="dry_penalty", shape=f"B{B}xL{K4_L}xV{K4_V}", exact=exact, penalized=penalized,
        ms=round(ms, 4), device_ms=round(device_ms, 4), copy_only_device_ms=round(copy_ms, 4),
        clone_device_ms=round(clone_ms, 4), plain_ms=round(plain_ms, 4), host_us=round(host_us, 1),
        plain_host_us=round(plain_host_us, 1), launches_per_call=launches,
        GB_per_s=round(moved / device_ms / 1e6, 1), bound_ms=round(bound["bound_ms"], 4),
        bound_share=round(bound["bound_ms"] / device_ms, 3))
    if not exact or not penalized:
        raise AssertionError(f"dry_penalty disagrees with its plain version at B={B} (penalized {penalized})")
    return dict(max_abs_err=0.0, ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=None,
                copy_only_device_ms=copy_ms, host_us=host_us, plain_host_us=plain_host_us,
                launches_per_call=launches, **bound)


def phase_k4_step() -> dict:
    """One turbo decode step with K4 and with the plain version patched in:
    the kernels and copies a step puts on the card (torch.profiler, a loop
    of 3 steps less one of 2), and a step's wall ms (a loop of 9 steps less
    one of 1, each to a synchronize; in turns plain, kernel, kernel, plain).
    _tick_core at large-v3-turbo's decoder widths (4 layers of 1280, bf16,
    64 lanes, the dense cross-KV of random encoder rows), the packed
    outputs of both equal."""
    import dataclasses

    from whisperlivekit_tpu_torch.models.whisper import model as wm
    from whisperlivekit_tpu_torch.models.whisper.dims import MODEL_DIMS
    from whisperlivekit_tpu_torch.streaming import alignatt as A

    dims = dataclasses.replace(MODEL_DIMS["large-v3-turbo"], n_audio_layer=1)  # the encoder does not run
    model = wm.init_params(dims, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16, device="cuda")
    args = greedy_loop_args(64, dims, 96, 1, "cuda")
    paths = {"kernel": dry_penalty, "plain": dry_penalty_plain}

    def run(path, steps):
        A.dry_penalty = paths[path]
        try:
            out = A._tick_core(model, max_steps=steps, **args)
            torch.cuda.synchronize()
            return out
        finally:
            A.dry_penalty = dry_penalty

    outs = {p: run(p, 8) for p in paths}
    if not torch.equal(outs["kernel"], outs["plain"]):
        raise AssertionError("_tick_core with K4 differs from the plain version's")
    launches = {p: _cuda_launches(lambda p=p: run(p, 3)) - _cuda_launches(lambda p=p: run(p, 2)) for p in paths}

    def wall_ms(path, steps):
        run(path, steps)
        t = time.perf_counter()
        run(path, steps)
        return (time.perf_counter() - t) * 1e3

    step_ms = {p: [] for p in paths}
    for p in ("plain", "kernel", "kernel", "plain"):
        step_ms[p].append(round((wall_ms(p, 9) - wall_ms(p, 1)) / 8, 3))
    log("k4_step", lanes=64, widths="large-v3-turbo decoder, bf16", launches_per_step=launches,
        step_ms=step_ms, outputs_equal=True)
    del model
    torch.cuda.empty_cache()
    return dict(launches_per_step=launches, step_ms=step_ms)


def phase_kernels_k4() -> dict:
    """K4 at the turbo group's 64 lanes and the base form's 96, then one
    decode step with and without it (phase_k4_step)."""
    records = {B: _check_k4(B) for B in K4_LANES}
    records["step"] = phase_k4_step()
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
SESSION_SECONDS = 8.0
CHUNK_S = 0.5
# audio fed in real time, as a live stream gives it: a tick sees well under
# a second of new audio. At 10x each tick saw ~3 s, so a session decoded in
# a handful of ticks, and with random weights some committed nothing before
# the final flush; under language="auto" a session whose detection fell
# into the final flush kept no words (its flush batch starts with words
# from before the detection, and is held back whole)
PACE = 1.0


async def _feed_processor(processor, pcm: np.ndarray, pace: float = PACE, delay: float = 0.0,
                          raw: bool = False) -> list:
    """Stream PCM into an in-process session; returns its last lines as
    (text, detected_language), or as the wire's dicts when ``raw``."""
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
    if raw:
        return [ln.as_dict() for ln in last if ln.text]
    return [(ln.text, ln.detected_language) for ln in last if ln.text]


async def _feed_websocket(url: str, pcm: np.ndarray, pace: float = PACE, delay: float = 0.0,
                          raw: bool = False) -> list:
    """Stream PCM over ``WS /asr``; returns the last lines as (text,
    detected_language), or as the wire's dicts when ``raw``."""
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
                    texts = [ln if raw else (ln["text"], ln.get("detected_language"))
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


def phase_main() -> dict:
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
        audio_s_each=SESSION_SECONDS, pace=PACE, words_per_session=words,
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
    return run


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
# wall seconds (audio runs in real time): sessions join one by one, each
# with a full-window anchor. The window does not evict: a session detects
# its language once its window reaches 2 s past its first timestamp, which
# is not moved by eviction, as in the JAX package
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
        first_ts = [ins.first_ts.get(id(s)) for s in _server_sessions(ins, procs)]
        stats = engine.scheduler.stats()
    finally:
        await runner.cleanup()
        TranscriptionEngine.reset()
    return dict(texts=texts, langs=langs, line_langs=line_langs, first_ts=first_ts, wall=wall, setup_s=setup_s,
                counts=counts,
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
        audio_s_each=FRONT_SECONDS, pace=PACE, words_per_session=words,
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


def _f8_close(got: torch.Tensor, want: torch.Tensor) -> int:
    """Two float8_e4m3fn pools rounded from f32 projections summed in
    different orders (cuBLAS on the card, the CPU's): NaN at the same
    places, every other byte equal or one f8 step apart, and under 1e-4 of
    them apart. Returns the number of bytes that differ."""
    gb, wb = got.view(torch.uint8).cpu(), want.view(torch.uint8).cpu()
    gf, wf = gb.view(torch.float8_e4m3fn).float(), wb.view(torch.float8_e4m3fn).float()
    if not torch.equal(gf.isnan(), wf.isnan()):
        raise AssertionError("the f8 pools hold NaN at different places")
    fin = ~wf.isnan()
    m = torch.maximum(gf[fin].abs(), wf[fin].abs()).clamp(min=2.0 ** -6)
    step = torch.exp2(torch.floor(torch.log2(m)) - 3)
    n_diff = int((gb != wb).sum())
    if bool(((gf[fin] - wf[fin]).abs() > step).any()) or n_diff >= 1e-4 * gb.numel():
        raise AssertionError(f"the f8 pools differ by more than one f8 step or too often ({n_diff})")
    return n_diff


def phase_reference_large(tok_for, f8: bool = False) -> None:
    """One whole-group anchor (the fused mel at 128 mels) then two pooled
    inc ticks, two sessions, f32, large-v3 widths with the depth cut to 4+4
    layers, on the card (K1, K2, K3) and on the CPU (plain versions) in
    lockstep: the modes and the integer outputs must be equal, no_speech_p
    within 1e-4. ``f8``: the f8 large form (the decoder quantized, float8
    pools, K2's f8 route); the pools' bytes then agree up to one f8 step
    where the two devices' f32 sums straddle a rounding boundary
    (``_f8_close``)."""
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
        if f8:
            wm.quantize_decoder_f8(model)
        # the large-v3 tail (the cut depth would pick another model class's)
        eng = A.AlignAttEngine(model, dims, tok, A.AlignAttConfig(
            language="en", enc_tail_frames=160, mel_pallas=True,
            xkv_cache_dtype="f8" if f8 else "bf16"))
        pool, enc_pool = A.AudioPool(4, device=dev), A.EncPool(5, dims, torch.float32, dev)
        xkv = A.XKVAllocator.for_engine(eng, 2, epoch_period=50)
        sessions = [A.AlignAttSession(eng) for _ in range(2)]
        for s in sessions:
            s.pool, s.enc_pool, s.xkv_alloc = pool, enc_pool, xkv
        sides[side] = (eng, pool, enc_pool, xkv, sessions)
    pcms = [speech_pcm(8.0, seed=40 + i).astype(np.float32) / 32768.0 for i in range(2)]
    calls = {}
    launched = {"flash_encoder_attn": 0, "xkv_splice": 0, "log_mel_pallas": 0}
    f8_launched = 0
    for tick, (a0, a1) in enumerate(((0, 96000), (96000, 112000), (112000, 128000))):
        res = {}
        for side, (eng, pool, enc_pool, xkv, sessions) in sides.items():
            tis = []
            for s, pcm in zip(sessions, pcms):
                s.insert_audio(pcm[a0:a1])
                tis.append(s.prepare_tick(False))
            before = (flash_encoder_attn.launches, xkv_splice.launches, log_mel_pallas.launches,
                      xkv_splice.f8_launches)
            A.TICK_PHASE_STATS.clear()
            with torch.inference_mode():
                outs = run_tick_batch(eng, tis, tok, pool=pool, enc_pool=enc_pool, xkv=xkv)
            for s, ti, o in zip(sessions, tis, outs):
                s.finish_tick(ti, o)
            if side == "card":
                launched["flash_encoder_attn"] += flash_encoder_attn.launches - before[0]
                launched["xkv_splice"] += xkv_splice.launches - before[1]
                launched["log_mel_pallas"] += log_mel_pallas.launches - before[2]
                f8_launched += xkv_splice.f8_launches - before[3]
            res[side] = (tuple(t.enc_mode for t in tis), outs, sorted(A.TICK_PHASE_STATS))
        (gm, go, gp), (cm, co, cp) = res["card"], res["cpu"]
        ints = lambda o: (o.new_tokens, [int(f) for f in o.frames], o.n_keep, o.reason,  # noqa: E731
                          o.last_attend, o.fire)
        ns_err = max(abs(a.no_speech_p - b.no_speech_p) for a, b in zip(go, co))
        ok = gm == cm and gp == cp and all(ints(a) == ints(b) for a, b in zip(go, co)) and ns_err <= 1e-4
        pools = {}
        if f8:  # the group's cross-KV pools, card against CPU
            (gx, cx) = (sides[sd][3].groups[0] for sd in ("card", "cpu"))
            if gx.k.dtype != torch.float8_e4m3fn or cx.k.dtype != torch.float8_e4m3fn:
                raise AssertionError(f"the f8 form's pools are {gx.k.dtype} / {cx.k.dtype}")
            pools = dict(pool_bytes_differing=_f8_close(gx.k, cx.k) + _f8_close(gx.v, cx.v),
                         pool_bytes=2 * gx.k.numel())
        log("reference", model=f"large-v3 widths, 4+4 layers, f32 random{', f8' if f8 else ''}",
            tick=tick, modes=gm, phases=gp, gpu=[ints(o) for o in go], cpu=[ints(o) for o in co],
            no_speech_err=ns_err, ok=ok, **pools)
        if not ok:
            raise AssertionError(f"the card's pooled tick {tick} disagrees with the CPU reference")
        calls.setdefault(gm, 0)
        calls[gm] += 1
    want = {("anchor", "anchor"): 1, ("inc", "inc"): 2}
    if calls != want or not all(launched.values()) or (f8 and f8_launched != launched["xkv_splice"]):
        raise AssertionError(f"expected one whole-group anchor, two inc ticks and all three kernels: "
                             f"{calls} {launched}, f8 splices {f8_launched}")
    log("reference", model="large-v3 widths", f8=f8, kernel_launches=launched, ok=True)


LARGE_SESSIONS = 5       # AudioProcessor sessions in process, plus one over WS /asr
LARGE_SECONDS = 20.0
# real time, as PACE: at 2x a late joiner's first two-token tick could come
# only once its 8 s window had passed 6 s, and then never reach the 2 s
# past its first timestamp that language detection waits for
LARGE_PACE = 1.0
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
    memory over each call of ``peak_of`` (and above the call's starting
    allocation), times every dispatched group
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
        self.over_start = []  # each peak_of call's peak above its starting allocation
        self.sessions = {}  # id -> every AlignAttSession that prepared a tick, in order
        # id -> (first timestamp s, window s) at the first tick that saw it set
        self.first_ts = {}

    def _wrap(self, name, real):
        def wrapped(*a, **k):
            self.calls[name] += 1
            if name != self.peak_of:
                return real(*a, **k)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            out = real(*a, **k)
            torch.cuda.synchronize()
            self.peaks.append(torch.cuda.max_memory_allocated())
            self.over_start.append(self.peaks[-1] - start)
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
            if sess.first_timestamp is not None and id(sess) not in self.first_ts:
                self.first_ts[id(sess)] = (round(sess.first_timestamp, 2), round(sess.segments_len(), 2))
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
    xkv_splice.f8_launches = 0
    log_mel_pallas.launches = 0
    log_mel_pallas.shapes.clear()
    log_mel_pallas.routes.clear()
    dry_penalty.launches = 0


def _kernel_counts() -> dict:
    return dict(flash_encoder_attn=flash_encoder_attn.launches, xkv_splice=xkv_splice.launches,
                xkv_splice_f8=xkv_splice.f8_launches,
                log_mel_pallas=log_mel_pallas.launches, dry_penalty=dry_penalty.launches,
                k1_shapes=dict(flash_encoder_attn.shapes),
                k1_bodies=dict(flash_encoder_attn.bodies), k1_splits=dict(flash_encoder_attn.splits),
                k3_shapes=dict(log_mel_pallas.shapes), k3_routes=dict(log_mel_pallas.routes))


def _check_k1_bodies(phase: str, counts: dict) -> None:
    """Every K1 launch of a bf16 main path took a tensor-core (wgmma) body."""
    bodies, launches = counts["k1_bodies"], counts["flash_encoder_attn"]
    log(phase, kernel="flash_encoder_attn", launches_by_body=bodies,
        launches_by_split={str(k): n for k, n in sorted(counts["k1_splits"].items())})
    if sum(bodies.get(b, 0) for b in WGMMA_BODIES) != launches:
        raise AssertionError(f"{phase}: K1 launches off the wgmma bodies: {bodies} of {launches}")


def _large_geom(engine) -> dict:
    """The large form's kernel geometry on a built engine: what K1's and
    K2's checks need to cover every shape its ticks give them."""
    from whisperlivekit_tpu_torch.streaming import alignatt as A

    from whisperlivekit_tpu_torch.models.whisper import model as wm

    eng, xkv = engine.scheduler.engine, engine.scheduler.xkv
    k = xkv.groups[0].k
    params = list(eng.model.parameters()) + list(eng.model.buffers())
    return dict(n_audio_ctx=eng.dims.n_audio_ctx, n_text_layer=eng.dims.n_text_layer,
                pool_t=k.shape[-1], tail_frames=eng.cfg.enc_tail_frames,
                prefix_buckets=eng.prefix_buckets, group_width=xkv.group_width,
                refresh_rows=(A.SKV_REFRESH_ROWS, A._skv_full_refresh_rows(eng, xkv.skv_width)),
                pool_dtype=str(k.dtype).replace("torch.", ""),
                xkv_bytes_per_slot=2 * k[:, 0].numel() * k.element_size(),
                weight_bytes=sum(t.numel() * t.element_size() for t in params),
                f8_linears=sum(lin.weight.dtype == torch.float8_e4m3fn for lin in wm._f8_linears(eng.model)),
                decoder_linears=8 * eng.dims.n_text_layer)


def _widen_ms(model) -> tuple:
    """What the f8 ``dense`` adds per decode step: widening every quantized
    decoder linear to bf16 once (the products are not in it). Returns (ms
    by CUDA events over back-to-back calls, the device alone from a graph's
    replay)."""
    from whisperlivekit_tpu_torch.models.whisper import model as wm

    lins = [lin.weight for lin in wm._f8_linears(model)]
    widen = lambda: [w.to(torch.bfloat16) for w in lins]  # noqa: E731
    return _time_ms(widen, iters=5), _time_graph_ms(widen, reps=2)


async def _main_path_large(f8: bool = False) -> dict:
    from aiohttp import web

    from whisperlivekit_tpu_torch.engine.core import TranscriptionEngine, WLKConfig
    from whisperlivekit_tpu_torch.server.app import WLKServer
    from whisperlivekit_tpu_torch.session.processor import AudioProcessor
    from whisperlivekit_tpu_torch.streaming import alignatt as A

    # one 8-wide lane group; an 8 s window evicts every 4 s, and a group
    # epoch passes every 4 pooled inc ticks. f8: the decoder's block linears
    # and the cross-KV pools in float8_e4m3fn
    f8_kw = dict(decoder_dtype="f8", xkv_cache_dtype="f8") if f8 else {}
    config = WLKConfig(model_size="random:large-v3", lan="auto", pcm_input=True, vac=False,
                       param_dtype="bfloat16", log_level="WARNING", max_batch_sessions=LG,
                       audio_max_len=8.0, **f8_kw)
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
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
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
            peak = torch.cuda.max_memory_allocated()
        langs, line_langs = _session_languages(ins, procs, texts)
        first_ts = [ins.first_ts.get(id(s)) for s in _server_sessions(ins, procs)]
        stats = engine.scheduler.stats()
        phases = dict(A.TICK_PHASE_STATS)
        geom = _large_geom(engine)
        widen_ms = _widen_ms(engine.asr.engine.model) if f8 else None
    finally:
        await runner.cleanup()
        TranscriptionEngine.reset()
    return dict(texts=texts, langs=langs, line_langs=line_langs, first_ts=first_ts, wall=wall, init_s=init_s,
                setup_s=setup_s, counts=counts, peak=peak, widen_ms=widen_ms,
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


def _server_sessions(ins: Instrumented, procs: list) -> list:
    """The server-side session of each stream: the in-process ones, then
    the one behind ``WS /asr``."""
    own = [p.transcription.model for p in procs]
    return own + [s for s in ins.sessions.values() if all(s is not o for o in own)]


def _session_languages(ins: Instrumented, procs: list, texts: list) -> tuple:
    """Each session's detected language, read from its server-side session,
    and the languages its transcript lines carry. A line carries one only
    when it holds words committed after the detection, so the lines alone
    cannot say whether a session detected."""
    langs = [s.detected_language for s in _server_sessions(ins, procs)]
    on_lines = [sorted({lang for _, lang in lines if lang}) for lines in texts]
    return langs, on_lines


def _check_languages(phase: str, run: dict) -> None:
    ms, langs, on_lines = run["detect_ms"], run["langs"], run["line_langs"]
    log(phase, detected_languages=langs, line_languages=on_lines, detections=len(ms),
        detect_ms_p50=_quantile(ms, 0.5), detect_ms_max=_quantile(ms, 1.0),
        first_ts_and_window_s=run.get("first_ts"))
    if len(langs) != len(on_lines) or not all(langs):
        raise AssertionError(f"a session never detected its language: {langs} over {len(on_lines)} sessions")
    if any(seen not in ([], [lang]) for lang, seen in zip(langs, on_lines)):
        raise AssertionError(f"lines carry another language than their session's: {on_lines} vs {langs}")


def phase_large(f8: bool = False) -> dict:
    """The large form (``f8``: the f8 large form, logged as phase "f8")."""
    import gc
    import tempfile

    from whisperlivekit_tpu_torch.engine.core import get_tokenizer
    from whisperlivekit_tpu_torch.harness.vocab import install_standin_vocab

    def tok_for(dims):
        return get_tokenizer(True, num_languages=dims.num_languages, language="en", task="transcribe")

    phase = "f8" if f8 else "large"
    with tempfile.TemporaryDirectory(prefix="wlk_vocab_") as vocab_dir:
        install_standin_vocab(vocab_dir)
        phase_reference_large(tok_for, f8=f8)
        gc.collect()  # an earlier phase's engine sits in reference cycles until a collection
        torch.cuda.empty_cache()
        run = asyncio.run(_main_path_large(f8))
    stats, counts = run["stats"], run["counts"]
    words = [sum(len(t.split()) for t, _ in lines) for lines in run["texts"]]
    shapes = {f"{s}x{t}": n for (s, t), n in sorted(counts["k1_shapes"].items())}
    log(phase, model=f"random:large-v3 bf16{', f8 decoder and pools' if f8 else ''}", group_width=LG,
        sessions=len(words),
        audio_s_each=LARGE_SECONDS, pace=LARGE_PACE, words_per_session=words,
        wall_s=round(run["wall"], 3), engine_init_s=round(run["init_s"], 3),
        setup_s=round(run["setup_s"], 3), ticks=stats["n_ticks"],
        avg_lanes=stats["avg_lanes_per_tick"], tick_ms_p50=stats["tick_ms_p50"],
        tick_ms_p95=stats["tick_ms_p95"], word_emission_p50_ms=stats["word_emission_p50_ms"],
        word_emission_p95_ms=stats["word_emission_p95_ms"], failed_ticks=stats["n_failed_ticks"],
        peak_alloc_GB=round(run["peak"] / 2**30, 3), weight_GB=round(run["geom"]["weight_bytes"] / 2**30, 3))
    for key, ms in sorted(run["phase_ms"].items()):
        log(phase, tick_phase=key, n=len(ms), p50_ms=_quantile(ms, 0.5), p95_ms=_quantile(ms, 0.95),
            mean_lanes=stats["tick_phases"].get(key, {}).get("mean_lanes"))
    log(phase, programs=run["calls"], anchor_reasons=stats["anchor_reasons"],
        xkv=stats.get("xkv"),
        anchor_group_peak_GB=round(max(run["peaks"]) / 2**30, 3) if run["peaks"] else None)
    log(phase, kernel="flash_encoder_attn", launches=counts["flash_encoder_attn"],
        launches_by_SxT=shapes, per_tick=round(counts["flash_encoder_attn"] / max(stats["n_ticks"], 1), 2))
    _check_k1_bodies(phase, counts)
    log(phase, kernel="xkv_splice", launches=counts["xkv_splice"], f8_launches=counts["xkv_splice_f8"],
        per_tick=round(counts["xkv_splice"] / max(stats["n_ticks"], 1), 2))
    if stats["n_failed_ticks"]:
        raise AssertionError(f"{stats['n_failed_ticks']} batch ticks failed")
    if "pool_recovery" in run["phases"]:
        raise AssertionError(f"a lane group recovered: {run['phases']['pool_recovery']}")
    _check_languages(phase, run)
    if not all(words):
        raise AssertionError(f"a session got no words: {words}")
    if not all(run["calls"][name] for name in LARGE_PROGRAMS):
        raise AssertionError(f"a pooled program never ran: {run['calls']}")
    if not all(counts[k] for k in ("flash_encoder_attn", "xkv_splice", "log_mel_pallas")):
        raise AssertionError(f"a kernel never launched: {counts}")
    _check_front_kernels(phase, run)
    if not (counts["k1_shapes"].get((1500, 1500)) and counts["k1_shapes"].get((160, 160))):
        raise AssertionError(f"K1 did not launch at the encoder's call sites: {shapes}")
    geom = run["geom"]
    log(phase, geometry=geom)
    want_pool = "float8_e4m3fn" if f8 else "bfloat16"
    want_f8 = geom["decoder_linears"] if f8 else 0
    if geom["pool_dtype"] != want_pool or geom["f8_linears"] != want_f8:
        raise AssertionError(f"{phase}: pools {geom['pool_dtype']}, {geom['f8_linears']} f8 linears")
    if counts["xkv_splice_f8"] != (counts["xkv_splice"] if f8 else 0):
        raise AssertionError(f"{phase}: K2 took the f8 route {counts['xkv_splice_f8']} of "
                             f"{counts['xkv_splice']} times")
    return run


def phase_f8(large: dict) -> dict:
    """The f8 large form beside the large phase: its pools hold half the
    cross-KV bytes per slot, and its tick, word-emission, peak-memory and
    weight figures print beside the large phase's."""
    run = phase_large(f8=True)
    g, lg = run["geom"], large["geom"]
    s, ls = run["stats"], large["stats"]
    log("f8", beside="large", xkv_bytes_per_slot=[g["xkv_bytes_per_slot"], lg["xkv_bytes_per_slot"]],
        weight_GB=[round(g["weight_bytes"] / 2**30, 3), round(lg["weight_bytes"] / 2**30, 3)],
        peak_alloc_GB=[round(run["peak"] / 2**30, 3), round(large["peak"] / 2**30, 3)],
        tick_ms_p50=[s["tick_ms_p50"], ls["tick_ms_p50"]], tick_ms_p95=[s["tick_ms_p95"], ls["tick_ms_p95"]],
        word_emission_p50_ms=[s["word_emission_p50_ms"], ls["word_emission_p50_ms"]],
        word_emission_p95_ms=[s["word_emission_p95_ms"], ls["word_emission_p95_ms"]],
        f8_weight_widening_ms_per_step=round(run["widen_ms"][0], 4),
        f8_weight_widening_device_ms_per_step=round(run["widen_ms"][1], 4))
    if 2 * g["xkv_bytes_per_slot"] != lg["xkv_bytes_per_slot"]:
        raise AssertionError(f"f8 pools hold {g['xkv_bytes_per_slot']} bytes a slot, "
                             f"bf16 {lg['xkv_bytes_per_slot']}")
    return run


BEAMS = 4               # the beam phase's --beams
BEAM_SESSIONS = 4       # AudioProcessor sessions in process, plus one over WS /asr
BEAM_SECONDS = 8.0


def phase_reference_beam() -> None:
    """Beam ticks of the port in f32 on the card (K1) against the CPU
    (plain versions), the base model from one seed, one session through
    ``run_tick_batch_beam``: beam 1 equals the greedy tick (``run_tick_batch``)
    on each device, and beams 1 and 4 give the same integer outputs on both,
    no_speech_p within 1e-4."""
    from whisperlivekit_tpu_torch.engine.core import MODEL_DIMS, get_tokenizer
    from whisperlivekit_tpu_torch.models.whisper import model as wm
    from whisperlivekit_tpu_torch.streaming import alignatt as A
    from whisperlivekit_tpu_torch.streaming.alignatt_beam import run_tick_batch_beam
    from whisperlivekit_tpu_torch.streaming.dispatch import run_tick_batch
    from whisperlivekit_tpu_torch.streaming.session_plan import TickInputs

    dims = MODEL_DIMS["base"]
    tok = get_tokenizer(True, language="en", task="transcribe")
    pcm = speech_pcm(4.0, seed=95)
    sot = list(tok.sot_sequence_including_notimestamps)
    ti = TickInputs(audio=pcm.astype(np.float32) / 32768.0, prefix_ids=sot + [400, 401],
                    sot_index=0, content_frames=len(pcm) // 320, last_attend=-200,
                    is_last=False, max_new=50)
    ints = lambda o: (o.new_tokens, [int(f) for f in o.frames], o.n_keep, o.reason,  # noqa: E731
                      o.last_attend, o.fire)
    res, launched = {}, 0
    for side, dev in (("card", CARD), ("cpu", "cpu")):
        model = wm.init_params(dims, torch.Generator().manual_seed(1), torch.float32, dev)
        eng = A.AlignAttEngine(model, dims, tok, A.AlignAttConfig(
            language="en", decoder_type="beam", beam_size=BEAMS))
        before = flash_encoder_attn.launches
        with torch.inference_mode():
            greedy = run_tick_batch(eng, [ti], tok)[0]
            beams = {b: run_tick_batch_beam(eng, [ti], tok, b)[0] for b in (1, BEAMS)}
        if side == "card":
            launched = flash_encoder_attn.launches - before
        if ints(beams[1]) != ints(greedy):
            raise AssertionError(f"{side}: beam 1 {ints(beams[1])} is not the greedy tick {ints(greedy)}")
        res[side] = beams
    ns_err = max(abs(res["card"][b].no_speech_p - res["cpu"][b].no_speech_p) for b in (1, BEAMS))
    ok = all(ints(res["card"][b]) == ints(res["cpu"][b]) for b in (1, BEAMS)) and ns_err <= 1e-4 and launched > 0
    log("reference", model="base f32 random", tick=f"run_tick_batch_beam beams 1, {BEAMS}",
        gpu={b: ints(o) for b, o in res["card"].items()}, cpu={b: ints(o) for b, o in res["cpu"].items()},
        beam1_is_greedy=True, no_speech_err=ns_err, k1_launches=launched, ok=ok)
    if not ok:
        raise AssertionError("the card's beam tick disagrees with the CPU reference")


async def _main_path_beam() -> dict:
    from aiohttp import web

    from whisperlivekit_tpu_torch.engine.core import TranscriptionEngine, WLKConfig
    from whisperlivekit_tpu_torch.server.app import WLKServer
    from whisperlivekit_tpu_torch.session.processor import AudioProcessor
    from whisperlivekit_tpu_torch.streaming import alignatt_beam as TB

    config = WLKConfig(model_size="random:base", lan="en", pcm_input=True, vac=False, beams=BEAMS,
                       param_dtype="bfloat16", log_level="WARNING")
    t0 = time.perf_counter()
    engine = TranscriptionEngine(config)
    if engine.device.type != "cuda" or engine.asr.cfg.decoder_type != "beam":
        raise AssertionError(f"engine on {engine.device}, decoder {engine.asr.cfg.decoder_type}")
    runner = web.AppRunner(WLKServer(config, engine=engine).app)
    await runner.setup()  # startup runs the engine's warmup tick
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    host, port = runner.addresses[0][:2]
    setup_s = time.perf_counter() - t0
    real, tick_ms = TB.run_tick_batch_beam, []

    def timed(*a, **k):  # session_plan looks the beam tick up on its module at call time
        t = time.perf_counter()
        out = real(*a, **k)
        tick_ms.append((time.perf_counter() - t) * 1e3)
        return out
    try:
        TB.run_tick_batch_beam = timed
        _reset_kernel_counts()
        engine.scheduler.reset_stats()
        t1 = time.perf_counter()
        pcms = [speech_pcm(BEAM_SECONDS, seed=80 + s) for s in range(BEAM_SESSIONS + 1)]
        procs = [AudioProcessor(transcription_engine=engine) for _ in range(BEAM_SESSIONS)]
        texts = await asyncio.gather(
            *(_feed_processor(p, pcm) for p, pcm in zip(procs, pcms)),
            _feed_websocket(f"http://{host}:{port}/asr", pcms[-1]),
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = _kernel_counts()
        stats = engine.scheduler.stats()
    finally:
        TB.run_tick_batch_beam = real
        await runner.cleanup()
        TranscriptionEngine.reset()
    return dict(texts=texts, wall=wall, setup_s=setup_s, counts=counts, stats=stats, tick_ms=tick_ms)


def phase_beam() -> dict:
    """The streaming beam tick: the card against the CPU, then
    ``random:base`` bf16 with ``beams=4`` serving AudioProcessor sessions
    and one ``WS /asr`` stream, each session's ticks solo (outside the
    BatchScheduler, as in the JAX package)."""
    import gc
    import tempfile

    from whisperlivekit_tpu_torch.harness.vocab import install_standin_vocab

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="wlk_vocab_") as vocab_dir:
        install_standin_vocab(vocab_dir)
        phase_reference_beam()
        run = asyncio.run(_main_path_beam())
    counts, ms = run["counts"], run["tick_ms"]
    words = [sum(len(t.split()) for t, _ in lines) for lines in run["texts"]]
    log("beam", model=f"random:base bf16, beams {BEAMS}", sessions=len(words), audio_s_each=BEAM_SECONDS,
        pace=PACE, words_per_session=words, wall_s=round(run["wall"], 3), setup_s=round(run["setup_s"], 3),
        beam_ticks=len(ms), beam_tick_ms_p50=_quantile(ms, 0.5), beam_tick_ms_p95=_quantile(ms, 0.95),
        scheduler_ticks=run["stats"]["n_ticks"])
    log("beam", kernel="flash_encoder_attn", launches=counts["flash_encoder_attn"],
        launches_by_SxT={f"{s}x{t}": n for (s, t), n in sorted(counts["k1_shapes"].items())},
        per_tick=round(counts["flash_encoder_attn"] / max(len(ms), 1), 2))
    _check_k1_bodies("beam", counts)
    if not ms or run["stats"]["n_ticks"]:
        raise AssertionError(f"{len(ms)} beam ticks, {run['stats']['n_ticks']} scheduler ticks")
    if not all(words):
        raise AssertionError(f"a session got no words: {words}")
    if not counts["flash_encoder_attn"]:
        raise AssertionError("K1 never launched in the beam phase")
    return run


def phase_kernels_beam(launched: dict) -> dict:
    """K1 in bf16 at every (S, T) the beam phase launched it, at its batch:
    the full-window encoder at one lane (each session's tick runs alone)
    and the prefill over the beams' dense cross-KV at ``BEAMS`` rows, each
    prefix bucket launched. Fails on a launched (S, T) it did not check.
    Returns per-case records."""
    records = {}
    for S, T in sorted(launched):
        if (S, T) == (1500, 1500):
            label, b, vt = "beam encoder full window", 1, False
        elif T == 1500 and S in PREFIX_BUCKETS:
            label, b, vt = f"beam prefill over dense cross-KV, bucket {S}", BEAMS, True
        else:
            raise AssertionError(f"the beam run launched K1 at an unchecked shape {(S, T)}")
        records[(S, T)] = _check_k1(label, "base", S, T, T, vt, torch.bfloat16, b, H)
    return records


LOAD_MODEL = "large-v3-turbo"  # 1280 wide: the large form, with a 4-layer decoder
LOAD_SECONDS = 10.0            # the audio of each endpoint's request or session
LOAD_PACE = 2.0                # the two WS sessions' audio, fed at 2x real time
LOAD_QUIET_S = 5.0             # a /v1/listen client closes after this long without a result


def _checkpoint_tensors(dims) -> list:
    """(name, shape, scale) of every tensor of an OpenAI Whisper checkpoint,
    under its canonical keys: dense weights [out, in] at d_in ** -0.5, conv
    weights at (3 C_in) ** -0.5, biases at 0.02, no key bias; scale None is
    a LayerNorm weight (1 + 0.02 noise)."""
    def block(prefix, d, cross):
        rows = []
        for ln in ("attn_ln", "mlp_ln") + (("cross_attn_ln",) if cross else ()):
            rows += [(f"{prefix}.{ln}.weight", (d,), None), (f"{prefix}.{ln}.bias", (d,), 0.02)]
        for att in ("attn",) + (("cross_attn",) if cross else ()):
            for proj in ("query", "key", "value", "out"):
                rows.append((f"{prefix}.{att}.{proj}.weight", (d, d), d ** -0.5))
                if proj != "key":
                    rows.append((f"{prefix}.{att}.{proj}.bias", (d,), 0.02))
        return rows + [(f"{prefix}.mlp.0.weight", (4 * d, d), d ** -0.5), (f"{prefix}.mlp.0.bias", (4 * d,), 0.02),
                       (f"{prefix}.mlp.2.weight", (d, 4 * d), (4 * d) ** -0.5), (f"{prefix}.mlp.2.bias", (d,), 0.02)]

    d, dt = dims.n_audio_state, dims.n_text_state
    rows = [("encoder.conv1.weight", (d, dims.n_mels, 3), (3 * dims.n_mels) ** -0.5),
            ("encoder.conv1.bias", (d,), 0.02), ("encoder.conv2.weight", (d, d, 3), (3 * d) ** -0.5),
            ("encoder.conv2.bias", (d,), 0.02), ("encoder.positional_embedding", (dims.n_audio_ctx, d), 1.0)]
    for i in range(dims.n_audio_layer):
        rows += block(f"encoder.blocks.{i}", d, cross=False)
    rows += [("encoder.ln_post.weight", (d,), None), ("encoder.ln_post.bias", (d,), 0.02),
             ("decoder.token_embedding.weight", (dims.n_vocab, dt), 0.02),
             ("decoder.positional_embedding", (dims.n_text_ctx, dt), 0.01)]
    for i in range(dims.n_text_layer):
        rows += block(f"decoder.blocks.{i}", dt, cross=True)
    return rows + [("decoder.ln.weight", (dt,), None), ("decoder.ln.bias", (dt,), 0.02)]


def write_checkpoint(path, dims, seed: int) -> int:
    """An OpenAI ``.pt`` as published checkpoints are stored, ``{"dims",
    "model_state_dict"}`` with f16 tensors under canonical keys, the values
    drawn on the card from a seeded ``torch.Generator``. Returns its bytes."""
    import dataclasses

    g = torch.Generator(device="cuda").manual_seed(seed)
    sd = {}
    for name, shape, scale in _checkpoint_tensors(dims):
        x = torch.randn(shape, generator=g, device="cuda")
        sd[name] = (1 + 0.02 * x if scale is None else scale * x).half().cpu()
    torch.save({"dims": dataclasses.asdict(dims), "model_state_dict": sd}, path)
    return path.stat().st_size


class RssPeak:
    """This process's resident memory over a block: before, and the peak,
    sampled every millisecond from /proc/self/statm."""

    def __enter__(self):
        import os
        import threading

        self.page = os.sysconf("SC_PAGE_SIZE")
        self.before = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page

    def _sample(self) -> None:
        while not self._stop.wait(0.001):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())


def _wav_bytes(pcm: np.ndarray) -> bytes:
    import io
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


async def _post_transcription(http, url: str, wav: bytes, fmt: str) -> tuple:
    """One ``POST /v1/audio/transcriptions``: (status, body, wall seconds)."""
    import aiohttp

    form = aiohttp.FormData()
    form.add_field("file", wav, filename="speech.wav", content_type="audio/wav")
    form.add_field("response_format", fmt)
    form.add_field("language", "en")
    t = time.perf_counter()
    async with http.post(url, data=form) as r:
        return r.status, await r.text(), time.perf_counter() - t


async def _listen(url: str, pcm: np.ndarray, pace: float) -> dict:
    """One ``WS /v1/listen`` session as a Deepgram client runs it: audio at
    ``pace``, ``Finalize``, results until LOAD_QUIET_S pass without one,
    ``CloseStream``. Returns the messages, the close and the wall time."""
    import aiohttp

    t = time.perf_counter()
    async with aiohttp.ClientSession() as http:
        async with http.ws_connect(url) as ws:
            msgs = []

            async def receive():
                while True:
                    msg = await ws.receive(timeout=300)
                    if msg.type != aiohttp.WSMsgType.TEXT:
                        return msg.type.name
                    msgs.append(json.loads(msg.data))
            task = asyncio.create_task(receive())
            step = int(16000 * CHUNK_S)
            for i in range(0, len(pcm), step):
                await ws.send_bytes(pcm[i : i + step].tobytes())
                await asyncio.sleep(CHUNK_S / pace)
            await ws.send_str(json.dumps({"type": "Finalize"}))
            seen = -1
            while seen != len(msgs) and not task.done():
                seen = len(msgs)
                await asyncio.sleep(LOAD_QUIET_S)
            await ws.send_str(json.dumps({"type": "CloseStream"}))
            closed = await asyncio.wait_for(task, timeout=60)
    finals = [m["channel"]["alternatives"][0]["transcript"] for m in msgs
              if m.get("type") == "Results" and m["is_final"]]
    return dict(msgs=msgs, closed=closed, text=" ".join(finals), wall=time.perf_counter() - t)


async def _main_path_load(path) -> dict:
    """The checkpoint served through ``create_app`` on localhost: REST posts
    (json and the same json again, at once; then verbose_json), then a ``WS
    /v1/listen`` and a ``WS /asr`` session at once. The two json posts run
    together: a lane group's anchor epoch (every 15 group ticks at a 30 s
    window) re-anchors its sessions mid-request, so a post's text depends on
    where the group's epoch stands when it runs; two posts that share every
    tick see the same epochs. Each post's starting (epoch, ticks) is
    logged."""
    import aiohttp
    from aiohttp import web

    from whisperlivekit_tpu_torch.engine.core import TranscriptionEngine, WLKConfig
    from whisperlivekit_tpu_torch.server.app import create_app
    from whisperlivekit_tpu_torch.streaming import alignatt as A

    config = WLKConfig(model_path=str(path), lan="en", pcm_input=True, vac=False, param_dtype="bfloat16",
                       log_level="WARNING", max_batch_sessions=LG)
    t0 = time.perf_counter()
    engine = TranscriptionEngine(config)
    engine.asr.cfg.mel_pallas = True  # an AlignAttConfig field: WLKConfig has no flag for it
    init_s = time.perf_counter() - t0
    if engine.device.type != "cuda":
        raise AssertionError(f"engine landed on {engine.device}, not the card")
    runner = web.AppRunner(create_app(config, engine=engine))
    await runner.setup()  # startup runs the engine's warmup tick
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    host, port = runner.addresses[0][:2]
    base = f"http://{host}:{port}"
    try:
        with Instrumented(FULL_WINDOW) as ins:
            _reset_kernel_counts()  # the load path's run counts from here
            engine.scheduler.reset_stats()
            wav = _wav_bytes(speech_pcm(LOAD_SECONDS, seed=70))
            groups = engine.scheduler.xkv.groups
            url = f"{base}/v1/audio/transcriptions"
            async with aiohttp.ClientSession() as http:
                epoch = [(g.sub_epoch, g.ticks_since_epoch) for g in groups]
                rest = [(*r, epoch) for r in await asyncio.gather(
                    _post_transcription(http, url, wav, "json"), _post_transcription(http, url, wav, "json"))]
                epoch = [(g.sub_epoch, g.ticks_since_epoch) for g in groups]
                rest.append((*await _post_transcription(http, url, wav, "verbose_json"), epoch))
            t = time.perf_counter()
            listen, asr = await asyncio.gather(
                _listen(f"{base}/v1/listen?language=en", speech_pcm(LOAD_SECONDS, seed=71), LOAD_PACE),
                _feed_websocket(f"{base}/asr", speech_pcm(LOAD_SECONDS, seed=72), LOAD_PACE))
            ws_wall = time.perf_counter() - t
            torch.cuda.synchronize()
            counts = _kernel_counts()
        stats = engine.scheduler.stats()
        phases = dict(A.TICK_PHASE_STATS)
        geom = _large_geom(engine)
    finally:
        await runner.cleanup()
        TranscriptionEngine.reset()
    return dict(rest=rest, listen=listen, asr=asr, ws_wall=ws_wall, init_s=init_s, counts=counts,
                stats=stats, phases=phases, calls=ins.calls, geom=geom)


def phase_load(card: str) -> dict:
    """A large-v3-turbo checkpoint at full width, written as an OpenAI .pt
    (f16, random from a seed; deleted at the end), loaded onto the card and
    held bit for bit to the same file loaded on the CPU, then served: REST
    json, verbose_json and json again, ``WS /v1/listen`` with ``WS /asr``,
    and the CLI's ``transcribe`` (TestHarness) in this process."""
    import contextlib
    import gc
    import io
    import tempfile
    from pathlib import Path

    from whisperlivekit_tpu_torch import cli
    from whisperlivekit_tpu_torch.engine.core import MODEL_DIMS
    from whisperlivekit_tpu_torch.harness import harness
    from whisperlivekit_tpu_torch.harness.vocab import install_standin_vocab
    from whisperlivekit_tpu_torch.models.whisper.load import load_model
    from whisperlivekit_tpu_torch.streaming import alignatt as A

    dims = MODEL_DIMS[LOAD_MODEL]
    with tempfile.TemporaryDirectory(prefix="wlk_ckpt_") as ckpt_dir, \
            tempfile.TemporaryDirectory(prefix="wlk_vocab_") as vocab_dir:
        install_standin_vocab(vocab_dir)
        path = Path(ckpt_dir) / f"{LOAD_MODEL}.pt"
        t = time.perf_counter()
        nbytes = write_checkpoint(path, dims, seed=5)
        write_s = time.perf_counter() - t

        gc.collect()  # the earlier phases' engines sit in reference cycles until a collection
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        card_before = torch.cuda.memory_allocated()
        t = time.perf_counter()
        with RssPeak() as rss:
            model, ldims, name = load_model(str(path), dtype=torch.bfloat16)
            torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        card_peak = torch.cuda.max_memory_allocated()
        t = time.perf_counter()
        ref, _, _ = load_model(str(path), dtype=torch.bfloat16, device="cpu")
        cpu_load_s = time.perf_counter() - t
        want = dict(ref.named_parameters())
        got = dict(model.named_parameters())
        unequal = [n for n, p in got.items()
                   if p.device.type != "cuda" or p.dtype != torch.bfloat16
                   or not torch.equal(p.detach().cpu().view(torch.int16), want[n].view(torch.int16))]
        log("load", card=repr(card), checkpoint=f"{LOAD_MODEL} OpenAI .pt, f16", bytes=nbytes,
            write_s=round(write_s, 3), size_name=name, params=sum(p.numel() for p in want.values()),
            load_s=round(load_s, 3), cpu_load_s=round(cpu_load_s, 3),
            host_rss_before_GiB=round(rss.before / 2**30, 3), host_rss_peak_GiB=round(rss.peak / 2**30, 3),
            card_alloc_before_GiB=round(card_before / 2**30, 3), card_peak_alloc_GiB=round(card_peak / 2**30, 3),
            bit_equal_to_cpu=not unequal and sorted(got) == sorted(want))
        if unequal or sorted(got) != sorted(want) or ldims != dims:
            raise AssertionError(f"the card's load differs from the CPU's: {unequal[:5]} {ldims}")
        del model, ref, got, want
        gc.collect()
        torch.cuda.empty_cache()

        run = asyncio.run(_main_path_load(path))
        server_counts = run["counts"]
        # the CLI's transcribe (TestHarness, the card), in this process
        wav_path = Path(ckpt_dir) / "speech.wav"
        wav_path.write_bytes(_wav_bytes(speech_pcm(LOAD_SECONDS, seed=73)))
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["transcribe", str(wav_path), "--model-path", str(path), "--lan", "en", "--no-vac",
                           "--max-batch-sessions", str(LG)])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t
        counts = _kernel_counts()  # the whole load path: the server's endpoints and the CLI's
        cli_stats = [e.scheduler.stats() for e in harness._engine_cache.values()]
        recovered = "pool_recovery" in A.TICK_PHASE_STATS
        harness.reset_engine_cache()
    run.update(counts=counts, server_counts=server_counts, cli_rc=rc, cli_text=out.getvalue().strip(),
               cli_s=cli_s, cli_stats=cli_stats)

    stats = run["stats"]
    (s1, b1, t1, e1), (s2, b2, t2, e2), (s3, b3, t3, e3) = run["rest"]
    texts = [json.loads(b)["text"] if s == 200 else None for s, b in ((s1, b1), (s2, b2), (s3, b3))]
    verbose = json.loads(b3) if s3 == 200 else {}
    listen, asr = run["listen"], run["asr"]
    words = lambda text: len(text.split())  # noqa: E731
    log("load", model=f"{LOAD_MODEL} checkpoint bf16, mel_pallas", engine_init_s=round(run["init_s"], 3),
        audio_s_each=LOAD_SECONDS, ticks=stats["n_ticks"], avg_lanes=stats["avg_lanes_per_tick"],
        tick_ms_p50=stats["tick_ms_p50"], tick_ms_p95=stats["tick_ms_p95"],
        failed_ticks=stats["n_failed_ticks"], cli_ticks=[s["n_ticks"] for s in cli_stats],
        cli_failed_ticks=[s["n_failed_ticks"] for s in cli_stats])
    for label, status, secs, epoch, text in (("rest json", s1, t1, e1, texts[0]),
                                             ("rest json again", s2, t2, e2, texts[1]),
                                             ("rest verbose_json", s3, t3, e3, texts[2])):
        log("load", endpoint=repr(label), status=status, wall_s=round(secs, 3), group_epoch_ticks=epoch,
            words=words(text or ""), text=repr((text or "")[:160]))
    log("load", endpoint="'ws /v1/listen'", close=listen["closed"], wall_s=round(listen["wall"], 3),
        messages=dict(Counter(m.get("type") for m in listen["msgs"])), words=words(listen["text"]),
        text=repr(listen["text"][:160]))
    asr_text = " ".join(t for t, _ in asr)
    log("load", endpoint="'ws /asr'", wall_s=round(run["ws_wall"], 3), words=words(asr_text),
        text=repr(asr_text[:160]))
    log("load", endpoint="'cli transcribe'", rc=run["cli_rc"], wall_s=round(run["cli_s"], 3),
        words=words(run["cli_text"]), text=repr(run["cli_text"][:160]))
    log("load", programs=run["calls"], verbose_json_segments=len(verbose.get("segments", [])),
        verbose_json_duration=verbose.get("duration"))
    counts = run["counts"]
    log("load", kernel="flash_encoder_attn", launches=counts["flash_encoder_attn"],
        launches_by_SxT={f"{s}x{t}": n for (s, t), n in sorted(counts["k1_shapes"].items())})
    log("load", kernel="xkv_splice", launches=counts["xkv_splice"])
    _check_k1_bodies("load", counts)
    if [s1, s2, s3] != [200] * 3 or texts[0] != texts[1]:
        raise AssertionError(f"REST: statuses {[s1, s2, s3]}, the two json posts {texts[0]!r} / {texts[1]!r}")
    if listen["closed"] != "CLOSE" or not listen["msgs"] or listen["msgs"][0].get("type") != "Metadata":
        raise AssertionError(f"/v1/listen: {listen['closed']} after {[m.get('type') for m in listen['msgs']][:5]}")
    if run["cli_rc"] != 0:
        raise AssertionError(f"the CLI's transcribe returned {run['cli_rc']}")
    if stats["n_failed_ticks"] or any(s["n_failed_ticks"] for s in cli_stats):
        raise AssertionError(f"ticks failed: {stats['n_failed_ticks']}, CLI {cli_stats}")
    if "pool_recovery" in run["phases"] or recovered:
        raise AssertionError("a lane group recovered")
    _check_front_kernels("load", dict(calls=run["calls"], counts=server_counts))
    if not counts["xkv_splice"] or not counts["k1_shapes"].get((1500, 1500)):
        raise AssertionError(f"K2 or K1's full window never launched: {counts}")
    log("load", geometry=run["geom"])
    return run


GROUP_MODEL = "large-v3-turbo"   # 1280 wide, 32+4 layers, 128 mels; random weights, bf16
GROUP_SESSIONS = 12      # AudioProcessor sessions in process, plus one over WS /asr: two 8-wide groups (8 + 5)
GROUP_SECONDS = 20.0
GROUP_REF_LAYERS = 4     # encoder depth of the f32 card-vs-CPU reference (turbo widths, its own 4-layer decoder)
GROUP_REF_WIDTH = 2      # lanes per group in the reference (four sessions, two groups)
GROUP_POOL_TOL = 1e-4    # the two anchor routes' pools: max |difference| over max(1, max |value|)
# the transients at the default lane caps (scheduler._auto_lane_cap at the
# default max_batch_sessions): model, group width, pool dtype, alignment
# heads ("published": the model's own; "fallback": every head of the upper
# half of the decoder, what a checkpoint without a known size name gets)
GROUP_CAPS = (("large-v3-turbo", 64, "bf16", "published"), ("large-v3", 24, "bf16", "published"),
              ("large-v3", 24, "bf16", "fallback"), ("large-v3", 24, "f8", "published"))
GROUP_AB_ITERS = 5       # whole-group against chunked anchor timing, calls each after 3 warm-up calls


@contextlib.contextmanager
def _budget(free=None, temp=None):
    """Stand-in free or transient bytes for the whole-group anchor's guard
    (the smoke's own: the serving code reads the real ones)."""
    from whisperlivekit_tpu_torch.streaming import alignatt as A

    reals = A._device_free_bytes, A._anchor_group_temp_bytes
    if free is not None:
        A._device_free_bytes = lambda *a: free
    if temp is not None:
        A._anchor_group_temp_bytes = lambda *a: temp
    try:
        yield
    finally:
        A._device_free_bytes, A._anchor_group_temp_bytes = reals


class GuardLog:
    """Records every decision of the whole-group anchor's guard (wrapped on
    the dispatch module, where the anchor dispatch looks it up) with the
    free bytes, measured transient and margin it read."""

    def __enter__(self):
        from whisperlivekit_tpu_torch.streaming import alignatt as A
        from whisperlivekit_tpu_torch.streaming import dispatch as D

        self.D, self.real, self.decisions = D, D._whole_group_anchor_fits, []

        def fits(engine, xkv, gi, G, p_max):
            free = A._device_free_bytes(engine.device)
            temp = A._anchor_group_temp_bytes(engine, xkv, G, p_max)
            ok = self.real(engine, xkv, gi, G, p_max)
            self.decisions.append(dict(group=gi, groups=len(xkv.groups), G=G, p_max=p_max, free=free,
                                       temp=temp, margin=A._ANCHOR_HBM_MARGIN, fits=ok))
            return ok
        D._whole_group_anchor_fits = fits
        return self

    def __exit__(self, *exc):
        self.D._whole_group_anchor_fits = self.real


def _group_state(g) -> dict:
    return {n: getattr(g, n).clone() for n in ("k", "v", "skv_k", "skv_v", "asum", "asq", "alast", "acount", "tok")}


def _state_equal(a: dict, b: dict) -> bool:
    return all(torch.equal(a[n].view(torch.uint8) if a[n].is_floating_point() else a[n],
                           b[n].view(torch.uint8) if b[n].is_floating_point() else b[n]) for n in a)


def phase_reference_groups(tok_for) -> None:
    """Two resident groups at turbo widths (the encoder cut to
    GROUP_REF_LAYERS layers), f32, four sessions in two 2-wide groups, on
    the card and on the CPU. The card's engine measures the whole-group
    anchor's transient through its warm pass (precompile_serving_programs),
    and its guard decides from that and the card's free bytes; the CPU,
    which has no memory statistics, is handed the card's transient and just
    enough free bytes. A first tick anchors both groups; then group 1's
    sessions lose their self-KV mirrors and re-anchor together while group 0
    stays resident: both devices run the whole-group program, their integer
    outputs equal and group 0's pools keep every bit. The same anchor,
    started again on the card from group 1's copied pools with the guard
    given one byte less than the transient and margin, takes the chunked
    route: its integer outputs equal the whole-group route's and its pools
    agree within GROUP_POOL_TOL (the self-KV pools over each lane's live
    rows)."""
    from dataclasses import replace

    from whisperlivekit_tpu_torch.engine.core import MODEL_DIMS
    from whisperlivekit_tpu_torch.models.whisper import model as wm
    from whisperlivekit_tpu_torch.streaming import alignatt as A
    from whisperlivekit_tpu_torch.streaming.dispatch import precompile_serving_programs, run_tick_batch

    dims = replace(MODEL_DIMS[GROUP_MODEL], n_audio_layer=GROUP_REF_LAYERS)
    tok = tok_for(dims)
    sides = {}
    for side, dev in (("card", CARD), ("cpu", "cpu")):
        model = wm.init_params(dims, torch.Generator().manual_seed(6), torch.float32, dev)
        eng = A.AlignAttEngine(model, dims, tok, A.AlignAttConfig(language="en"))
        pool, enc_pool = A.AudioPool(8, device=dev), A.EncPool(9, dims, torch.float32, dev)
        xkv = A.XKVAllocator.for_engine(eng, GROUP_REF_WIDTH, epoch_period=50)
        sessions = [A.AlignAttSession(eng) for _ in range(2 * GROUP_REF_WIDTH)]
        for s in sessions:
            s.pool, s.enc_pool, s.xkv_alloc = pool, enc_pool, xkv
        sides[side] = (eng, pool, enc_pool, xkv, sessions)
    eng, pool, enc_pool, xkv, _ = sides["card"]
    warm = precompile_serving_programs(eng, xkv, enc_pool.capacity, pool.capacity)
    p_cap = eng.bucket_for(eng.serving_prefix_cap)
    temp = A._anchor_group_temp_bytes(eng, xkv, GROUP_REF_WIDTH, p_cap)
    log("reference", model=f"{GROUP_MODEL} widths, {GROUP_REF_LAYERS}+{dims.n_text_layer} layers, f32 random",
        warm_s=warm, transient_bytes=eng._serving_transient_bytes)
    if temp is None:
        raise AssertionError("the card's warm pass measured no whole-group anchor transient")
    ints = lambda o: (o.new_tokens, [int(f) for f in o.frames], o.n_keep, o.reason,  # noqa: E731
                      o.last_attend, o.fire)
    pcms = [speech_pcm(8.0, seed=60 + i).astype(np.float32) / 32768.0 for i in range(2 * GROUP_REF_WIDTH)]
    res = {}
    for side, (eng, pool, enc_pool, xkv, sessions) in sides.items():
        stub = _budget(free=temp + A._ANCHOR_HBM_MARGIN, temp=temp) if side == "cpu" else contextlib.nullcontext()
        outs_by_tick = []
        with stub, Instrumented(("alignatt_tick_anchor_group", "alignatt_tick_anchor_pooled")) as ins, \
                GuardLog() as guard, torch.inference_mode():
            for tick in range(2):
                live = sessions if tick == 0 else [s for s in sessions if s.xkv_gi == 1]
                tis = []
                for j, s in enumerate(live):
                    if tick:
                        s.skv_tokens = None  # a lost mirror: this tick re-anchors
                    s.insert_audio(pcms[j][:96000] if tick == 0 else pcms[j][96000:112000])
                    tis.append(s.prepare_tick(False))
                if tick:  # the state the chunked route starts again from
                    start = (_group_state(xkv.groups[1]), enc_pool.pool.clone(), pool.pool.clone())
                    g0 = _group_state(xkv.groups[0])
                outs = run_tick_batch(eng, tis, tok, pool=pool, enc_pool=enc_pool, xkv=xkv)
                for s, ti, o in zip(live, tis, outs):
                    s.finish_tick(ti, o)
                outs_by_tick.append(([t.enc_mode for t in tis], [ints(o) for o in outs]))
            g0_kept = _state_equal(g0, _group_state(xkv.groups[0]))
        res[side] = dict(outs=outs_by_tick, calls=dict(ins.calls), decisions=guard.decisions, g0_kept=g0_kept)
        if side == "card":  # tick 1 again from its starting state, the guard refusing
            g = xkv.groups[1]
            with _budget(free=temp + A._ANCHOR_HBM_MARGIN - 1), torch.inference_mode(), \
                    Instrumented(("alignatt_tick_anchor_group", "alignatt_tick_anchor_pooled")) as ins:
                whole = _group_state(g)
                for n, t in start[0].items():
                    getattr(g, n).copy_(t)
                enc_pool.pool.copy_(start[1])
                pool.pool.copy_(start[2])
                chunked = run_tick_batch(eng, tis, tok, pool=pool, enc_pool=enc_pool, xkv=xkv)
                # self-KV rows past a lane's mirror (prefix + kept tokens) are
                # masked leftovers: the chunked prefill runs at the cap's
                # bucket, the whole-group one at the lanes' own
                live = [(s.xkv_slot, len(s.skv_tokens)) for s in sessions if s.xkv_gi == 1]
                got = {n: getattr(g, n) for n in whole}
                for n in ("skv_k", "skv_v"):
                    got[n], whole[n] = (torch.cat([t[:, sl, :rows].flatten() for sl, rows in live])
                                        for t in (got[n], whole[n]))
                pool_err = {n: float((got[n].float() - w.float()).abs().max()
                                     / max(1.0, float(w.float().abs().max()))) for n, w in whole.items()}
            res["chunked"] = dict(outs=[ints(o) for o in chunked], calls=dict(ins.calls), pool_err=pool_err)
    card, cpu, ch = res["card"], res["cpu"], res["chunked"]
    for side in ("card", "cpu"):
        log("reference", side=side, modes=[m for m, _ in res[side]["outs"]], programs=res[side]["calls"],
            guard=[(d["groups"], d["free"], d["temp"], d["margin"], d["fits"]) for d in res[side]["decisions"]],
            group0_pools_kept=res[side]["g0_kept"])
    log("reference", tick=1, route="chunked (guard given free = transient + margin - 1)", programs=ch["calls"],
        ints_equal_whole_group=ch["outs"] == card["outs"][1][1],
        pool_err_vs_whole_group={n: f"{e:.3g}" for n, e in ch["pool_err"].items()}, tol=GROUP_POOL_TOL)
    want_calls = {"alignatt_tick_anchor_group": 3, "alignatt_tick_anchor_pooled": 0}
    ok = (card["outs"] == cpu["outs"] and card["calls"] == want_calls == cpu["calls"]
          and all(d["groups"] == 2 and d["fits"] for d in card["decisions"]) and len(card["decisions"]) == 3
          and card["g0_kept"] and cpu["g0_kept"]
          and ch["calls"] == {"alignatt_tick_anchor_group": 0, "alignatt_tick_anchor_pooled": 1}
          and ch["outs"] == card["outs"][1][1] and max(ch["pool_err"].values()) <= GROUP_POOL_TOL)
    log("reference", model=f"{GROUP_MODEL} widths, two groups", card_equals_cpu=card["outs"] == cpu["outs"], ok=ok)
    if not ok:
        raise AssertionError("two resident groups: the card's whole-group anchor disagrees with the CPU, "
                             "touched the other group, or the chunked route disagrees")


def _anchor_route_ms(eng, xkv, p_max: int) -> tuple:
    """The whole-group anchor and the chunked anchor at B = the group's
    width, on scratch pools at the group's shapes, in turns: ms by CUDA
    events over GROUP_AB_ITERS calls each after 3 warm-up calls."""
    from whisperlivekit_tpu_torch.streaming.dispatch import _ScratchGroup

    scratch = _ScratchGroup(eng, xkv, xkv.group_width, xkv.group_width)
    with torch.inference_mode():
        whole, chunked = scratch.anchor_group(p_max), scratch.anchor_pooled(xkv.group_width, p_max)
        runs = [(_time_ms(whole, GROUP_AB_ITERS), _time_ms(chunked, GROUP_AB_ITERS)) for _ in range(2)]
    del whole, chunked, scratch
    return [r[0] for r in runs], [r[1] for r in runs]


def _cap_transients(turbo_eng) -> list:
    """The whole-group anchor's transient at the default lane caps
    (GROUP_CAPS) at the cap's prefix bucket, measured on scratch pools:
    turbo on the phase's own engine, large-v3 on random weights drawn for
    it (bf16, then its decoder quantized for the f8 pools), with the
    serving engine's decode budget."""
    from whisperlivekit_tpu_torch.engine.core import MODEL_DIMS
    from whisperlivekit_tpu_torch.models.whisper import model as wm
    from whisperlivekit_tpu_torch.streaming import alignatt as A
    from whisperlivekit_tpu_torch.streaming.dispatch import measure_anchor_group_temp_bytes

    out, large = [], None
    for model, G, pools, heads in GROUP_CAPS:
        if model == GROUP_MODEL:
            eng = turbo_eng
        else:
            if large is None:
                dims = MODEL_DIMS[model]
                large = wm.init_params(dims, torch.Generator().manual_seed(8), torch.bfloat16, "cuda")
            if pools == "f8" and large.decoder.blocks[0].fc1.weight.dtype != torch.float8_e4m3fn:
                wm.quantize_decoder_f8(large)
            eng = A.AlignAttEngine(large, MODEL_DIMS[model], turbo_eng.tokenizer,
                                   A.AlignAttConfig(language="en", xkv_cache_dtype=pools,
                                                    max_steps=turbo_eng.cfg.max_steps),
                                   model_name=model if heads == "published" else None)
        saved = dict(getattr(eng, "_anchor_temp_cache", {}))
        xkv = A.XKVAllocator.for_engine(eng, G)
        p_cap = eng.bucket_for(eng.serving_prefix_cap)
        t = time.perf_counter()
        temp = measure_anchor_group_temp_bytes(eng, xkv, G, p_cap)
        out.append(dict(model=model, G=G, pools=str(xkv.dtype).replace("torch.", ""),
                        decoder="f8" if pools == "f8" else "bf16", heads=heads,
                        align_heads=int(eng.align_layers.shape[0]), p_max=p_cap, transient_bytes=temp,
                        transient_GiB=round(temp / 2**30, 3), s=round(time.perf_counter() - t, 3),
                        pool_bytes=G * A.XKVGroupPool.row_bytes(eng.dims, xkv.dtype, xkv.skv_width,
                                                                xkv.align_count, xkv.skv_dtype)))
        eng._anchor_temp_cache = saved
    del large
    return out


async def _main_path_groups() -> dict:
    from aiohttp import web

    from whisperlivekit_tpu_torch.engine.core import TranscriptionEngine, WLKConfig
    from whisperlivekit_tpu_torch.server.app import WLKServer
    from whisperlivekit_tpu_torch.session.processor import AudioProcessor
    from whisperlivekit_tpu_torch.streaming import alignatt as A
    from whisperlivekit_tpu_torch.streaming.dispatch import measure_anchor_group_temp_bytes

    # 8-wide groups (the one cut: two groups fit in a short phase); an 8 s
    # window evicts every 4 s, so both groups pass anchor epochs together
    config = WLKConfig(model_size=f"random:{GROUP_MODEL}", lan="en", pcm_input=True, vac=False,
                       param_dtype="bfloat16", log_level="WARNING", max_batch_sessions=LG,
                       audio_max_len=8.0)
    t0 = time.perf_counter()
    engine = TranscriptionEngine(config)
    init_s = time.perf_counter() - t0
    if engine.device.type != "cuda":
        raise AssertionError(f"engine landed on {engine.device}, not the card")
    eng, sched = engine.asr.engine, engine.scheduler
    warm = dict(seconds=sched.warm_times, transient_bytes=dict(eng._serving_transient_bytes))
    runner = web.AppRunner(WLKServer(config, engine=engine).app)
    await runner.setup()  # startup runs the engine's warmup tick
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    host, port = runner.addresses[0][:2]
    setup_s = time.perf_counter() - t0
    try:
        # every prefix bucket a pooled anchor can take (prefixes stop at the
        # serving cap), measured on scratch pools; the engine's own figures
        # (the warm pass's) are put back before the run
        saved = dict(eng._anchor_temp_cache)
        buckets = [b for b in eng.prefix_buckets if b <= eng.bucket_for(eng.serving_prefix_cap)]
        by_bucket = {b: measure_anchor_group_temp_bytes(eng, sched.xkv, LG, b) for b in buckets}
        eng._anchor_temp_cache = saved
        with Instrumented(LARGE_PROGRAMS, peak_of="alignatt_tick_anchor_group") as ins, GuardLog() as guard:
            _reset_kernel_counts()
            sched.reset_stats()
            t1 = time.perf_counter()
            pcms = [speech_pcm(GROUP_SECONDS, seed=80 + s) for s in range(GROUP_SESSIONS + 1)]
            procs = [AudioProcessor(transcription_engine=engine) for _ in range(GROUP_SESSIONS)]
            texts = await asyncio.gather(
                *(_feed_processor(p, pcm) for p, pcm in zip(procs, pcms)),
                _feed_websocket(f"http://{host}:{port}/asr", pcms[-1]),
            )
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            counts = _kernel_counts()
        stats = sched.stats()
        phases = dict(A.TICK_PHASE_STATS)
        geom = _large_geom(engine)
        whole_ms, chunked_ms = _anchor_route_ms(eng, sched.xkv, eng.bucket_for(eng.serving_prefix_cap))
        caps = _cap_transients(eng)
    finally:
        await runner.cleanup()
        TranscriptionEngine.reset()
    return dict(texts=texts, wall=wall, init_s=init_s, setup_s=setup_s, warm=warm, by_bucket=by_bucket,
                counts=counts, stats=stats, phases=phases, calls=ins.calls, over_start=ins.over_start,
                decisions=guard.decisions, geom=geom, whole_ms=whole_ms, chunked_ms=chunked_ms, caps=caps)


def phase_groups() -> dict:
    """The large form with two lane groups resident: card against CPU
    (phase_reference_groups), then ``random:large-v3-turbo`` bf16 at full
    width with 8-wide groups: the scheduler's warm pass (each program's
    seconds and transient bytes), the whole-group anchor's transient at
    every prefix bucket, then 12 AudioProcessor sessions and one ``WS
    /asr`` stream joining together (two groups, 8 + 5). Every guard
    decision prints its free bytes, transient, margin and answer; a
    whole-group anchor must run with both groups resident, decided from
    measured bytes, and each must stay within its transient plus the
    margin over its starting allocation. Then both anchor routes timed at
    the group's width, and the transients at the default lane caps."""
    import gc
    import tempfile

    from whisperlivekit_tpu_torch.engine.core import get_tokenizer
    from whisperlivekit_tpu_torch.harness.vocab import install_standin_vocab

    def tok_for(dims):
        return get_tokenizer(True, num_languages=dims.num_languages, language="en", task="transcribe")

    with tempfile.TemporaryDirectory(prefix="wlk_vocab_") as vocab_dir:
        install_standin_vocab(vocab_dir)
        phase_reference_groups(tok_for)
        gc.collect()
        torch.cuda.empty_cache()
        run = asyncio.run(_main_path_groups())
    gc.collect()
    torch.cuda.empty_cache()
    stats, counts = run["stats"], run["counts"]
    words = [sum(len(t.split()) for t, _ in lines) for lines in run["texts"]]
    gib = lambda b: round(b / 2**30, 3) if b is not None else None  # noqa: E731
    log("groups", model=f"random:{GROUP_MODEL} bf16", group_width=LG, sessions=len(words),
        audio_s_each=GROUP_SECONDS, pace=PACE, words_per_session=words, wall_s=round(run["wall"], 3),
        engine_init_s=round(run["init_s"], 3), setup_s=round(run["setup_s"], 3), ticks=stats["n_ticks"],
        avg_lanes=stats["avg_lanes_per_tick"], tick_ms_p50=stats["tick_ms_p50"],
        tick_ms_p95=stats["tick_ms_p95"], word_emission_p50_ms=stats["word_emission_p50_ms"],
        word_emission_p95_ms=stats["word_emission_p95_ms"], failed_ticks=stats["n_failed_ticks"],
        xkv=stats.get("xkv"))
    log("groups", warm_pass_s=run["warm"]["seconds"],
        warm_pass_transient_GiB={k: gib(b) for k, b in run["warm"]["transient_bytes"].items()})
    log("groups", anchor_group_transient_bytes_by_bucket=run["by_bucket"],
        GiB={b: gib(t) for b, t in run["by_bucket"].items()})
    for cap in run["caps"]:
        log("groups", default_cap=True, **cap)
    for key, ph in stats["tick_phases"].items():
        log("groups", tick_phase=key, **ph)
    log("groups", programs=run["calls"], anchor_reasons=stats["anchor_reasons"])
    for d in run["decisions"]:
        log("groups", guard=True, **d)
    whole = [d for d in run["decisions"] if d["fits"]]
    log("groups", anchor_group_over_start_GiB=[gib(b) for b in run["over_start"]],
        budget_GiB=[gib(d["temp"] + d["margin"]) for d in whole])
    log("groups", anchor_ms_whole_group=[round(x, 2) for x in run["whole_ms"]],
        anchor_ms_chunked=[round(x, 2) for x in run["chunked_ms"]], lanes=LG)
    log("groups", kernel="flash_encoder_attn", launches=counts["flash_encoder_attn"],
        launches_by_SxT={f"{s}x{t}": n for (s, t), n in sorted(counts["k1_shapes"].items())})
    log("groups", kernel="xkv_splice", launches=counts["xkv_splice"])
    _check_k1_bodies("groups", counts)
    if stats["n_failed_ticks"]:
        raise AssertionError(f"{stats['n_failed_ticks']} batch ticks failed")
    if "pool_recovery" in run["phases"]:
        raise AssertionError(f"a lane group recovered: {run['phases']['pool_recovery']}")
    if not all(words):
        raise AssertionError(f"a session got no words: {words}")
    if stats["xkv"]["n_groups"] < 2:
        raise AssertionError(f"the run held {stats['xkv']['n_groups']} lane groups, not two")
    shared = [d for d in whole if d["groups"] >= 2]
    if not shared or any(d["temp"] is None or d["free"] is None for d in shared):
        raise AssertionError("no whole-group anchor ran with two groups resident, or one ran without measured "
                             f"bytes: {shared}")
    if len(whole) != run["calls"]["alignatt_tick_anchor_group"] or len(run["over_start"]) != len(whole):
        raise AssertionError(f"{len(whole)} guard approvals against {run['calls']} whole-group calls")
    over = [(b, d["temp"] + d["margin"]) for b, d in zip(run["over_start"], whole) if b > d["temp"] + d["margin"]]
    if over:
        raise AssertionError(f"whole-group anchors past their transient and margin: {over}")
    figures = [run["by_bucket"][b] for b in sorted(run["by_bucket"])]
    if any(a > b for a, b in zip(figures, figures[1:])):
        raise AssertionError(f"the transient grows as the bucket shrinks: {run['by_bucket']}")
    if not (counts["flash_encoder_attn"] and counts["xkv_splice"]):
        raise AssertionError(f"a kernel never launched: {counts}")
    log("groups", geometry=run["geom"])
    return run


LA_SESSIONS = 4      # AudioProcessor sessions in process, plus one over WS /asr
LA_SECONDS = 8.0
# the serving engines' transcribe_kargs. Random weights score far under the
# -1 log-probability threshold, so the default ladder decodes every window
# six times (temperatures 0 to 1), and they rarely sample end-of-text, so
# each attempt runs the full 224 steps; their random timestamps also cut a
# 12 s buffer into ~5 short windows. A call then took 8.7-10.6 s alone on
# an H100 at temperature 0. Real weights rarely fall
# back and stop a window of speech at its last word, ~3 tokens a second:
# the sessions run temperature 0 and at most 64 steps a window
LA_PINNED = dict(temperature=0.0, sample_len=64)
LA_PROFILE_SECONDS = 4.0  # the profiled call's audio (parsing a trace costs host time per kernel)


def phase_reference_la() -> None:
    """Offline decoding in f32 on the card (K1's f32 body in every encode)
    against the CPU, at base widths with 2+2 layers, the weights from one
    seed: ``decode`` at temperature 0 and ``beam_decode`` at 4 beams on one
    window, then ``transcribe`` with word timestamps over 40 s (two
    windows). Tokens, segments and word times must be equal; avg_logprob
    and word probabilities within 1e-4. On the card, sampling at
    temperature 0.6 with best_of 2 must draw the same tokens twice (one
    seed) and keep the timestamp rules."""
    import dataclasses

    from whisperlivekit_tpu_torch.audio.mel import N_SAMPLES, pad_or_trim
    from whisperlivekit_tpu_torch.decoding.options import DecodingOptions
    from whisperlivekit_tpu_torch.decoding.task import WhisperDecoder
    from whisperlivekit_tpu_torch.decoding.transcribe import transcribe
    from whisperlivekit_tpu_torch.engine.core import MODEL_DIMS
    from whisperlivekit_tpu_torch.models.whisper import model as wm

    dims = dataclasses.replace(MODEL_DIMS["base"], n_audio_layer=2, n_text_layer=2)
    audio = speech_pcm(40.0, seed=60).astype(np.float32) / 32768.0
    mel = pad_or_trim(log_mel_spectrogram(torch.from_numpy(audio[: 16000 * 9]), padding=N_SAMPLES), 3000)
    res, launched = {}, 0
    for side, dev in (("card", CARD), ("cpu", "cpu")):
        model = wm.init_params(dims, torch.Generator().manual_seed(2), torch.float32, dev)
        dec = WhisperDecoder(model, dims)
        before = flash_encoder_attn.launches
        greedy = dec.decode(mel, DecodingOptions(language="en", sample_len=64))[0]
        beam = dec.decode(mel, DecodingOptions(language="en", sample_len=24, beam_size=4))[0]
        out = transcribe(dec, audio, language="en", temperature=0.0, word_timestamps=True, sample_len=64)
        if side == "card":
            launched = flash_encoder_attn.launches - before
            # sampling from the card's generator: the same draws per seed
            opts = DecodingOptions(language="en", sample_len=32, temperature=0.6, best_of=2)
            sampled = [dec.decode(mel, opts)[0].tokens for _ in range(2)]
            ts_begin = dec.tokenizer_for("en", "transcribe").timestamp_begin
        res[side] = (greedy, beam, out)
    (gg, gb, gt), (cg, cb, ct) = res["card"], res["cpu"]
    seg = lambda out: [(s["seek"], s["start"], s["end"], s["tokens"]) for s in out["segments"]]  # noqa: E731
    words = lambda out: [(w["word"], w["start"], w["end"]) for s in out["segments"] for w in s["words"]]  # noqa: E731
    probs = lambda out: [w["probability"] for s in out["segments"] for w in s["words"]]  # noqa: E731
    lp_err = max(abs(gg.avg_logprob - cg.avg_logprob), abs(gb.avg_logprob - cb.avg_logprob),
                 *(abs(a["avg_logprob"] - b["avg_logprob"]) for a, b in zip(gt["segments"], ct["segments"])))
    p_err = max((abs(a - b) for a, b in zip(probs(gt), probs(ct))), default=0.0)
    stamps = [t for t in sampled[0] if t >= ts_begin]
    sampled_ok = sampled[0] == sampled[1] and sampled[0][:1] >= [ts_begin] and stamps == sorted(stamps)
    ok = (gg.tokens == cg.tokens and gb.tokens == cb.tokens and seg(gt) == seg(ct)
          and words(gt) == words(ct) and lp_err <= 1e-4 and p_err <= 1e-4 and launched > 0 and sampled_ok)
    log("reference", model="base f32 random, 2+2 layers", calls="decode t=0, beam 4, transcribe 40 s words",
        greedy_tokens=len(gg.tokens), beam_tokens=len(gb.tokens), segments=len(gt["segments"]),
        windows=sorted({s["seek"] for s in gt["segments"]}), words=len(words(gt)),
        avg_logprob_err=lp_err, word_prob_err=p_err, k1_launches=launched,
        sampled_t06_best_of_2=dict(tokens=len(sampled[0]), same_twice=sampled[0] == sampled[1]), ok=ok)
    if not ok:
        raise AssertionError(f"the card's offline decoding disagrees with the CPU: greedy {gg.tokens[:8]} / "
                             f"{cg.tokens[:8]}, beam {gb.tokens[:8]} / {cb.tokens[:8]}, "
                             f"words {words(gt)[:4]} / {words(ct)[:4]}")


class LAInstrumented:
    """Wraps, for the LocalAgreement run: each ``transcribe`` call (host
    wall), each ``WhisperDecoder.decode`` call (its temperature and its
    decode steps, counted per thread from the S=1 ``wm.decode`` calls), and
    each processor's ``finish`` (the words it had committed before its final
    flush). Restores everything on exit."""

    def __init__(self):
        import threading

        from whisperlivekit_tpu_torch.decoding import task as T
        from whisperlivekit_tpu_torch.decoding import transcribe as X
        from whisperlivekit_tpu_torch.streaming import local_agreement as LA
        from whisperlivekit_tpu_torch.streaming import windowed as W

        self.T, self.X, self.procs = T, X, (LA.OnlineASRProcessor, W.WindowedStreamingProcessor)
        self.call_ms, self.attempts, self.committed_before_flush = [], [], []
        self.tls = threading.local()

    def __enter__(self):
        T, X, tls = self.T, self.X, self.tls
        self.real = (X.transcribe, T.WhisperDecoder.decode, T.wm.decode)
        self.real_finish = [cls.__dict__["finish"] for cls in self.procs]
        real_tr, real_dec, real_step = self.real

        def transcribe(*a, **k):
            t = time.perf_counter()
            out = real_tr(*a, **k)
            self.call_ms.append((time.perf_counter() - t) * 1e3)
            return out

        def decode(dec, mel, options=T.DecodingOptions(), enc=None):
            tls.steps = 0
            out = real_dec(dec, mel, options, enc)
            self.attempts.append((options.temperature, tls.steps))
            return out

        def step(model, tokens, *a, **k):
            if tokens.shape[1] == 1:
                tls.steps = getattr(tls, "steps", 0) + 1
            return real_step(model, tokens, *a, **k)

        def finishing(real_finish):
            def finish(proc):
                self.committed_before_flush.append((type(proc).__name__, len(proc.committed)))
                return real_finish(proc)
            return finish

        X.transcribe, T.WhisperDecoder.decode, T.wm.decode = transcribe, decode, step
        for cls, real in zip(self.procs, self.real_finish):
            cls.finish = finishing(real)
        return self

    def __exit__(self, *exc):
        X, T = self.X, self.T
        X.transcribe, T.WhisperDecoder.decode, T.wm.decode = self.real
        for cls, real in zip(self.procs, self.real_finish):
            cls.finish = real


async def _main_path_la(wav_path: str) -> dict:
    """``random:base`` bf16 under ``backend_policy="localagreement"``, all at
    once: AudioProcessor sessions and one ``WS /asr`` stream fed in real
    time, one session of a second engine under ``"windowed"``, one ``POST
    /v1/audio/transcriptions`` and the CLI's ``transcribe --backend-policy
    localagreement`` (in a worker thread, on a third engine built ahead
    into the TestHarness cache the CLI reads). Every engine's backend at
    ``LA_PINNED``, and all three share one backend lock: one decode at a
    time on the card (three locks convoy as five unlocked sessions do)."""
    import aiohttp
    import contextlib
    import io
    from aiohttp import web

    from whisperlivekit_tpu_torch import cli
    from whisperlivekit_tpu_torch.cli_args import parse_args
    from whisperlivekit_tpu_torch.engine.core import TranscriptionEngine, WLKConfig
    from whisperlivekit_tpu_torch.harness import harness
    from whisperlivekit_tpu_torch.server.app import create_app
    from whisperlivekit_tpu_torch.session.processor import AudioProcessor

    kw = dict(model_size="random:base", lan="en", pcm_input=True, vac=False, param_dtype="bfloat16",
              log_level="WARNING")
    cli_argv = ["transcribe", wav_path, "--model-size", "random:base", "--lan", "en", "--no-vac",
                "--backend-policy", "localagreement"]
    cli_kw = cli._harness_kwargs(parse_args(cli_argv[2:]))
    config = WLKConfig(backend_policy="localagreement", **kw)
    t0 = time.perf_counter()
    engines = []
    for make in (lambda: TranscriptionEngine(config),
                 lambda: TranscriptionEngine(WLKConfig(backend_policy="windowed", **kw)),
                 lambda: TranscriptionEngine(**cli_kw)):
        TranscriptionEngine.reset()
        e = make()
        if e.device.type != "cuda" or type(e.asr).__name__ != "LocalAgreementASR":
            raise AssertionError(f"engine on {e.device} with {type(e.asr).__name__}")
        e.asr.asr.transcribe_kargs.update(LA_PINNED)
        e.asr.asr._session_lock = engines[0].asr.asr._session_lock if engines else e.asr.asr._session_lock
        engines.append(e)
    TranscriptionEngine.reset()
    engine, wengine, cli_engine = engines
    harness.reset_engine_cache()
    harness._engine_cache[harness._cache_key(cli_kw)] = cli_engine
    wengine.warmup_synthetic()
    runner = web.AppRunner(create_app(config, engine=engine))
    await runner.setup()  # startup runs the engine's warmup transcription
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    host, port = runner.addresses[0][:2]
    setup_s = time.perf_counter() - t0

    def run_cli():
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(list(cli_argv))
        return rc, out.getvalue().strip(), time.perf_counter() - t

    try:
        with LAInstrumented() as ins:
            _reset_kernel_counts()  # the LocalAgreement path's run counts from here
            t1 = time.perf_counter()
            pcms = [speech_pcm(LA_SECONDS, seed=50 + s) for s in range(LA_SESSIONS + 2)]
            procs = [AudioProcessor(transcription_engine=engine) for _ in range(LA_SESSIONS)]
            wproc = AudioProcessor(transcription_engine=wengine)
            async with aiohttp.ClientSession() as http:
                out = await asyncio.gather(
                    *(_feed_processor(p, pcm) for p, pcm in zip(procs, pcms)),
                    _feed_processor(wproc, pcms[LA_SESSIONS]),
                    _feed_websocket(f"http://{host}:{port}/asr", pcms[LA_SESSIONS + 1]),
                    _post_transcription(http, f"http://{host}:{port}/v1/audio/transcriptions",
                                        _wav_bytes(speech_pcm(LA_SECONDS, seed=58)), "json"),
                    asyncio.to_thread(run_cli),
                )
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            counts = _kernel_counts()
        cli_served = [e is cli_engine for e in harness._engine_cache.values()]
        harness.reset_engine_cache()
    finally:
        await runner.cleanup()
        TranscriptionEngine.reset()
    return dict(texts=out[: LA_SESSIONS + 2], rest=out[-2], cli=out[-1], wall=wall, setup_s=setup_s,
                counts=counts, call_ms=ins.call_ms, attempts=ins.attempts,
                committed_before_flush=ins.committed_before_flush, engine=engine, cli_served=cli_served)


def _la_solo(engine) -> dict:
    """One window alone on the LocalAgreement engine: the ms of a greedy
    decode step (a 30 s window at temperature 0, the encoding done first),
    then one ``transcribe`` call of LA_PROFILE_SECONDS at ``LA_PINNED``,
    traced by torch.profiler (device activity only): the device's busy
    time (its kernels' summed device time) against the same call's wall
    untraced."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from whisperlivekit_tpu_torch.audio.mel import N_SAMPLES, pad_or_trim
    from whisperlivekit_tpu_torch.decoding.options import DecodingOptions

    asr = engine.asr.asr
    dec = asr.decoder
    audio = speech_pcm(30.0, seed=59).astype(np.float32) / 32768.0
    mel = pad_or_trim(log_mel_spectrogram(torch.from_numpy(audio).cuda(), padding=N_SAMPLES), 3000)
    with LAInstrumented() as ins:
        enc = dec.encode(mel)
        torch.cuda.synchronize()
        t = time.perf_counter()
        dec.decode(None, DecodingOptions(language="en"), enc=enc)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t) * 1e3
        steps = ins.attempts[-1][1]
        clip = audio[: int(16000 * LA_PROFILE_SECONDS)]
        asr.transcribe(clip)  # untraced
        torch.cuda.synchronize()
        untraced_ms = ins.call_ms[-1]
        n0 = len(ins.attempts)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            asr.transcribe(clip)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t) * 1e3
        attempts = ins.attempts[n0:]
    ev = prof.key_averages()
    kernels = [e for e in ev if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in ev if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    # the host's waits on the device: the greedy loop's finished.all() each
    # step, and each window's reads of tokens and scores
    waits = [e for e in ev if e.key in ("cudaStreamSynchronize", "cudaMemcpyAsync", "cudaDeviceSynchronize")]
    return dict(decode_ms=decode_ms, steps=steps, ms_per_step=decode_ms / max(steps, 1),
                untraced_ms=untraced_ms, traced_ms=traced_ms, busy_ms=busy_ms,
                busy_share=busy_ms / untraced_ms, busy_share_traced=busy_ms / traced_ms,
                kernels=sum(e.count for e in kernels), launches=launches, attempts=attempts,
                waits=sum(e.count for e in waits), wait_ms=sum(e.cpu_time_total for e in waits) / 1e3)


def phase_la() -> dict:
    """Offline decoding and the LocalAgreement / windowed policies: the card
    against the CPU, then ``random:base`` bf16 serving every entry point at
    once under ``backend_policy="localagreement"``."""
    import gc
    import tempfile
    from pathlib import Path

    from whisperlivekit_tpu_torch.harness.vocab import install_standin_vocab

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="wlk_vocab_") as vocab_dir:
        install_standin_vocab(vocab_dir)
        phase_reference_la()
        wav_path = Path(vocab_dir) / "speech.wav"
        wav_path.write_bytes(_wav_bytes(speech_pcm(LA_SECONDS, seed=57)))
        run = asyncio.run(_main_path_la(str(wav_path)))
        solo = _la_solo(run.pop("engine"))
    counts, ms = run["counts"], run["call_ms"]
    words = [sum(len(t.split()) for t, _ in lines) for lines in run["texts"]]
    status, body, rest_s = run["rest"]
    rest_text = json.loads(body).get("text", "") if status == 200 else ""
    cli_rc, cli_text, cli_s = run["cli"]
    windows = sum(1 for t, _ in run["attempts"] if t == 0)
    steps = sum(s for _, s in run["attempts"])
    log("la", model="random:base bf16", policy="localagreement", sessions=len(words),
        windowed_sessions=1, audio_s_each=LA_SECONDS, pace=PACE, words_per_session=words,
        committed_before_final_flush=run["committed_before_flush"], wall_s=round(run["wall"], 3),
        setup_s=round(run["setup_s"], 3))
    log("la", endpoint="'rest json'", status=status, wall_s=round(rest_s, 3), words=len(rest_text.split()),
        text=repr(rest_text[:120]))
    log("la", endpoint="'cli transcribe'", rc=cli_rc, wall_s=round(cli_s, 3), words=len(cli_text.split()),
        text=repr(cli_text[:120]))
    log("la", transcribe_calls=len(ms), transcribe_ms_p50=_quantile(ms, 0.5), transcribe_ms_p95=_quantile(ms, 0.95),
        windows=windows, decode_attempts=len(run["attempts"]),
        attempts_per_window=round(len(run["attempts"]) / max(windows, 1), 2),
        decode_steps_per_window=round(steps / max(windows, 1), 1),
        attempts_by_temperature=dict(Counter(t for t, _ in run["attempts"])))
    log("la", solo="30 s window, t=0", decode_ms=round(solo["decode_ms"], 1), steps=solo["steps"],
        ms_per_greedy_step=round(solo["ms_per_step"], 3))
    log("la", solo=f"transcribe {LA_PROFILE_SECONDS} s", untraced_ms=round(solo["untraced_ms"], 1),
        traced_ms=round(solo["traced_ms"], 1), device_busy_ms=round(solo["busy_ms"], 1),
        busy_share=round(solo["busy_share"], 4), busy_share_traced=round(solo["busy_share_traced"], 4),
        kernels=solo["kernels"], launches=solo["launches"], attempts=solo["attempts"],
        host_waits=solo["waits"], host_wait_ms_traced=round(solo["wait_ms"], 1))
    log("la", kernel="flash_encoder_attn", launches=counts["flash_encoder_attn"],
        launches_by_SxT={f"{s}x{t}": n for (s, t), n in sorted(counts["k1_shapes"].items())},
        per_window=round(counts["flash_encoder_attn"] / max(windows, 1), 2))
    _check_k1_bodies("la", counts)
    if not all(words):
        raise AssertionError(f"a session got no words: {words}")
    if status != 200 or cli_rc != 0 or run["cli_served"] != [True]:
        raise AssertionError(f"REST {status}, CLI rc {cli_rc}, the CLI's engines {run['cli_served']}")
    if not counts["flash_encoder_attn"]:
        raise AssertionError("K1 never launched in the la phase")
    return run


def phase_kernels_la(launched: dict) -> dict:
    """K1 in bf16 at every (S, T) the la phase launched it: each window's
    encode (and each word-timestamp alignment's) at one lane. Fails on a
    launched (S, T) it did not check. Returns per-case records."""
    records = {}
    for S, T in sorted(launched):
        if (S, T) != (1500, 1500):
            raise AssertionError(f"the la run launched K1 at an unchecked shape {(S, T)}")
        records[(S, T)] = _check_k1("la encoder full window", "base", S, T, T, False, torch.bfloat16, 1, H)
    return records


# ---------------------------------------------------------------------------
# diar_tr: Sortformer diarization and NLLB translation on the card
# ---------------------------------------------------------------------------

DT_SESSIONS = 2          # AudioProcessor sessions in process, plus two over WS /asr (one asks for de)
DT_SECONDS = 12.0
DT_REF_CHUNKS = 20       # 1 s Sortformer chunks in the card-vs-CPU reference (the FIFO fills at 188 frames)
DT_REF_TOL = 1e-4
DT_NLLB_REF_STEPS = 16   # greedy steps in the NLLB reference (2+2 layers at 600M widths)
DT_NLLB_BUCKETS = ((10, 16), (24, 32), (50, 64))  # (source tokens, pad bucket)
# Random weights never produce end-of-text, so every translate call runs to
# its max_len: 128 tokens for a committed segment and 64 for each draft; a
# real translation of a few words ends a few tokens past its source's
# length. The sessions' calls are pinned to these lengths, as the la phase
# pins sample_len (the solo calls time the defaults).
DT_PINNED = {128: 32, 64: 16}
DT_AB_THREADS = 3        # sessions translating at once in the lock A/B


def speech_with_pause(seconds: float, seed: int) -> np.ndarray:
    """speech_pcm with 0.5 s of faint noise first (the energy VAD seeds its
    noise floor there) and 1.5 s of it at the middle: one silence, which
    makes the translator commit its segment on the event loop's thread
    (``validate_buffer_and_reset``) and moves the diarizer's clock."""
    rng = np.random.default_rng(seed + 1000)
    quiet = lambda s: (rng.standard_normal(int(16000 * s)) * 30).astype("<i2")  # noqa: E731
    half = (seconds - 2.0) / 2
    return np.concatenate([quiet(0.5), speech_pcm(half, seed), quiet(1.5), speech_pcm(half, seed + 1)])


def _nemo_tensors(dims, seed: int) -> dict:
    """Every key of NeMo's diar_streaming_sortformer_4spk-v2 state dict at
    ``dims``, in its layouts (Linear [out, in], conv OIHW, depthwise conv1d
    [d, 1, K], pointwise conv1d [out, in, 1]), random f32 values from
    ``seed``: weights N(0, 1/fan_in), LayerNorm weights near 1, batch-norm
    statistics near (0, 1)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def w(name, *shape):
        fan_in = int(np.prod(shape[1:]))
        sd[name] = rng.standard_normal(shape, dtype=np.float32) * np.float32(fan_in ** -0.5)

    def small(name, *shape, center=0.0):
        sd[name] = np.float32(center) + rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    def lin(prefix, d_out, d_in, bias=True):
        w(f"{prefix}.weight", d_out, d_in)
        if bias:
            small(f"{prefix}.bias", d_out)

    C, d, ff, dm = dims.subsampling_channels, dims.d_encoder, dims.encoder_ff, dims.d_model
    w("encoder.pre_encode.conv.0.weight", C, 1, 3, 3)
    small("encoder.pre_encode.conv.0.bias", C)
    for stage in (2, 5):
        w(f"encoder.pre_encode.conv.{stage}.weight", C, 1, 3, 3)
        small(f"encoder.pre_encode.conv.{stage}.bias", C)
        w(f"encoder.pre_encode.conv.{stage + 1}.weight", C, C, 1, 1)
        small(f"encoder.pre_encode.conv.{stage + 1}.bias", C)
    lin("encoder.pre_encode.out", d, C * (-(-dims.n_mels // 8)))
    for i in range(dims.encoder_layers):
        p = f"encoder.layers.{i}"
        for ln in ("norm_feed_forward1", "norm_self_att", "norm_conv", "norm_feed_forward2", "norm_out"):
            small(f"{p}.{ln}.weight", d, center=1.0)
            small(f"{p}.{ln}.bias", d)
        for k in (1, 2):
            lin(f"{p}.feed_forward{k}.linear1", ff, d)
            lin(f"{p}.feed_forward{k}.linear2", d, ff)
        for proj in ("linear_q", "linear_k", "linear_v", "linear_out"):
            lin(f"{p}.self_attn.{proj}", d, d)
        lin(f"{p}.self_attn.linear_pos", d, d, bias=False)
        small(f"{p}.self_attn.pos_bias_u", dims.encoder_heads, d // dims.encoder_heads)
        small(f"{p}.self_attn.pos_bias_v", dims.encoder_heads, d // dims.encoder_heads)
        w(f"{p}.conv.pointwise_conv1.weight", 2 * d, d, 1)
        small(f"{p}.conv.pointwise_conv1.bias", 2 * d)
        w(f"{p}.conv.depthwise_conv.weight", d, 1, dims.conv_kernel)
        small(f"{p}.conv.depthwise_conv.bias", d)
        small(f"{p}.conv.batch_norm.weight", d, center=1.0)
        small(f"{p}.conv.batch_norm.bias", d)
        small(f"{p}.conv.batch_norm.running_mean", d)
        sd[f"{p}.conv.batch_norm.running_var"] = 1.0 + np.abs(rng.standard_normal(d, dtype=np.float32)) * 0.1
        sd[f"{p}.conv.batch_norm.num_batches_tracked"] = np.asarray(1000, np.int64)
        w(f"{p}.conv.pointwise_conv2.weight", d, d, 1)
        small(f"{p}.conv.pointwise_conv2.bias", d)
    lin("sortformer_modules.encoder_proj", dm, d)
    for i in range(dims.head_layers):
        p = f"transformer_encoder.layers.{i}"
        for proj in ("query_net", "key_net", "value_net", "out_projection"):
            lin(f"{p}.first_sub_layer.{proj}", dm, dm)
        lin(f"{p}.second_sub_layer.dense_in", dims.head_ff, dm)
        lin(f"{p}.second_sub_layer.dense_out", dm, dims.head_ff)
        for ln in ("layer_norm_1", "layer_norm_2"):
            small(f"{p}.{ln}.weight", dm, center=1.0)
            small(f"{p}.{ln}.bias", dm)
    lin("sortformer_modules.first_hidden_to_hidden", dm, dm)
    lin("sortformer_modules.hidden_to_spks", dims.max_speakers, dm)
    return sd


def write_nemo(directory, dims, seed: int):
    """A ``.nemo`` tar holding ``model_weights.ckpt`` (a torch state dict of
    ``_nemo_tensors``), as NeMo packs it. Returns (path, bytes)."""
    import tarfile
    from pathlib import Path

    ckpt = Path(directory) / "model_weights.ckpt"
    torch.save({k: torch.from_numpy(v) for k, v in _nemo_tensors(dims, seed).items()}, ckpt)
    path = Path(directory) / "diar_streaming_sortformer_4spk-v2.nemo"
    with tarfile.open(path, "w") as tar:
        tar.add(ckpt, arcname="./model_weights.ckpt")
    ckpt.unlink()
    return str(path), path.stat().st_size


async def _drain_diarizer(sess) -> list:
    out = []
    while True:
        segs = await sess.diarize()
        if not segs:
            return out
        out += segs


def phase_reference_diar_tr() -> None:
    """Sortformer at full width (SortformerDims: 128 mels, 18-layer
    conformer at 512, 18-layer head at 192, 4 speakers, spkcache and FIFO
    188) over DT_REF_CHUNKS chunks of speech-like audio, and NLLB at 600M
    widths with 2+2 layers, in f32 on the card against the CPU, one set of
    seeded weights on both. Sortformer: the cache must have compressed,
    the probabilities stay within DT_REF_TOL, spkcache_len and fifo_len are
    equal every chunk, and the speaker runs are equal except at frames
    whose top two probabilities lie within DT_REF_TOL (logged). NLLB: the
    encoder output and the first step's logits within DT_REF_TOL, their
    top 8 in the same order, and the greedy tokens equal at three pad
    buckets."""
    import copy
    import dataclasses

    from whisperlivekit_tpu_torch.diarization import sortformer as SS
    from whisperlivekit_tpu_torch.diarization import sortformer_model as SM
    from whisperlivekit_tpu_torch.translation import nllb_model as NM

    dims = SM.SortformerDims()
    cpu = SM.init_params(dims, seed=7)
    card = copy.deepcopy(cpu).to(CARD)
    audio = speech_pcm(DT_REF_CHUNKS + 0.5, seed=70).astype(np.float32) / 32768.0
    res = {}
    real_step = SM.streaming_step
    for side, model in (("card", card), ("cpu", cpu)):
        probs, lens = [], []

        def capture(*a, **k):
            p, st = real_step(*a, **k)
            probs.append(p[0].float().cpu().numpy())
            lens.append((int(st.spkcache_len[0]), int(st.fifo_len[0])))
            return p, st
        SM.streaming_step = capture
        try:
            sess = SS.SortformerDiarization(model, dims).new_session()
            sess.insert_audio_chunk(audio)
            segs = asyncio.run(_drain_diarizer(sess))
        finally:
            SM.streaming_step = real_step
        res[side] = (np.stack(probs), lens, [(g.speaker, g.start, g.end) for g in segs])
    (gp, gl, gs), (cp, cl, cs) = res["card"], res["cpu"]
    err = float(np.abs(gp - cp).max())
    top2 = np.sort(cp, axis=-1)[..., -2:]
    near = (top2[..., 1] - top2[..., 0]) <= DT_REF_TOL
    differ = gp.argmax(-1) != cp.argmax(-1)
    ties = [(int(c), int(f)) for c, f in zip(*np.nonzero(differ & near))]
    ok = (err <= DT_REF_TOL and gl == cl and gl[-1][0] > 0 and not (differ & ~near).any()
          and (gs == cs or ties))
    log("reference", model="Sortformer full width f32 random", chunks=len(gl), frames_per_chunk=gp.shape[1],
        max_abs_err=err, tol=DT_REF_TOL, spkcache_len=gl[-1][0], fifo_len=gl[-1][1],
        compressions=sum(1 for c, f in gl if c > 0), segments=len(gs), segments_equal=gs == cs,
        near_tie_frames_that_differ=ties, ok=ok)
    if not ok:
        raise AssertionError(f"the card's Sortformer disagrees with the CPU: err {err}, lens {gl[-3:]} / "
                             f"{cl[-3:]}, differing frames {np.argwhere(differ)[:5].tolist()}")
    del card, cpu

    nd = dataclasses.replace(NM.NLLB_SIZES["600M"], encoder_layers=2, decoder_layers=2)
    cpu_n = NM.init_params(nd, seed=8)
    card_n = copy.deepcopy(cpu_n).to(CARD)
    rng = np.random.default_rng(71)
    errs, equal, lengths = [], [], []
    for n_src, bucket in DT_NLLB_BUCKETS:
        src = np.full((1, bucket), nd.pad_token_id, np.int64)
        src[0, :n_src] = rng.integers(4, nd.vocab_size, n_src)
        mask = np.arange(bucket)[None] < n_src
        bos = int(rng.integers(4, nd.vocab_size))
        out = {}
        for side, m in (("card", card_n), ("cpu", cpu_n)):
            dev = m.device
            s_t, m_t = torch.from_numpy(src).to(dev), torch.from_numpy(mask).to(dev)
            with torch.no_grad():
                enc = NM.encode(m, s_t, nd, pad_mask=m_t)
                xk, xv = NM.cross_kv(m, enc, nd)
                cache = NM.init_cache(nd, 1, 4, dtype=m.dtype, device=dev)
                logits, _ = NM.decode(m, torch.tensor([[2, bos]], device=dev), torch.zeros(1, dtype=torch.long,
                                      device=dev), xk, xv, cache, nd, m_t)
            toks = NM.greedy_translate(m, s_t, m_t, torch.tensor([bos], device=dev), 2, nd, DT_NLLB_REF_STEPS)
            out[side] = (enc.float().cpu().numpy(), logits.float().cpu().numpy(), toks.cpu().tolist())
        errs.append(max(float(np.abs(out["card"][0] - out["cpu"][0]).max()),
                        float(np.abs(out["card"][1] - out["cpu"][1]).max())))
        # random weights repeat one token, so the ranking of the first
        # step's logits carries the comparison as well as the tokens
        top = [np.argsort(-out[side][1][0, -1], kind="stable")[:8].tolist() for side in ("card", "cpu")]
        equal.append(out["card"][2] == out["cpu"][2] and top[0] == top[1])
        lengths.append(len(set(out["cpu"][2][0])))
    ok = all(equal) and max(errs) <= DT_REF_TOL
    log("reference", model="NLLB 600M widths f32 random, 2+2 layers", buckets=[b for _, b in DT_NLLB_BUCKETS],
        steps=DT_NLLB_REF_STEPS, max_abs_err_enc_logits=max(errs), tol=DT_REF_TOL, tokens_and_top8_equal=equal,
        distinct_tokens=lengths, ok=ok)
    if not ok:
        raise AssertionError(f"the card's NLLB disagrees with the CPU: tokens equal {equal}, errs {errs}")


class DTInstrumented:
    """Wraps, for the diar_tr run: every AudioProcessor built (in process
    and behind WS /asr), each Sortformer chunk (host wall on the calling
    thread, which is the event loop's), each NLLB translate (its wall with
    the model's lock wait, the greedy loop's wall inside the lock, its
    max_len and decoder steps, its thread and target language), each
    translation merged (per session), and the lag from a committed token's
    routing to its translation's merge. Restores everything on exit."""

    def __init__(self):
        import threading

        from whisperlivekit_tpu_torch.diarization import sortformer as SS
        from whisperlivekit_tpu_torch.session import processor as P
        from whisperlivekit_tpu_torch.translation import nllb as NL
        from whisperlivekit_tpu_torch.translation import nllb_model as NM

        self.SS, self.P, self.NL, self.NM = SS, P, NL, NM
        self.procs, self.chunks, self.calls, self.lags = [], [], [], []
        self.merges = Counter()
        self.tls = threading.local()
        self.threading = threading

    def __enter__(self):
        SS, P, NL, NM, tls, th = self.SS, self.P, self.NL, self.NM, self.tls, self.threading
        self.real = dict(init=P.AudioProcessor.__init__, diarize=SS.SortformerDiarizationOnline.diarize,
                         translate=NL.NLLBModel.translate, greedy=NM.greedy_translate, decode=NM.decode,
                         merge=P.StateStore.merge_translation, route=P.TranslationRouter.route,
                         on_other=P.TranslateWorker.on_other)
        real, stamps = self.real, {}

        def init(proc, *a, **k):
            real["init"](proc, *a, **k)
            self.procs.append(proc)

        async def diarize(sess):
            t = time.perf_counter()
            out = await real["diarize"](sess)
            if out:
                self.chunks.append((id(sess), (time.perf_counter() - t) * 1e3,
                                    th.current_thread() is th.main_thread()))
            return out

        def translate(model, text, src, tgt, max_len=128):
            max_len = DT_PINNED.get(max_len, max_len)
            tls.steps, tls.inner_ms = 0, 0.0
            t = time.perf_counter()
            out = real["translate"](model, text, src, tgt, max_len)
            self.calls.append(dict(ms=(time.perf_counter() - t) * 1e3, inner_ms=tls.inner_ms, max_len=max_len,
                                   steps=max(tls.steps - 1, 0), tgt=tgt, text=out,
                                   on_loop=th.current_thread() is th.main_thread()))
            return out

        def greedy(*a, **k):
            t = time.perf_counter()
            out = real["greedy"](*a, **k)
            tls.inner_ms = (time.perf_counter() - t) * 1e3
            return out

        def decode(*a, **k):
            tls.steps = getattr(tls, "steps", 0) + 1
            return real["decode"](*a, **k)

        async def merge(store, translation, buffer):
            self.merges[id(store)] += 1
            return await real["merge"](store, translation, buffer)

        async def route(router, tokens):
            for t in tokens or ():
                stamps[id(t)] = time.perf_counter()
            return await real["route"](router, tokens)

        async def on_other(worker, item):
            out = await real["on_other"](worker, item)
            if id(item) in stamps:
                self.lags.append(time.perf_counter() - stamps.pop(id(item)))
            return out

        P.AudioProcessor.__init__, SS.SortformerDiarizationOnline.diarize = init, diarize
        NL.NLLBModel.translate, NM.greedy_translate, NM.decode = translate, greedy, decode
        P.StateStore.merge_translation, P.TranslationRouter.route, P.TranslateWorker.on_other = merge, route, on_other
        return self

    def __exit__(self, *exc):
        SS, P, NL, NM, real = self.SS, self.P, self.NL, self.NM, self.real
        P.AudioProcessor.__init__, SS.SortformerDiarizationOnline.diarize = real["init"], real["diarize"]
        NL.NLLBModel.translate, NM.greedy_translate, NM.decode = real["translate"], real["greedy"], real["decode"]
        P.StateStore.merge_translation, P.TranslationRouter.route = real["merge"], real["route"]
        P.TranslateWorker.on_other = real["on_other"]


def _dt_solo(engine) -> dict:
    """After the sessions, on the same models: a Sortformer chunk and an
    NLLB call of each default length (64 and 128 steps) alone, their peak
    card memory over the weights; one 32-step call traced by torch.profiler
    (device activity only) for its launches a step; then the lock A/B:
    DT_AB_THREADS threads each translating once at DT_PINNED's emit length,
    unlocked and with the model's lock, in turns (unlocked, locked, locked,
    unlocked), and the same calls one after another."""
    import contextlib
    import threading

    from torch.profiler import ProfilerActivity, profile

    from whisperlivekit_tpu_torch.translation import nllb_model as NM

    shared, model = engine.diarization_model, engine.translation_model.nllb
    out = {}
    nbytes = lambda m: sum(p.numel() * p.element_size() for p in m.parameters())  # noqa: E731
    sess = shared.new_session()
    sess.insert_audio_chunk(speech_pcm(3.0, seed=80).astype(np.float32) / 32768.0)
    asyncio.run(sess.diarize())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    asyncio.run(sess.diarize())
    out["diarize_solo_ms"] = (time.perf_counter() - t) * 1e3
    out["sortformer"] = dict(weights_GB=nbytes(shared.params) / 2**30,
                             peak_over_base_GB=(torch.cuda.max_memory_allocated() - base) / 2**30)
    steps = [0]
    real_decode = NM.decode

    def counting(*a, **k):
        steps[0] += 1
        return real_decode(*a, **k)
    NM.decode = counting
    try:
        text = "a sentence of a few words, as a session commits it."
        model.translate(text, "en", "fr", max_len=8)
        for max_len in (64, 128):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            steps[0] = 0
            t = time.perf_counter()
            model.translate(text, "en", "fr", max_len=max_len)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            out[f"translate_{max_len}"] = dict(ms=ms, steps=steps[0] - 1, ms_per_step=ms / max(steps[0] - 1, 1))
        out["nllb"] = dict(weights_GB=nbytes(model.params) / 2**30,
                           peak_over_base_GB=(torch.cuda.max_memory_allocated() - base) / 2**30)
        steps[0] = 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model.translate(text, "en", "fr", max_len=32)
            torch.cuda.synchronize()
        n_steps = steps[0] - 1
    finally:
        NM.decode = real_decode
    ev = prof.key_averages()
    launches = sum(e.count for e in ev if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    out["launches_per_step"] = launches / max(n_steps, 1)

    def burst(lock) -> float:
        real_lock, model.lock = model.lock, lock

        def work():
            model.translate(text, "en", "fr", max_len=DT_PINNED[128])
        ths = [threading.Thread(target=work) for _ in range(DT_AB_THREADS)]
        t = time.perf_counter()
        try:
            for th in ths:
                th.start()
            for th in ths:
                th.join()
            torch.cuda.synchronize()
        finally:
            model.lock = real_lock
        return time.perf_counter() - t

    out["lock_ab_s"] = [(arm, round(burst(contextlib.nullcontext() if arm == "unlocked" else threading.Lock()), 3))
                        for arm in ("unlocked", "locked", "locked", "unlocked")]
    t = time.perf_counter()
    for _ in range(DT_AB_THREADS):
        model.translate(text, "en", "fr", max_len=DT_PINNED[128])
    torch.cuda.synchronize()
    out["one_after_another_s"] = round(time.perf_counter() - t, 3)
    return out


async def _main_path_diar_tr(nemo_path: str) -> dict:
    """``random:base`` bf16 with ``diarization=True`` (Sortformer from the
    written .nemo, converted onto the card at engine start) and
    ``target_language="fr"`` (NLLB at 600M widths in bf16, seeded random,
    with the stand-in tokenizer, installed as the engine's shared model
    before the first session): AudioProcessor sessions and two ``WS /asr``
    streams, one asking ``?target_language=de``, fed in real time."""
    from aiohttp import web

    from whisperlivekit_tpu_torch.diarization import sortformer as SS
    from whisperlivekit_tpu_torch.engine.core import TranscriptionEngine, WLKConfig
    from whisperlivekit_tpu_torch.harness.vocab import StandinNLLBTokenizer
    from whisperlivekit_tpu_torch.server.app import WLKServer
    from whisperlivekit_tpu_torch.session.processor import AudioProcessor
    from whisperlivekit_tpu_torch.translation import nllb as NL
    from whisperlivekit_tpu_torch.translation import nllb_model as NM

    config = WLKConfig(model_size="random:base", lan="en", pcm_input=True, vac=True, param_dtype="bfloat16",
                       log_level="WARNING", diarization=True, sortformer_model_path=nemo_path,
                       target_language="fr")
    t0 = time.perf_counter()
    engine = TranscriptionEngine(config)
    sortformer_load_s = time.perf_counter() - t0
    shared = engine.diarization_model
    if not (isinstance(shared, SS.SortformerDiarization) and shared.params.device.type == "cuda"
            and shared.dims == SS.S.SortformerDims()):
        raise AssertionError(f"diarization model {type(shared).__name__} on {getattr(shared, 'params', None)}")
    nd = NM.NLLB_SIZES["600M"]
    t1 = time.perf_counter()
    engine.translation_model.nllb = NL.NLLBModel(NM.init_params(nd, seed=9, dtype=torch.bfloat16, device="cuda"),
                                                 nd, StandinNLLBTokenizer())
    torch.cuda.synchronize()
    nllb_init_s = time.perf_counter() - t1
    runner = web.AppRunner(WLKServer(config, engine=engine).app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    host, port = runner.addresses[0][:2]
    setup_s = time.perf_counter() - t0
    try:
        with DTInstrumented() as ins:
            _reset_kernel_counts()  # the diar_tr path's run counts from here
            engine.scheduler.reset_stats()
            t2 = time.perf_counter()
            pcms = [speech_with_pause(DT_SECONDS, seed=90 + 2 * s) for s in range(DT_SESSIONS + 2)]
            procs = [AudioProcessor(transcription_engine=engine) for _ in range(DT_SESSIONS)]
            url = f"http://{host}:{port}/asr"
            lines = await asyncio.gather(
                *(_feed_processor(p, pcm, raw=True) for p, pcm in zip(procs, pcms)),
                _feed_websocket(url, pcms[DT_SESSIONS], raw=True),
                _feed_websocket(url + "?target_language=de", pcms[DT_SESSIONS + 1], raw=True),
            )
            torch.cuda.synchronize()
            wall = time.perf_counter() - t2
            counts = _kernel_counts()
        stats = engine.scheduler.stats()
    finally:
        await runner.cleanup()
        TranscriptionEngine.reset()
    sessions = [dict(diar=id(p.diarization), tr=p.translation, store=id(p.store)) for p in ins.procs
                if p.translation is not None]
    return dict(lines=lines, wall=wall, setup_s=setup_s, sortformer_load_s=sortformer_load_s,
                nllb_init_s=nllb_init_s, counts=counts, stats=stats, ins=ins, sessions=sessions, engine=engine)


def phase_diar_tr(main_run: dict) -> dict:
    """Diarization and translation on the card: the f32 references, then the
    serving run (see ``_main_path_diar_tr``) with a Sortformer .nemo written
    at full width in a temporary directory (deleted at the end)."""
    import gc
    import tempfile

    from whisperlivekit_tpu_torch.harness.vocab import install_standin_vocab
    from whisperlivekit_tpu_torch.diarization import sortformer_model as SM

    gc.collect()
    torch.cuda.empty_cache()
    phase_reference_diar_tr()
    with tempfile.TemporaryDirectory(prefix="wlk_diar_tr_") as tmp:
        install_standin_vocab(tmp)
        t = time.perf_counter()
        nemo_path, nemo_bytes = write_nemo(tmp, SM.SortformerDims(), seed=11)
        write_s = time.perf_counter() - t
        run = asyncio.run(_main_path_diar_tr(nemo_path))
        solo = _dt_solo(run.pop("engine"))
    ins, stats, counts = run["ins"], run["stats"], run["counts"]
    words = [sum(len(ln["text"].split()) for ln in lines) for lines in run["lines"]]
    speakers = [sorted({ln["speaker"] for ln in lines if ln.get("text")}) for lines in run["lines"]]
    with_translation = [sum(1 for ln in lines if ln.get("translation") is not None) for lines in run["lines"]]
    per_session = Counter(sid for sid, _, _ in ins.chunks)
    chunk_ms = [ms for _, ms, _ in ins.chunks]
    diar_sessions = [per_session[s["diar"]] for s in run["sessions"]]
    merges = [ins.merges[s["store"]] for s in run["sessions"]]
    tgts = sorted({s["tr"].tgt for s in run["sessions"]})
    calls = ins.calls
    steps = [c["steps"] for c in calls]
    inner = [c["inner_ms"] for c in calls]
    waits = [c["ms"] - c["inner_ms"] for c in calls]
    loop_calls = [c for c in calls if c["on_loop"]]
    texts = [c["text"] for c in calls]
    log("diar_tr", model="random:base bf16, Sortformer full width f32 (.nemo), NLLB 600M bf16", vac=True,
        sessions=len(words), audio_s_each=DT_SECONDS, pace=PACE, words_per_session=words,
        line_speakers_per_session=speakers, lines_with_translation=with_translation,
        translations_merged_per_session=merges, targets=tgts, wall_s=round(run["wall"], 3),
        setup_s=round(run["setup_s"], 3), nemo_GB=round(nemo_bytes / 2**30, 3), nemo_write_s=round(write_s, 2),
        sortformer_load_s=round(run["sortformer_load_s"], 2), nllb_init_s=round(run["nllb_init_s"], 2),
        ticks=stats["n_ticks"], failed_ticks=stats["n_failed_ticks"])
    log("diar_tr", diarize_chunks_per_session=diar_sessions, diarize_ms_p50=_quantile(chunk_ms, 0.5),
        diarize_ms_p95=_quantile(chunk_ms, 0.95), on_event_loop_thread=all(on for _, _, on in ins.chunks),
        solo_chunk_ms=round(solo["diarize_solo_ms"], 2))
    log("diar_tr", translate_calls=len(calls), translate_ms_p50=_quantile(inner, 0.5),
        translate_ms_p95=_quantile(inner, 0.95), lock_wait_ms_p50=_quantile(waits, 0.5),
        lock_wait_ms_p95=_quantile(waits, 0.95), steps_per_call=dict(Counter(steps)),
        ms_per_step_in_run=round(sum(inner) / max(sum(steps), 1), 3), pinned=DT_PINNED,
        loop_thread_calls=len(loop_calls), loop_thread_translate_ms=round(sum(c["ms"] for c in loop_calls), 1),
        translation_lag_s_p50=_quantile(ins.lags, 0.5), translation_lag_s_p95=_quantile(ins.lags, 0.95), nonempty_texts=sum(1 for x in texts if x),
        sample_texts=[repr(x[:24]) for x in texts[:3]])
    log("diar_tr", solo=f"translate 64 and 128 steps, {solo['launches_per_step']:.0f} launches a step",
        ms_64=round(solo["translate_64"]["ms"], 1), ms_128=round(solo["translate_128"]["ms"], 1),
        ms_per_step=round(solo["translate_128"]["ms_per_step"], 3), launches_per_step=round(solo["launches_per_step"], 1))
    log("diar_tr", lock_ab=f"{DT_AB_THREADS} threads x 1 call of {DT_PINNED[128]} steps",
        arms_s=solo["lock_ab_s"], one_after_another_s=solo["one_after_another_s"])
    log("diar_tr", sortformer_weights_GB=round(solo["sortformer"]["weights_GB"], 3),
        sortformer_peak_over_weights_GB=round(solo["sortformer"]["peak_over_base_GB"], 4),
        nllb_weights_GB=round(solo["nllb"]["weights_GB"], 3),
        nllb_peak_over_weights_GB=round(solo["nllb"]["peak_over_base_GB"], 4))
    log("diar_tr", word_emission_p50_ms=stats["word_emission_p50_ms"],
        word_emission_p95_ms=stats.get("word_emission_p95_ms"),
        main_word_emission_p50_ms=main_run["stats"]["word_emission_p50_ms"],
        main_word_emission_p95_ms=main_run["stats"].get("word_emission_p95_ms"),
        tick_ms_p50=stats["tick_ms_p50"], main_tick_ms_p50=main_run["stats"]["tick_ms_p50"])
    log("diar_tr", kernel="flash_encoder_attn", launches=counts["flash_encoder_attn"],
        launches_by_SxT={f"{s}x{t}": n for (s, t), n in sorted(counts["k1_shapes"].items())},
        per_tick=round(counts["flash_encoder_attn"] / max(stats["n_ticks"], 1), 2))
    _check_k1_bodies("diar_tr", counts)
    if stats["n_failed_ticks"]:
        raise AssertionError(f"{stats['n_failed_ticks']} batch ticks failed")
    if not all(words):
        raise AssertionError(f"a session got no words: {words}")
    if len(run["sessions"]) != DT_SESSIONS + 2 or not all(diar_sessions) or not all(speakers):
        raise AssertionError(f"a session got no Sortformer segments: chunks {diar_sessions}, speakers {speakers}")
    if not all(merges) or tgts != ["de", "fr"] or not loop_calls:
        raise AssertionError(f"translations merged {merges}, targets {tgts}, loop-thread calls {len(loop_calls)}")
    if not counts["flash_encoder_attn"]:
        raise AssertionError("K1 never launched in the diar_tr phase")
    return run


def phase_kernels_base(phase: str, launched: dict, b: int = B) -> dict:
    """K1 in bf16 at every (S, T) a base-form phase (diar_tr, vad, the
    capacity sweep's base arm) launched it, at the phase's batch ``b``: the
    encoder's full window and tail, and each prefill bucket over the pool.
    Fails on a launched (S, T) it did not check."""
    records = {}
    for S, T in sorted(launched):
        if (S, T) == (1500, 1500):
            label, vt = f"{phase} encoder full window", False
        elif (S, T) == (384, 384):
            label, vt = f"{phase} encoder tail", False
        elif T == 1500 and S in PREFIX_BUCKETS:
            label, vt = f"{phase} prefill cross-attention, bucket {S}", True
        else:
            raise AssertionError(f"the {phase} run launched K1 at an unchecked shape {(S, T)}")
        records[(S, T)] = _check_k1(label, "base", S, T, T, vt, torch.bfloat16, b, H)
    return records


# ---------------------------------------------------------------------------
# vad: the batched Silero VAD (vad_backend="jax-batched") on the card
# ---------------------------------------------------------------------------

VAD_SEED = 21            # the stand-in's weights; its head is calibrated on calibration_audio(VAD_SEED + 1)
VAD_REF_LANES = 64       # card against CPU: lanes x frames of speech_with_pause, state carried
VAD_REF_FRAMES = 90
VAD_REF_TOL = 2e-4       # the JAX suite's Silero bar (tests/test_vad_jax.py:50)
VAD_ISO_LANES = 8        # lanes stepped together against one-lane runs, on the card
VAD_ISO_TOL = 1e-5       # tests/test_vad_jax.py:65
VAD_SESSIONS = 16        # AudioProcessor sessions in process, plus one over WS /asr
VAD_SECONDS = 12.0
VAD_PROFILE_STEPS = 8    # direct sub-steps traced for the kernels a step
VAD_SOLO_LANES = (1, 17, 64, 256)  # lanes of the direct sub-steps timed after the run
VAD_STANDIN_DIR = "build/vad_standin"  # (ignored by git) the stand-in and the stand-in vocabulary


def _vad_audio(lanes: int, frames: int, seed: int) -> np.ndarray:
    """[lanes, frames * 512] f32: speech_with_pause, one seed a lane."""
    n = frames * 512
    return np.stack([speech_with_pause(n / 16000 + 0.1, seed + i)[:n] for i in range(lanes)]).astype(np.float32) / 32768.0


def _vad_run(params, audio: np.ndarray) -> tuple:
    """vad_step over every frame of ``audio`` on the params' device, state
    carried: (probs [F, B], h [F, B, 128], c, context [F, B, 64]) on the CPU."""
    from whisperlivekit_tpu_torch.audio import vad_model as VM

    dev = params.stft_basis.device
    x = torch.from_numpy(audio).to(dev)
    st = VM.init_state(audio.shape[0], dev)
    out = []
    for i in range(audio.shape[1] // 512):
        p, st = VM.vad_step(params, st, x[:, i * 512 : (i + 1) * 512])
        out.append((p, st.h, st.c, st.context))
    return tuple(torch.stack(t).cpu() for t in zip(*out))


def phase_reference_vad(path: str) -> None:
    """The stand-in's tower on the card against the CPU: VAD_REF_LANES lanes
    x VAD_REF_FRAMES frames, state carried. Probabilities, h and c within
    VAD_REF_TOL and the context exact under the smoke's TF32 flags (off)
    and under torch's defaults (cuDNN on, cuBLAS off); printed with both on
    too (not held: matrix products in TF32). Then VAD_ISO_LANES lanes
    stepped together against each stepped alone on the card."""
    from whisperlivekit_tpu_torch.audio import vad_model as VM

    cpu, card = VM.load_params(path, device="cpu"), VM.load_params(path, device="cuda")
    audio = _vad_audio(VAD_REF_LANES, VAD_REF_FRAMES, seed=300)
    want = _vad_run(cpu, audio)
    errs = {}
    for name, flags in (("off", (False, False)), ("defaults", (False, True)), ("both_on", (True, True))):
        with _tf32_flags(*flags):
            got = _vad_run(card, audio)
        errs[name] = dict(prob=(got[0] - want[0]).abs().max().item(), h=(got[1] - want[1]).abs().max().item(),
                          c=(got[2] - want[2]).abs().max().item(), context_equal=torch.equal(got[3], want[3]))
    probs = want[0]
    log("vad_ref", lanes=VAD_REF_LANES, frames=VAD_REF_FRAMES, tol=VAD_REF_TOL,
        share_over_0_5=round((probs > 0.5).float().mean().item(), 3),
        share_under_0_35=round((probs < 0.35).float().mean().item(), 3),
        **{f"max_err_tf32_{k}": v for k, v in errs.items()})
    for name in ("off", "defaults"):
        e = errs[name]
        if not (max(e["prob"], e["h"], e["c"]) <= VAD_REF_TOL and e["context_equal"]):
            raise AssertionError(f"the VAD step on the card disagrees with the CPU (TF32 {name}): {e}")
    together = _vad_run(card, audio[:VAD_ISO_LANES])
    alone = [_vad_run(card, audio[i : i + 1]) for i in range(VAD_ISO_LANES)]
    iso = max((together[k][:, i] - alone[i][k][:, 0]).abs().max().item()
              for i in range(VAD_ISO_LANES) for k in range(3))
    log("vad_ref", lane_isolation_lanes=VAD_ISO_LANES, lane_isolation_max_err=iso, tol=VAD_ISO_TOL)
    if not iso <= VAD_ISO_TOL:
        raise AssertionError(f"VAD lanes stepped together differ from one-lane runs: {iso}")


class VADInstrumented:
    """Wraps, for a vad run: every AudioProcessor built (in process and
    behind WS /asr), each gate transition that changed the gate (its
    session, close or open, stream seconds), and each chunk's VAD call:
    the batched path's await on the event loop's thread
    (AsyncFixedVADIterator.__call__) and the host path's call in its worker
    thread (FixedVADIterator.__call__), in ms. Restores everything on exit."""

    def __init__(self):
        from whisperlivekit_tpu_torch.audio import vad as V
        from whisperlivekit_tpu_torch.audio import vad_batched as VB
        from whisperlivekit_tpu_torch.session import processor as P

        self.V, self.VB, self.P = V, VB, P
        self.procs, self.gate, self.vad_ms = [], [], []

    def __enter__(self):
        V, VB, P = self.V, self.VB, self.P
        self.real = real = dict(init=P.AudioProcessor.__init__, close=P.SilenceGate.close,
                                open=P.SilenceGate.open, acall=VB.AsyncFixedVADIterator.__call__,
                                call=V.FixedVADIterator.__call__)

        def init(proc, *a, **k):
            real["init"](proc, *a, **k)
            self.procs.append(proc)

        async def close(gate, at_seconds):
            was = gate.closed
            out = await real["close"](gate, at_seconds)
            if not was:
                self.gate.append((id(gate), "close", at_seconds))
            return out

        async def open_(gate, at_seconds):
            was = gate.closed
            out = await real["open"](gate, at_seconds)
            if was:
                self.gate.append((id(gate), "open", at_seconds))
            return out

        async def acall(it, x, return_seconds=False):
            t = time.perf_counter()
            out = await real["acall"](it, x, return_seconds)
            self.vad_ms.append((time.perf_counter() - t) * 1e3)
            return out

        def call(it, x, return_seconds=False):
            t = time.perf_counter()
            out = real["call"](it, x, return_seconds)
            self.vad_ms.append((time.perf_counter() - t) * 1e3)
            return out

        P.AudioProcessor.__init__, P.SilenceGate.close, P.SilenceGate.open = init, close, open_
        VB.AsyncFixedVADIterator.__call__, V.FixedVADIterator.__call__ = acall, call
        return self

    def __exit__(self, *exc):
        V, VB, P, real = self.V, self.VB, self.P, self.real
        P.AudioProcessor.__init__, P.SilenceGate.close, P.SilenceGate.open = real["init"], real["close"], real["open"]
        VB.AsyncFixedVADIterator.__call__, V.FixedVADIterator.__call__ = real["acall"], real["call"]


class _Result:
    """A future's stand-in for sub-steps driven directly (``_step``)."""

    def done(self) -> bool:
        return False

    def set_result(self, value) -> None:
        self.value = value


def _vad_solo(sched, max_lanes: int) -> dict:
    """Direct sub-steps on the run's scheduler after its sessions: the ms of
    one (host clock, the read of the probabilities included; 3 warm-up, 20
    timed) at each of VAD_SOLO_LANES lanes, and VAD_PROFILE_STEPS of them at
    the run's busiest lane count traced by torch.profiler (device activity
    only) for the kernels and copies a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    frames = _vad_audio(1, 1, seed=499)[0]

    def step(n):
        sched._step([(lane, frames, _Result()) for lane in range(n)])

    ms = {}
    for n in VAD_SOLO_LANES:
        if n > sched.capacity:
            continue
        for _ in range(3):
            step(n)
        t = time.perf_counter()
        for _ in range(20):
            step(n)
        ms[n] = round((time.perf_counter() - t) * 1e3 / 20, 4)
    step(max_lanes)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(VAD_PROFILE_STEPS):
            step(max_lanes)
        torch.cuda.synchronize()
    ev = prof.key_averages()
    kernels = sum(e.count for e in ev if e.device_type == DeviceType.CUDA and "Memcpy" not in e.key
                  and "Memset" not in e.key)
    copies = sum(e.count for e in ev if e.device_type == DeviceType.CUDA and "Memcpy" in e.key)
    busy_us = sum(e.self_device_time_total for e in ev if e.device_type == DeviceType.CUDA)
    return dict(step_ms_by_lanes=ms, kernels_per_step=kernels / VAD_PROFILE_STEPS,
                copies_per_step=copies / VAD_PROFILE_STEPS, device_us_per_step=busy_us / VAD_PROFILE_STEPS)


async def _main_path_vad(backend: str) -> dict:
    """``random:base`` bf16 with ``vac=True`` and ``vad_backend=backend``
    ("jax-batched": the batched Silero VAD on the card; "auto": the host
    path, torch.jit on the CPU in a worker thread), the stand-in in
    WLK_TPU_ASSET_DIR: AudioProcessor sessions and one ``WS /asr`` stream,
    fed in real time together."""
    from aiohttp import web

    from whisperlivekit_tpu_torch.audio.vad import SileroJITVAD
    from whisperlivekit_tpu_torch.audio.vad_batched import BatchedVADScheduler
    from whisperlivekit_tpu_torch.engine.core import TranscriptionEngine, WLKConfig
    from whisperlivekit_tpu_torch.server.app import WLKServer
    from whisperlivekit_tpu_torch.session.processor import AudioProcessor

    config = WLKConfig(model_size="random:base", lan="en", pcm_input=True, vac=True, vad_backend=backend,
                       param_dtype="bfloat16", log_level="WARNING")
    t0 = time.perf_counter()
    engine = TranscriptionEngine(config)
    sched = engine.vad_scheduler
    if backend == "jax-batched":
        on_card = [t.device.type for t in sched.pool] + [sched.params.stft_basis.device.type] if sched else []
        if not (isinstance(sched, BatchedVADScheduler) and set(on_card) == {"cuda"}):
            raise AssertionError(f"vad_backend=jax-batched built {type(sched).__name__} on {on_card}")
    elif not isinstance(engine.vac_model, SileroJITVAD):
        raise AssertionError(f"vad_backend=auto built {type(engine.vac_model).__name__}, not the stand-in's torch.jit")
    runner = web.AppRunner(WLKServer(config, engine=engine).app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    host, port = runner.addresses[0][:2]
    setup_s = time.perf_counter() - t0
    try:
        with VADInstrumented() as ins:
            _reset_kernel_counts()  # the vad path's run counts from here
            engine.scheduler.reset_stats()
            if sched is not None:
                sched.reset_stats()
            t1 = time.perf_counter()
            pcms = [speech_with_pause(VAD_SECONDS, seed=400 + s) for s in range(VAD_SESSIONS + 1)]
            procs = [AudioProcessor(transcription_engine=engine) for _ in range(VAD_SESSIONS)]
            lines = await asyncio.gather(*(_feed_processor(p, pcm) for p, pcm in zip(procs, pcms)),
                                         _feed_websocket(f"http://{host}:{port}/asr", pcms[VAD_SESSIONS]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            counts = _kernel_counts()
        stats = engine.scheduler.stats()
        vad_stats = sched.stats() if sched is not None else None
        solo = _vad_solo(sched, vad_stats["lanes_per_step_max"]) if sched is not None else None
        pool_bytes = sum(t.numel() * t.element_size() for t in sched.pool) if sched is not None else 0
    finally:
        await runner.cleanup()
        TranscriptionEngine.reset()
    return dict(lines=lines, wall=wall, setup_s=setup_s, counts=counts, stats=stats, vad_stats=vad_stats,
                solo=solo, pool_bytes=pool_bytes, ins=ins, capacity=sched.capacity if sched is not None else None)


def _vad_gates(run: dict) -> list:
    """Per session (in process and behind WS /asr), its gate transitions
    [(close | open, stream seconds)] in order."""
    by_gate = {}
    for gid, kind, at in run["ins"].gate:
        by_gate.setdefault(gid, []).append((kind, round(at, 3)))
    return [by_gate.get(id(p.silence_gate), []) for p in run["ins"].procs]


def _check_vad_run(name: str, run: dict) -> None:
    """Words on every session; every gate opened in the first voiced span,
    closed inside the pause and opened again after it."""
    half = (VAD_SECONDS - 2.0) / 2  # speech_with_pause: 0.5 s quiet, half voiced, 1.5 s quiet, half voiced
    words = [sum(len(t.split()) for t, _ in lines) for lines in run["lines"]]
    gates = _vad_gates(run)
    bad = [g for g in gates
           if not (len(g) >= 3 and g[0][0] == "open" and g[0][1] < 0.5 + half
                   and g[1][0] == "close" and 0.5 + half <= g[1][1] < 2.0 + half
                   and g[2][0] == "open" and g[1][1] < g[2][1] < 2.5 + half)]
    if run["stats"]["n_failed_ticks"] or "pool_recovery" in run["stats"].get("tick_phases", {}):
        raise AssertionError(f"{name}: a tick failed or a group recovered: {run['stats']}")
    if len(words) != VAD_SESSIONS + 1 or not all(words):
        raise AssertionError(f"{name}: a session got no words: {words}")
    if len(gates) != VAD_SESSIONS + 1 or bad:
        raise AssertionError(f"{name}: a gate did not open in speech and close at its pause: {bad[:3]}")


def phase_vad(main_run: dict) -> dict:
    """The batched Silero VAD on the card: the stand-in written under
    VAD_STANDIN_DIR from fixed seeds, the f32 reference (card against CPU),
    then the serving run with ``vad_backend="jax-batched"`` and the same
    sessions on the host path (``vad_backend="auto"``) beside it."""
    import gc
    import os

    from whisperlivekit_tpu_torch.harness import vad_checkpoint as VC
    from whisperlivekit_tpu_torch.harness.vocab import install_standin_vocab

    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    path = VC.write_silero_standin(VAD_STANDIN_DIR, VAD_SEED, calibrate=VC.calibration_audio(VAD_SEED + 1))
    log("vad", standin=str(path), seed=VAD_SEED, calibration_seed=VAD_SEED + 1,
        write_s=round(time.perf_counter() - t, 2))
    phase_reference_vad(str(path))
    was = os.environ.get("WLK_TPU_ASSET_DIR")
    install_standin_vocab(path.parent)
    try:
        run = asyncio.run(_main_path_vad("jax-batched"))
        host = asyncio.run(_main_path_vad("auto"))
    finally:
        if was is None:
            os.environ.pop("WLK_TPU_ASSET_DIR", None)
        else:
            os.environ["WLK_TPU_ASSET_DIR"] = was
    stats, vs, solo, counts = run["stats"], run["vad_stats"], run["solo"], run["counts"]
    words = [sum(len(t.split()) for t, _ in lines) for lines in run["lines"]]
    log("vad", model="random:base bf16", vac=True, vad_backend="jax-batched", sessions=len(words),
        audio_s_each=VAD_SECONDS, pace=PACE, words_per_session=words, wall_s=round(run["wall"], 3),
        setup_s=round(run["setup_s"], 3), ticks=stats["n_ticks"], failed_ticks=stats["n_failed_ticks"],
        gates_first_session=_vad_gates(run)[0])
    log("vad", vad_steps=vs["n_steps"], frames_scored=vs["n_frames_scored"],
        lanes_per_step_mean=vs["lanes_per_step_mean"], lanes_per_step_max=vs["lanes_per_step_max"],
        substep_ms_p50=vs["step_ms_p50"], substep_ms_p95=vs["step_ms_p95"],
        segment_vad_await_ms_p50=_quantile(run["ins"].vad_ms, 0.5),
        segment_vad_await_ms_p95=_quantile(run["ins"].vad_ms, 0.95), vad_calls=len(run["ins"].vad_ms),
        pool_lanes=run["capacity"], pool_bytes=run["pool_bytes"])
    log("vad", solo_substep_ms_by_lanes=solo["step_ms_by_lanes"], traced_at_lanes=vs["lanes_per_step_max"],
        kernels_per_step=solo["kernels_per_step"], copies_per_step=solo["copies_per_step"],
        device_us_per_step=round(solo["device_us_per_step"], 2))
    log("vad", word_emission_p50_ms=stats["word_emission_p50_ms"],
        word_emission_p95_ms=stats.get("word_emission_p95_ms"), tick_ms_p50=stats["tick_ms_p50"],
        main_word_emission_p50_ms=main_run["stats"]["word_emission_p50_ms"],
        main_word_emission_p95_ms=main_run["stats"].get("word_emission_p95_ms"),
        main_tick_ms_p50=main_run["stats"]["tick_ms_p50"])
    log("vad", host_path="vad_backend=auto (torch.jit on the CPU, worker thread)",
        words_per_session=[sum(len(t.split()) for t, _ in lines) for lines in host["lines"]],
        host_vad_ms_per_chunk_p50=_quantile(host["ins"].vad_ms, 0.5),
        host_vad_ms_per_chunk_p95=_quantile(host["ins"].vad_ms, 0.95), vad_calls=len(host["ins"].vad_ms),
        word_emission_p50_ms=host["stats"]["word_emission_p50_ms"],
        word_emission_p95_ms=host["stats"].get("word_emission_p95_ms"), tick_ms_p50=host["stats"]["tick_ms_p50"],
        ticks=host["stats"]["n_ticks"], wall_s=round(host["wall"], 3))
    log("vad", kernel="flash_encoder_attn", launches=counts["flash_encoder_attn"],
        launches_by_SxT={f"{s}x{t}": n for (s, t), n in sorted(counts["k1_shapes"].items())},
        host_path_launches=host["counts"]["flash_encoder_attn"])
    _check_k1_bodies("vad", counts)
    _check_vad_run("vad", run)
    _check_vad_run("vad host path", host)
    if not vs["lanes_per_step_max"] > 1:
        raise AssertionError(f"the VAD scheduler never stepped more than one lane: {vs}")
    if not counts["flash_encoder_attn"]:
        raise AssertionError("K1 never launched in the vad phase")
    return run


# ---------------------------------------------------------------------------
# causal: Qwen3-ASR causal (block-causal tower, Qwen3 decoder, pooled lanes)
# ---------------------------------------------------------------------------

CAUSAL_SESSIONS = 4      # AudioProcessor sessions in process, plus one over WS /asr
CAUSAL_SECONDS = 8.0
CAUSAL_REF_LAYERS = 4    # tower and text depth of the f32 card-vs-CPU reference (full widths)
CAUSAL_REF_STEPS = 16    # hypothesis steps in the reference
# f32 logits after 4+4 layers at full width, card against CPU: the sound
# runs land near 3e-6; the same run with TF32 on must land above it
CAUSAL_REF_TOL = 1e-4
CAUSAL_SOLO_LANES = 4    # lanes of the traced decode after the run


@contextlib.contextmanager
def _tf32_flags(matmul: bool, cudnn: bool):
    """cuBLAS's and cuDNN's TF32 flags set inside the block, the smoke's
    (both off) restored after it."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def _tf32():
    """TF32 on for cuBLAS and cuDNN inside the block (the smoke runs with it
    off): what a reference's tolerance must be able to catch."""
    return _tf32_flags(True, True)


def _top8(logits: torch.Tensor) -> list:
    """The eight highest ids of a logits vector, best first (random weights
    repeat one token, so the ranking carries the comparison too)."""
    return torch.topk(logits.reshape(-1).float(), 8).indices.tolist()


def _causal_words(proc_cls, holder, seeds, service=None) -> list:
    """Sessions of 4 s (1 s chunks) through the causal policy: each one's
    committed (text, start, end). With ``service``, concurrently through
    its pooled lanes; else one after another on local caches."""
    def chunks(seed):
        pcm = speech_pcm(4.0, seed=seed).astype(np.float32) / 32768.0
        return [pcm[i * 16000:(i + 1) * 16000] for i in range(4)]

    def keep(out, tokens):
        out.extend((t.text, t.start, t.end) for t in tokens)

    if service is None:
        result = []
        for seed in seeds:
            proc, out = proc_cls(holder), []
            for i, c in enumerate(chunks(seed)):
                proc.insert_audio_chunk(c, float(i + 1))
                keep(out, proc.process_iter()[0])
            keep(out, proc.finish()[0])
            result.append(out)
        return result

    async def one(seed):
        proc, out = proc_cls(holder, service=service), []
        for i, c in enumerate(chunks(seed)):
            proc.insert_audio_chunk(c, float(i + 1))
            keep(out, (await proc.process_iter_async())[0])
        keep(out, (await proc.finish_async())[0])
        proc.close()
        return out

    async def main():
        return list(await asyncio.gather(*(one(s) for s in seeds)))
    return asyncio.run(main())


def phase_reference_causal() -> None:
    """Qwen3-ASR at the 0.6B model's full widths with the depth cut to 4+4
    layers, f32, the weights from one seed: two blocks appended and one
    hypothesis decoded on the card and on the CPU from the same mel (tokens
    and lengths equal, the logits after each block within CAUSAL_REF_TOL);
    then on the card two sessions through the pooled lanes against the same
    two on local caches (the committed words and times equal). Each
    block's top-8 ids must be equal too, and the card's run repeated with
    TF32 on must land outside CAUSAL_REF_TOL, or the check could not see
    TF32 creep into the f32 path."""
    import copy
    import dataclasses

    from whisperlivekit_tpu_torch.models import llama as LM
    from whisperlivekit_tpu_torch.models import qwen3_asr as QM
    from whisperlivekit_tpu_torch.streaming import qwen3_batch as QB
    from whisperlivekit_tpu_torch.streaming import qwen3_causal as QC

    text = dataclasses.replace(QM.QWEN3_0_6B_TEXT, n_layers=CAUSAL_REF_LAYERS)
    dims = QM.Qwen3ASRDims(text=text, audio_layers=CAUSAL_REF_LAYERS)
    card_model = QM.init_params(dims, torch.Generator(device=CARD).manual_seed(21), torch.float32, CARD)
    models = {"card": card_model, "cpu": copy.deepcopy(card_model).to("cpu")}
    audio = speech_pcm(4.0, seed=70).astype(np.float32) / 32768.0
    bs = dims.block_samples
    mels = [log_mel_spectrogram(torch.from_numpy(audio[i * bs:(i + 1) * bs]), n_mels=dims.n_mels)[None]
            for i in range(2)]

    def run(model):
        dev = model.device
        t = time.perf_counter()
        tc = QM.init_tower_cache(dims, 1, device=dev)
        xc = LM.init_cache(dims.text, 1, 96, device=dev)
        with torch.no_grad():
            LM.forward(model.text, LM.embed_tokens(model.text, torch.tensor([[1, 2, 3]], device=dev)),
                       torch.zeros(1, dtype=torch.long, device=dev), xc, dims.text, last_only=True)
        pos, logits = 3, []
        for b in range(2):
            _, _, lg = QM.append_audio_block(model, mels[b].to(dev), tc, xc, torch.tensor([b * dims.block_frames], device=dev),
                                             torch.tensor([pos], device=dev), dims)
            logits.append(lg.cpu())
            pos += dims.block_tokens
        toks, n, _ = QM.decode_hypothesis(model, xc, torch.tensor([[4]], device=dev), torch.tensor([pos], device=dev),
                                          0, dims, max_new=CAUSAL_REF_STEPS)
        return logits, toks.cpu().tolist(), n.cpu().tolist(), time.perf_counter() - t

    res = {side: run(model) for side, model in models.items()}
    with _tf32():
        tf32 = run(card_model)

    def gap(a):
        return max((x - y).abs().max().item() for x, y in zip(a[0], res["cpu"][0]))
    err, tf32_err = gap(res["card"]), gap(tf32)
    top8 = [[_top8(lg) for lg in res[side][0]] for side in ("card", "cpu")]
    holder = QC.Qwen3CausalASR(card_model, dims, max_new=CAUSAL_REF_STEPS)
    local = _causal_words(QC.Qwen3CausalProcessor, holder, seeds=(71, 72))
    service = QB.CausalBatchService(holder, capacity=2, window_s=0.05)
    pooled = _causal_words(QC.Qwen3CausalProcessor, holder, seeds=(71, 72), service=service)
    ok = (res["card"][1] == res["cpu"][1] and res["card"][2] == res["cpu"][2] and top8[0] == top8[1]
          and err <= CAUSAL_REF_TOL < tf32_err and pooled == local and all(local)
          and service.stats()["append"]["avg_ops_per_batch"] > 1)
    log("reference", model=f"qwen3-asr 0.6B widths f32 random, {CAUSAL_REF_LAYERS}+{CAUSAL_REF_LAYERS} layers",
        calls=f"2 blocks appended, a {CAUSAL_REF_STEPS}-step hypothesis", tokens=res["card"][1][0][:8],
        n=res["card"][2], logits_max_abs_err=err, tol=CAUSAL_REF_TOL, tf32_logits_max_abs_err=tf32_err,
        top8_equal_after_each_block=top8[0] == top8[1], card_s=round(res["card"][3], 2), cpu_s=round(res["cpu"][3], 2),
        pooled_equals_local=pooled == local, words_per_session=[len(w) for w in local],
        pooled_batches=service.stats(), ok=ok)
    if not ok:
        raise AssertionError(f"the causal reference disagrees: tokens {res['card'][1]} / {res['cpu'][1]}, "
                             f"n {res['card'][2]} / {res['cpu'][2]}, top-8 {top8}, logits err {err} "
                             f"(TF32 {tf32_err}, tol {CAUSAL_REF_TOL}), pooled == local "
                             f"{pooled == local} ({pooled[0][:3]} / {local[0][:3]})")
    del models, card_model, holder, service
    torch.cuda.empty_cache()


class CausalInstrumented:
    """Wraps, for a causal run on ``service``: each op batch's runner (its
    ops, and its wall to a synchronize, so the device's work is in it),
    each ``decode_hypothesis`` (its steps: the text tower's one-token
    forwards), and each session tick that ran ops (its call to its result,
    the counterpart of the AlignAtt scheduler's word emission: a tick's
    enqueue to its result). Restores everything on exit."""

    def __init__(self, service):
        from whisperlivekit_tpu_torch.models import llama as LM
        from whisperlivekit_tpu_torch.models import qwen3_asr as QM
        from whisperlivekit_tpu_torch.streaming import qwen3_causal as QC

        self.LM, self.QM, self.QC, self.service = LM, QM, QC, service
        self.batches = {op: [] for op in service.batcher._runners}  # op -> [(ops, ms)]
        self.ticks, self.steps = [], []
        self._fwd = 0

    def __enter__(self):
        LM, QM, QC, runners = self.LM, self.QM, self.QC, self.service.batcher._runners
        self.real = dict(runners=dict(runners), tick=QC.Qwen3CausalProcessor._tick,
                         decode=QM.decode_hypothesis, forward=LM.forward)
        real = self.real

        def timed(op, run):
            def wrapped(items):
                t = time.perf_counter()
                out = run(items)
                torch.cuda.synchronize()
                self.batches[op].append((len(items), (time.perf_counter() - t) * 1e3))
                return out
            return wrapped

        async def tick(proc, is_last):
            n0, t = proc.n_blocks_encoded, time.perf_counter()
            out = await real["tick"](proc, is_last)
            if proc.n_blocks_encoded > n0:
                self.ticks.append((time.perf_counter() - t) * 1e3)
            return out

        def forward(*a, **k):
            self._fwd += 1
            return real["forward"](*a, **k)

        def decode(*a, **k):  # op batches run one at a time (the batcher's lock)
            self._fwd = 0
            out = real["decode"](*a, **k)
            self.steps.append(self._fwd - 1)  # the forced prefix's forward is no step
            return out

        for op, run in real["runners"].items():
            runners[op] = timed(op, run)
        QC.Qwen3CausalProcessor._tick, QM.decode_hypothesis, LM.forward = tick, decode, forward
        return self

    def __exit__(self, *exc):
        self.service.batcher._runners.update(self.real["runners"])
        self.QC.Qwen3CausalProcessor._tick = self.real["tick"]
        self.QM.decode_hypothesis, self.LM.forward = self.real["decode"], self.real["forward"]


def _module_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


async def _main_path_causal(name: str, config, sessions: int, seconds: float, seed: int,
                            ws: bool, rest_wav: bytes = None, setup=None) -> dict:
    """One engine from ``config`` served through the port's app on
    localhost: ``sessions`` AudioProcessor sessions (and one ``WS /asr``
    stream when ``ws``, one ``POST /v1/audio/transcriptions`` when
    ``rest_wav``) of ``seconds`` each, fed in real time. The kernels'
    counts are set to 0 just before the sessions start and read just after
    they end. ``setup(engine)`` runs after the engine is built."""
    import aiohttp
    from aiohttp import web

    from whisperlivekit_tpu_torch.engine.core import TranscriptionEngine
    from whisperlivekit_tpu_torch.server.app import create_app
    from whisperlivekit_tpu_torch.session.processor import AudioProcessor

    t0 = time.perf_counter()
    TranscriptionEngine.reset()
    torch.cuda.synchronize()
    before_engine = torch.cuda.memory_allocated()  # what earlier phases left
    engine = TranscriptionEngine(config)
    if engine.device.type != "cuda":
        raise AssertionError(f"{name}: engine landed on {engine.device}, not the card")
    load_s = time.perf_counter() - t0
    if setup is not None:
        setup(engine)
    runner = web.AppRunner(create_app(config, engine=engine))
    await runner.setup()  # startup runs the engine's warmup
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    host, port = runner.addresses[0][:2]
    setup_s = time.perf_counter() - t0
    service = engine.scheduler
    ins = CausalInstrumented(service) if service is not None else contextlib.nullcontext()
    try:
        with ins:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _reset_kernel_counts()  # this path's run counts from here
            t1 = time.perf_counter()
            pcms = [speech_pcm(seconds, seed=seed + s) for s in range(sessions + 1)]
            procs = [AudioProcessor(transcription_engine=engine) for _ in range(sessions)]
            async with aiohttp.ClientSession() as http:
                jobs = [_feed_processor(p, pcm) for p, pcm in zip(procs, pcms)]
                if ws:
                    jobs.append(_feed_websocket(f"http://{host}:{port}/asr", pcms[-1]))
                if rest_wav is not None:
                    jobs.append(_post_transcription(http, f"http://{host}:{port}/v1/audio/transcriptions",
                                                    rest_wav, "json"))
                out = await asyncio.gather(*jobs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            counts = _kernel_counts()
            peak = torch.cuda.max_memory_allocated()
    finally:
        await runner.cleanup()
        TranscriptionEngine.reset()
    n_lines = sessions + int(ws)
    return dict(engine=engine, texts=out[:n_lines], rest=out[n_lines] if rest_wav is not None else None,
                wall=wall, load_s=load_s, setup_s=setup_s, counts=counts, before_engine_bytes=before_engine,
                base_bytes=base, peak_bytes=peak,
                stats=service.stats() if service is not None else None,
                ins=ins if service is not None else None)


def _causal_solo(engine, lanes: int) -> dict:
    """After a causal run, on its pools: one pooled decode of ``lanes`` lanes
    alone (rows the run left), its ms and steps untraced, then traced by
    torch.profiler (device activity only) for its launches a step."""
    from torch.profiler import ProfilerActivity, profile

    from whisperlivekit_tpu_torch.streaming.qwen3_batch import LaneToken

    service = engine.scheduler
    items = [(LaneToken(1 + i), engine.asr.text_cache_len // 2) for i in range(lanes)]
    with CausalInstrumented(service) as ins:
        service._run_decode(items)  # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        service._run_decode(items)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        steps = ins.steps[-1]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            service._run_decode(items)
            torch.cuda.synchronize()
    ev = prof.key_averages()
    launches = sum(e.count for e in ev if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    return dict(lanes=lanes, ms=ms, steps=steps, ms_per_step=ms / max(steps, 1), launches=launches,
                launches_per_step=launches / max(steps + 1, 1))


def _over_weights(run: dict, weights: int) -> int:
    """A served run's peak card memory over its weights: the peak less the
    weights and what was allocated before its engine was built."""
    return run["peak_bytes"] - run["before_engine_bytes"] - weights


def _log_causal_run(phase: str, run: dict, model: str, solo: dict) -> list:
    """Prints a causal run's figures; returns its words per session."""
    engine, ins, stats = run["engine"], run["ins"], run["stats"]
    pools = engine.scheduler.pools
    words = [sum(len(t.split()) for t, _ in lines) for lines in run["texts"]]
    weights = _module_bytes(engine.asr.params)
    pool_bytes = sum(p.numel() * p.element_size() for p in (pools.tower_k, pools.tower_v, pools.text_k, pools.text_v))
    by_op = {op: dict(batches=len(b), ops_by_batch=dict(Counter(n for n, _ in b)),
                      ms_p50=_quantile([ms for _, ms in b], 0.5), ms_p95=_quantile([ms for _, ms in b], 0.95))
             for op, b in ins.batches.items()}
    log(phase, model=model, sessions=len(words), audio_s_each=CAUSAL_SECONDS, pace=PACE, words_per_session=words,
        wall_s=round(run["wall"], 3), load_s=round(run["load_s"], 2), setup_s=round(run["setup_s"], 2))
    for op, rec in by_op.items():
        log(phase, op=op, **rec, avg_ops_per_batch=stats[op]["avg_ops_per_batch"])
    log(phase, decode_steps=dict(Counter(ins.steps)), solo=f"decode of {solo['lanes']} lanes",
        solo_ms=round(solo["ms"], 1), solo_steps=solo["steps"], ms_per_step=round(solo["ms_per_step"], 3),
        launches_per_step=round(solo["launches_per_step"], 1))
    # the run starts with the weights, the pools and what earlier phases left
    # allocated; the peak over the weights is the run's peak less the weights
    # and what was allocated before the engine was built (the pools are in it)
    log(phase, weights_GB=round(weights / 2**30, 3), pool_lanes=pools.tower_k.shape[1] - 1,
        pool_bytes_per_lane_MiB=round(pools.lane_bytes() / 2**20, 2), pools_GB=round(pool_bytes / 2**30, 3),
        allocated_at_start_GB=round(run["base_bytes"] / 2**30, 3), peak_GB=round(run["peak_bytes"] / 2**30, 3),
        peak_over_weights_GB=round(_over_weights(run, weights) / 2**30, 3),
        peak_over_start_GB=round((run["peak_bytes"] - run["base_bytes"]) / 2**30, 3))
    log(phase, ticks_with_ops=len(ins.ticks), word_emission_p50_ms=_quantile(ins.ticks, 0.5),
        word_emission_p95_ms=_quantile(ins.ticks, 0.95), kernel_launches=dict(
            flash_encoder_attn=run["counts"]["flash_encoder_attn"], xkv_splice=run["counts"]["xkv_splice"],
            log_mel_pallas=run["counts"]["log_mel_pallas"]))
    if not all(words):
        raise AssertionError(f"{phase}: a session got no words: {words}")
    if max(n for n, _ in ins.batches["append"]) < 2:
        raise AssertionError(f"{phase}: no append batch packed two sessions: {by_op['append']}")
    return words


def phase_causal() -> dict:
    """Qwen3-ASR causal on the card: the f32 reference, then the 0.6B model
    at full width and depth in bf16 from a checkpoint directory written from
    a seed (deleted at the end), served with the pooled lanes."""
    import gc
    import tempfile

    from whisperlivekit_tpu_torch.engine.core import WLKConfig
    from whisperlivekit_tpu_torch.harness import llm_checkpoints as CK
    from whisperlivekit_tpu_torch.models import qwen3_asr as QM

    gc.collect()
    torch.cuda.empty_cache()
    phase_reference_causal()
    dims = QM.Qwen3ASRDims(text=QM.QWEN3_0_6B_TEXT)
    with tempfile.TemporaryDirectory(prefix="wlk_qwen3_") as tmp:
        t = time.perf_counter()
        nbytes = CK.write_checkpoint(tmp, "qwen3", dims, seed=22, dtype=torch.bfloat16, device=CARD)
        write_s = time.perf_counter() - t
        config = WLKConfig(backend="qwen3", backend_policy="causal", model_path=tmp, lan="en", pcm_input=True,
                           vac=False, scheduler=True, param_dtype="bfloat16", log_level="WARNING")
        run = asyncio.run(_main_path_causal("causal", config, CAUSAL_SESSIONS, CAUSAL_SECONDS, 80, ws=True))
    engine = run["engine"]
    got = engine.asr.dims
    if (got.text != QM.QWEN3_0_6B_TEXT or got.audio_layers != 24 or got.d_audio != 1024
            or engine.asr.params.dtype != torch.bfloat16):
        raise AssertionError(f"the causal engine is not the 0.6B model in bf16: {got}")
    solo = _causal_solo(engine, CAUSAL_SOLO_LANES)
    log("causal", checkpoint_GB=round(nbytes / 2**30, 3), write_s=round(write_s, 2),
        params_M=round(sum(p.numel() for p in engine.asr.params.parameters()) / 1e6, 1))
    run["words"] = _log_causal_run("causal", run, "qwen3-asr 0.6B full width and depth, bf16 (seeded checkpoint)",
                                   solo)
    del run["engine"], run["ins"], engine  # the wrapped service holds the weights and pools
    return run


# ---------------------------------------------------------------------------
# voxtral: Voxtral realtime (the causal machinery) and Voxtral offline
# (the windowed policy over the whisper encoder, so K1)
# ---------------------------------------------------------------------------

VOX_SESSIONS = 2         # AudioProcessor sessions in process (offline: plus one REST post)
VOX_SECONDS = 8.0
VOX_LAYERS = 4           # audio and text depth of the served checkpoint (published widths)
VOX_REF_LAYERS = 2       # depth of the f32 card-vs-CPU reference
VOX_REF_STEPS = 16
# f32 last-position logits after 2+2 layers at published widths: the sound
# runs land near 6e-6; the same run with TF32 on must land above it
VOX_REF_TOL = 1e-4
# Voxtral offline's new tokens a call in the sessions and the REST post:
# random weights never emit end-of-text, so every call would run the
# default 128 steps; real speech ends a 2-12 s window in a few dozen
VOX_PINNED_NEW = 32
VOX_AB_THREADS = 2       # transcribe calls at once in the lock A/B


def _voxtral_dims(layers: int):
    import dataclasses

    from whisperlivekit_tpu_torch.models import voxtral as VM

    d = VM.VOXTRAL_MINI_3B
    return dataclasses.replace(d, audio=dataclasses.replace(d.audio, n_audio_layer=layers),
                               text=dataclasses.replace(d.text, n_layers=layers))


def phase_reference_voxtral() -> None:
    """Voxtral offline at Voxtral-Mini-3B's widths with 2+2 layers, f32, the
    weights from one seed, on the card (K1's f32 body in the encoder) and
    on the CPU from the same mel: the last prompt position's logits within
    VOX_REF_TOL, their top-8 ids and VOX_REF_STEPS greedy tokens equal; the
    card's run repeated with TF32 on must land outside VOX_REF_TOL."""
    import copy

    from whisperlivekit_tpu_torch.audio.mel import N_SAMPLES, pad_or_trim
    from whisperlivekit_tpu_torch.models import llama as LM
    from whisperlivekit_tpu_torch.models import voxtral as VM

    dims = _voxtral_dims(VOX_REF_LAYERS)
    card_model = VM.init_params(dims, torch.Generator(device=CARD).manual_seed(31), torch.float32, CARD)
    models = {"card": card_model, "cpu": copy.deepcopy(card_model).to("cpu")}
    audio = speech_pcm(8.0, seed=90).astype(np.float32) / 32768.0
    mel = pad_or_trim(log_mel_spectrogram(torch.from_numpy(audio), n_mels=128, padding=N_SAMPLES - len(audio)),
                      3000)[None]
    prompt = torch.tensor([[1] + [dims.audio_token_id] * dims.audio_tokens_per_window])

    def run(model):
        dev = model.device
        t = time.perf_counter()
        with torch.no_grad():
            lg, _ = VM.forward(model, prompt.to(dev), mel.to(dev), torch.zeros(1, dtype=torch.long, device=dev),
                               LM.init_cache(dims.text, 1, prompt.shape[1], device=dev), dims, last_only=True)
        toks = VM.greedy_generate(model, prompt.to(dev), mel.to(dev), 2, dims, VOX_REF_STEPS)
        return lg.cpu(), toks.cpu().tolist(), time.perf_counter() - t

    res = {side: run(model) for side, model in models.items()}
    with _tf32():
        tf32 = run(card_model)
    err, tf32_err = ((r[0] - res["cpu"][0]).abs().max().item() for r in (res["card"], tf32))
    top8 = [_top8(res[side][0]) for side in ("card", "cpu")]
    ok = res["card"][1] == res["cpu"][1] and top8[0] == top8[1] and err <= VOX_REF_TOL < tf32_err
    log("reference", model=f"voxtral-mini-3b widths f32 random, {VOX_REF_LAYERS}+{VOX_REF_LAYERS} layers",
        calls=f"prefill of {prompt.shape[1]} tokens, {VOX_REF_STEPS} greedy steps", tokens=res["card"][1][0][:8],
        logits_max_abs_err=err, tol=VOX_REF_TOL, tf32_logits_max_abs_err=tf32_err, top8_equal=top8[0] == top8[1],
        card_s=round(res["card"][2], 2), cpu_s=round(res["cpu"][2], 2), ok=ok)
    if not ok:
        raise AssertionError(f"the voxtral reference disagrees: {res['card'][1]} / {res['cpu'][1]}, top-8 {top8}, "
                             f"err {err} (TF32 {tf32_err}, tol {VOX_REF_TOL})")
    del models, card_model
    torch.cuda.empty_cache()


def _voxtral_solo(engine) -> dict:
    """After the offline run, on its backend: one transcribe of 8 s at the
    default 128 new tokens alone; one at VOX_PINNED_NEW traced (device
    activity only) for its launches a step; then the lock A/B:
    VOX_AB_THREADS threads each transcribing once at VOX_PINNED_NEW, without
    and with the backend's lock, in turns (unlocked, locked, locked,
    unlocked)."""
    import contextlib
    import threading

    from torch.profiler import ProfilerActivity, profile

    asr = engine.asr.asr
    audio = speech_pcm(8.0, seed=95).astype(np.float32) / 32768.0
    asr.max_new_tokens = 128
    t = time.perf_counter()
    full = asr.transcribe(audio)
    torch.cuda.synchronize()
    full_ms = (time.perf_counter() - t) * 1e3
    asr.max_new_tokens = VOX_PINNED_NEW
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        asr.transcribe(audio)
        torch.cuda.synchronize()
    ev = prof.key_averages()
    launches = sum(e.count for e in ev if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    lock = asr._session_lock

    def arm(locked: bool) -> float:
        asr._session_lock = lock if locked else contextlib.nullcontext()
        threads = [threading.Thread(target=asr.transcribe, args=(audio,)) for _ in range(VOX_AB_THREADS)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        torch.cuda.synchronize()
        if any(th.is_alive() for th in threads):
            raise AssertionError("a lock A/B transcribe did not finish in 120 s")
        return time.perf_counter() - t

    try:
        ab = [(name, round(arm(name == "locked"), 3)) for name in ("unlocked", "locked", "locked", "unlocked")]
    finally:
        asr._session_lock = lock
    return dict(full_ms=full_ms, full_steps=len(full["token_ids"]), launches=launches, lock_ab_s=ab)


def phase_voxtral() -> dict:
    """Voxtral on the card: the offline f32 reference; then one checkpoint
    directory at Voxtral-Mini-3B's published widths with 4+4 layers, bf16,
    written from a seed (its config.json names both the realtime and the
    offline keys), served by Voxtral realtime (the causal machinery, pooled
    lanes) and by Voxtral offline (the windowed policy, K1 in the
    encoder)."""
    import gc
    import tempfile

    from whisperlivekit_tpu_torch.engine.core import WLKConfig
    from whisperlivekit_tpu_torch.harness import llm_checkpoints as CK
    from whisperlivekit_tpu_torch.streaming import qwen3_causal as QC

    gc.collect()
    torch.cuda.empty_cache()
    phase_reference_voxtral()
    dims = _voxtral_dims(VOX_LAYERS)
    kw = dict(backend="voxtral", lan="en", pcm_input=True, vac=False, param_dtype="bfloat16", log_level="WARNING")

    def offline_setup(engine):
        asr = engine.asr.asr
        # the seeded directories hold no tokenizer: ids decode to "tN"
        asr.text_tokenizer, asr.max_new_tokens = QC.DebugWordTokenizer(), VOX_PINNED_NEW
        if asr.dims.text.n_layers != VOX_LAYERS or asr.dims.audio.n_audio_state != 1280:
            raise AssertionError(f"the offline engine's dims: {asr.dims}")

    with tempfile.TemporaryDirectory(prefix="wlk_voxtral_") as tmp:
        t = time.perf_counter()
        nbytes = CK.write_checkpoint(tmp, "voxtral", dims, seed=32, dtype=torch.bfloat16, device=CARD)
        write_s = time.perf_counter() - t
        rt_config = WLKConfig(backend_policy="causal", model_path=tmp, scheduler=True, **kw)
        rt = asyncio.run(_main_path_causal("voxtral_rt", rt_config, VOX_SESSIONS, VOX_SECONDS, 100, ws=False))
        rt_engine = rt.pop("engine")
        got = rt_engine.asr.dims
        if (got.d_audio, got.audio_heads, got.audio_ff, got.text, type(rt_engine.asr).__name__) != (
                1280, 20, 5120, dims.text, "VoxtralRealtimeASR") or rt_engine.asr.params.tower.proj2 is None:
            raise AssertionError(f"the realtime engine is not Voxtral at published widths: {got}")
        rt_solo = _causal_solo(rt_engine, VOX_SESSIONS)
        rt["engine"] = rt_engine
        log("voxtral_rt", checkpoint_GB=round(nbytes / 2**30, 3), write_s=round(write_s, 2),
            params_M=round(sum(p.numel() for p in rt_engine.asr.params.parameters()) / 1e6, 1))
        rt["words"] = _log_causal_run("voxtral_rt", rt, f"voxtral realtime, published widths, {VOX_LAYERS}+"
                                      f"{VOX_LAYERS} layers, bf16 (seeded checkpoint)", rt_solo)
        del rt["engine"], rt["ins"], rt_engine  # the wrapped service holds the weights and pools
        gc.collect()
        torch.cuda.empty_cache()

        off_config = WLKConfig(backend_policy="windowed", model_path=tmp, **kw)
        off = asyncio.run(_main_path_causal("voxtral", off_config, VOX_SESSIONS, VOX_SECONDS, 110, ws=False,
                                            rest_wav=_wav_bytes(speech_pcm(VOX_SECONDS, seed=119)),
                                            setup=offline_setup))
    off_engine = off["engine"]
    solo = _voxtral_solo(off_engine)
    counts = off["counts"]
    words = [sum(len(t.split()) for t, _ in lines) for lines in off["texts"]]
    status, body, rest_s = off["rest"]
    rest_text = json.loads(body).get("text", "") if status == 200 else ""
    weights = _module_bytes(off_engine.asr.asr.params)
    log("voxtral", model=f"voxtral offline, published widths, {VOX_LAYERS}+{VOX_LAYERS} layers, bf16, "
        f"windowed policy, {VOX_PINNED_NEW} new tokens a call", sessions=len(words), audio_s_each=VOX_SECONDS,
        words_per_session=words, wall_s=round(off["wall"], 3), load_s=round(off["load_s"], 2),
        weights_GB=round(weights / 2**30, 3), allocated_at_start_GB=round(off["base_bytes"] / 2**30, 3),
        peak_over_weights_GB=round(_over_weights(off, weights) / 2**30, 3),
        peak_over_start_GB=round((off["peak_bytes"] - off["base_bytes"]) / 2**30, 3))
    log("voxtral", endpoint="'rest json'", status=status, wall_s=round(rest_s, 3), words=len(rest_text.split()))
    log("voxtral", solo="transcribe 8 s, 128 new tokens", ms=round(solo["full_ms"], 1), steps=solo["full_steps"],
        ms_per_step=round(solo["full_ms"] / max(solo["full_steps"], 1), 3),
        launches_per_step_at_32=round(solo["launches"] / VOX_PINNED_NEW, 1))
    log("voxtral", lock_ab=f"{VOX_AB_THREADS} threads x 1 transcribe of {VOX_PINNED_NEW} tokens",
        arms_s=solo["lock_ab_s"])
    log("voxtral", kernel="flash_encoder_attn", launches=counts["flash_encoder_attn"],
        launches_by_SxT={f"{s}x{t}": n for (s, t), n in sorted(counts["k1_shapes"].items())})
    _check_k1_bodies("voxtral", counts)
    if not all(words) or status != 200 or not rest_text:
        raise AssertionError(f"voxtral offline: words {words}, REST {status} {rest_text[:40]!r}")
    if not counts["flash_encoder_attn"]:
        raise AssertionError("K1 never launched in the voxtral phase")
    off["rt"] = rt
    del off["engine"], off_engine
    return off


def phase_kernels_voxtral(launched: dict) -> dict:
    """K1 in bf16 at every (S, T) the Voxtral offline run launched it: the
    whisper-large encoder's full window, 20 heads, at one lane (a
    transcribe call encodes one window). Fails on a launched (S, T) it did
    not check."""
    records = {}
    for S, T in sorted(launched):
        if (S, T) != (1500, 1500):
            raise AssertionError(f"the voxtral run launched K1 at an unchecked shape {(S, T)}")
        records[(S, T)] = _check_k1("voxtral encoder full window", "voxtral", S, T, T, False, torch.bfloat16, 1, LH)
    return records


# ---------------------------------------------------------------------------
# train: the structured-weights trainer, its checkpoint and serving it
# ---------------------------------------------------------------------------

TRAIN_REF_LAYERS = 2     # encoder and decoder depth of the f32 card-vs-CPU reference (base widths)
TRAIN_REF_BATCH = 2
TRAIN_REF_STEPS = 3
TRAIN_ATOL, TRAIN_RTOL, TRAIN_LOSS_TOL = 2e-5, 1e-4, 2e-5  # the CPU parity tests' bars
TRAIN_STEPS = 60         # the full-width trainer's steps in the smoke (base, 6+6 layers, f32, batch 8)
TRAIN_BATCH = 8
TRAIN_DATASET_BATCHES = 2
TRAIN_TOK_LEN = 48
TRAIN_LR = 1e-3          # the trainer's default
TRAIN_SESSIONS = 2       # AudioProcessor sessions on the trained checkpoint
TRAIN_SECONDS = 8.0


def _excess(got: torch.Tensor, want: torch.Tensor) -> float:
    """How far ``got`` is outside rtol of ``want``: at most TRAIN_ATOL to pass."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() - TRAIN_RTOL * want.abs()).max())


def phase_reference_train(tok, word_ids) -> None:
    """The train step in f32 at base widths with 2+2 layers, batch 2, on the
    card against the CPU, from the same scaffolded weights and the same
    three batches of the trainer's data: the loss of each step, every
    gradient of the first, and the weights after three AdamW steps under
    the trainer's warmup-cosine schedule (``--steps 400``: lr 0, then
    2.5e-5, 5e-5), without and with alignment supervision. The card runs
    no kernel here."""
    import dataclasses

    from whisperlivekit_tpu_torch.harness import train_structured as TS
    from whisperlivekit_tpu_torch.models.whisper import model as wm
    from whisperlivekit_tpu_torch.models.whisper.dims import MODEL_DIMS, default_alignment_heads
    from whisperlivekit_tpu_torch.parallel import train as T

    dims = dataclasses.replace(MODEL_DIMS["base"], n_audio_layer=TRAIN_REF_LAYERS, n_text_layer=TRAIN_REF_LAYERS)
    n_words = len(word_ids)
    prompt_len = len(tok.sot_sequence_including_notimestamps)
    batches = [TS.make_batch(tok, word_ids, n_words, [20_000 + TRAIN_REF_BATCH * i + j for j in range(TRAIN_REF_BATCH)],
                             TRAIN_TOK_LEN, dims.n_mels, device="cpu") for i in range(TRAIN_REF_STEPS)]
    lo, hi = TS.align_windows(prompt_len, TRAIN_TOK_LEN, len(TS.schedule(0, TS.WIN_S - 1.0, n_words)))
    for align_on in (False, True):
        runs = {}
        for side, dev in (("card", CARD), ("cpu", "cpu")):
            model = wm.init_params(dims, torch.Generator().manual_seed(7), torch.float32, "cpu")
            model = TS.align_scaffold(model, dims, prompt_len).to(dev)
            tx = T.make_optimizer(T.warmup_cosine_decay_schedule(0.0, TRAIN_LR, 40, 400, TRAIN_LR * 0.05))
            state = T.TrainState(model, tx.init(model), 0)
            align = ((wm.AlignSpec.from_pairs(default_alignment_heads(dims), device=dev),
                      torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev), 1.0) if align_on else ())
            before = sum(_kernel_counts()[k] for k in ("flash_encoder_attn", "xkv_splice", "log_mel_pallas"))
            losses, grads = [], None
            for i, (mel, tokens) in enumerate(batches):
                state, loss = T.train_step(state, torch.from_numpy(mel).to(dev), torch.from_numpy(tokens).to(dev),
                                           dims, tx, *align)
                losses.append(loss.item())
                if i == 0:
                    grads = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
            launched = sum(_kernel_counts()[k] for k in ("flash_encoder_attn", "xkv_splice", "log_mel_pallas")) - before
            runs[side] = (losses, grads, {n: p.detach().cpu() for n, p in model.named_parameters()}, launched)
        (gl, gg, gw, g_launched), (cl, cg, cw, _) = runs["card"], runs["cpu"]
        loss_err = max(abs(a - b) for a, b in zip(gl, cl))
        grad_excess = max(_excess(gg[n], cg[n]) for n in cg)
        weight_excess = max(_excess(gw[n], cw[n]) for n in cw)
        grad_abs = max(float((gg[n] - cg[n]).abs().max()) for n in cg)
        ok = (loss_err <= TRAIN_LOSS_TOL and grad_excess <= TRAIN_ATOL and weight_excess <= TRAIN_ATOL
              and g_launched == 0 and all(math.isfinite(x) for x in gl))
        log("train", reference=f"base widths {TRAIN_REF_LAYERS}+{TRAIN_REF_LAYERS} layers f32 B{TRAIN_REF_BATCH}, "
            f"{TRAIN_REF_STEPS} AdamW steps", align=align_on, card_losses=[round(x, 6) for x in gl],
            cpu_losses=[round(x, 6) for x in cl], loss_err=loss_err, grad_max_abs_err=grad_abs,
            grad_excess=grad_excess, weight_excess=weight_excess, tol=f"{TRAIN_ATOL}+{TRAIN_RTOL}*|cpu|",
            kernel_launches=g_launched, ok=ok)
        if not ok:
            raise AssertionError(f"the card's train step disagrees with the CPU (align={align_on})")


class TrainWatch:
    """Wraps the train step the trainer calls (``parallel.train.train_step``,
    looked up on the module): per step, the ms to a synchronize, the kernel
    launches made inside it, the peak card memory, and which encoder q/k/v
    weights got an all-zero gradient. Restores the step on exit."""

    def __init__(self):
        from whisperlivekit_tpu_torch.parallel import train as T

        self.T, self.ms, self.launched, self.peak, self.zero_grads = T, [], 0, 0, set()

    def __enter__(self):
        real = self.real = self.T.train_step

        def step(state, *a, **k):
            before = _kernel_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real(state, *a, **k)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t) * 1e3)
            after = _kernel_counts()
            self.launched += sum(after[n] - before[n] for n in ("flash_encoder_attn", "xkv_splice", "log_mel_pallas"))
            projs = [(f"encoder.blocks.{i}.attn.{n}", getattr(b.attn, n))
                     for i, b in enumerate(out[0].params.encoder.blocks) for n in "qkv"]
            amax = torch.stack([p.weight.grad.abs().amax() for _, p in projs]).cpu()
            self.zero_grads |= {name for (name, _), m in zip(projs, amax.tolist()) if m == 0}
            self.peak = max(self.peak, torch.cuda.max_memory_allocated())
            return out

        self.T.train_step = step
        return self

    def __exit__(self, *exc):
        self.T.train_step = self.real


async def _serve_trained(native_dir: str, words: list, prof_dir: str) -> dict:
    """TranscriptionEngine(model_path=..., profile_dir=...) on the trained
    checkpoint: two AudioProcessor sessions fed the trainer's event audio
    in real time; each lane tick's kept tokens and stop reason recorded,
    the first ticks traced into ``prof_dir``."""
    from whisperlivekit_tpu_torch.engine.core import TranscriptionEngine, WLKConfig
    from whisperlivekit_tpu_torch.harness import train_structured as TS
    from whisperlivekit_tpu_torch.session.processor import AudioProcessor
    from whisperlivekit_tpu_torch.streaming.session_plan import AlignAttSession

    config = WLKConfig(model_path=native_dir, lan="en", pcm_input=True, vac=False,
                       param_dtype="bfloat16", log_level="WARNING", profile_dir=prof_dir)
    engine = TranscriptionEngine(config)
    if engine.device.type != "cuda":
        raise AssertionError(f"engine landed on {engine.device}, not the card")
    ticks = []
    real_finish = AlignAttSession.finish_tick

    def finish_tick(sess, ti, out):
        ticks.append((int(out.n_keep), int(out.reason)))
        return real_finish(sess, ti, out)

    AlignAttSession.finish_tick = finish_tick
    try:
        engine.scheduler.reset_stats()
        seeds = [300 + s for s in range(TRAIN_SESSIONS)]
        pcms = [(np.clip(TS.events_audio(TRAIN_SECONDS, seed=s, t0=0.0, n_words=len(words)), -1, 1)
                 * 32767).astype("<i2") for s in seeds]
        t1 = time.perf_counter()
        procs = [AudioProcessor(transcription_engine=engine) for _ in seeds]
        texts = await asyncio.gather(*(_feed_processor(p, pcm) for p, pcm in zip(procs, pcms)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        stats = engine.scheduler.stats()
    finally:
        AlignAttSession.finish_tick = real_finish
        TranscriptionEngine.reset()
    return dict(texts=texts, seeds=seeds, wall=wall, stats=stats, ticks=ticks)


def phase_train(keep: str) -> dict:
    """The trainer on the card: the f32 reference, then the full-width base
    trainer through its entry point, its checkpoint round trip, and the
    trained checkpoint served. Kernel counts run from before the trainer to
    after the sessions; the train steps must launch none. The npz is copied
    into ``keep`` for the ab phase."""
    import gc
    from pathlib import Path

    from whisperlivekit_tpu_torch.harness import train_structured as TS
    from whisperlivekit_tpu_torch.harness.vocab import install_standin_vocab
    from whisperlivekit_tpu_torch.harness.wer import compute_wer
    from whisperlivekit_tpu_torch.models.whisper.dims import MODEL_DIMS
    from whisperlivekit_tpu_torch.models.whisper.load import load_native
    from whisperlivekit_tpu_torch.models.whisper.tokenizer import get_tokenizer
    from whisperlivekit_tpu_torch.streaming.alignatt import STOP_EOT

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="wlk_train_") as tmp:
        install_standin_vocab(f"{tmp}/vocab")
        tok = get_tokenizer(True, language="en", task="transcribe")
        words, word_ids = TS.word_vocab(tok)
        phase_reference_train(tok, word_ids)

        argv = ["--model", "base", "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
                "--dataset-batches", str(TRAIN_DATASET_BATCHES), "--tok-len", str(TRAIN_TOK_LEN),
                "--lr", str(TRAIN_LR), "--cache-dir", f"{tmp}/ds", "--out", f"{tmp}/w.npz",
                "--out-native", f"{tmp}/native", "--report", f"{tmp}/report.json"]
        _reset_kernel_counts()  # the train path counts from here: trainer, eval, serving
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with TrainWatch() as watch:
            report = TS.main(argv)
        trainer_s = time.perf_counter() - t0
        eval_counts = _kernel_counts()
        losses = report["losses"]
        steady = sorted(watch.ms[1:]) or watch.ms
        log("train", trainer="base 6+6 layers f32, scaffolded, align-supervised", argv=" ".join(argv[:10]),
            words=report["words"], steps=len(losses), loss_first=round(losses[0], 4),
            loss_last=round(losses[-1], 4), loss_mean_last10=round(float(np.mean(losses[-10:])), 4),
            ms_per_step_p50=round(steady[len(steady) // 2], 2), ms_first_step=round(watch.ms[0], 2),
            peak_GB=round(watch.peak / 2**30, 3), greedy_token_accuracy=report["greedy_token_accuracy"],
            align_sharpness=report["align_sharpness_mean_maxp"], trainer_wall_s=round(trainer_s, 2),
            train_step_launches=watch.launched, eval_k1_launches=eval_counts["flash_encoder_attn"],
            zero_qkv_grads=sorted(watch.zero_grads))
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"train: a loss is not finite: {losses}")
        if not np.mean(losses[-10:]) < losses[0]:
            raise AssertionError(f"train: the loss did not fall: first {losses[0]}, last 10 {losses[-10:]}")
        if watch.launched:
            raise AssertionError(f"train: {watch.launched} kernel launches inside the train steps")
        if watch.zero_grads:
            raise AssertionError(f"train: all-zero encoder gradients: {sorted(watch.zero_grads)}")

        loaded, dims_name = TS.load_params(f"{tmp}/w.npz")
        native, ndims = load_native(f"{tmp}/native", device=CARD)
        same = [n for (n, a), (_, b) in zip(loaded.named_parameters(), native.named_parameters())
                if a.dtype == torch.bfloat16 and torch.equal(a, b)]
        n_params = len(list(native.parameters()))
        log("train", checkpoint="npz + native", dims=dims_name, native_dims_base=ndims == MODEL_DIMS["base"],
            npz_MB=round(Path(f"{tmp}/w.npz").stat().st_size / 2**20, 1),
            tensors_bit_equal=f"{len(same)}/{n_params}")
        if dims_name != "base" or ndims != MODEL_DIMS["base"] or len(same) != n_params:
            raise AssertionError("train: the npz does not read back bit for bit as the saved weights")
        npz = shutil.copy(f"{tmp}/w.npz", f"{keep}/w.npz")
        del loaded, native
        gc.collect()

        run = asyncio.run(_serve_trained(f"{tmp}/native", report["words"], f"{tmp}/prof"))
        traces = list(Path(f"{tmp}/prof").glob("*.pt.trace.json"))
        cats = Counter(e.get("cat") for t in traces for e in json.loads(t.read_text())["traceEvents"])
    counts = _kernel_counts()
    log("train", profile_dir_traces=len(traces), trace_events={k: cats[k] for k in ("cpu_op", "kernel")})
    if len(traces) != 1 or not cats["kernel"] or not cats["cpu_op"]:
        raise AssertionError(f"train: profile_dir left {len(traces)} traces with {dict(cats)}")
    stats = run["stats"]
    kept = [n for n, _ in run["ticks"]]
    reasons = Counter(r for _, r in run["ticks"])
    for (lines, seed) in zip(run["texts"], run["seeds"]):
        hyp = " ".join(t for t, _ in lines)
        ref = " ".join(TS.events_words(seed, 0.0, TRAIN_SECONDS, report["words"]))
        log("train", session=seed, words=len(hyp.split()), ref_words=len(ref.split()),
            wer=round(compute_wer(ref, hyp)["wer"], 4), text=repr(hyp[:120]), ref=repr(ref[:120]))
    names = ("running", "eot", "gate", "rewind", "nospeech", "cap", "ctx")
    log("train", serve="trained base checkpoint, bf16", sessions=len(run["texts"]), audio_s_each=TRAIN_SECONDS,
        wall_s=round(run["wall"], 3), ticks=stats["n_ticks"], lane_ticks=len(kept),
        kept_tokens_per_lane_tick=round(float(np.mean(kept)), 2) if kept else None,
        stop_reasons={names[r]: n for r, n in sorted(reasons.items())}, eot_share=round(reasons[STOP_EOT] / max(len(kept), 1), 3),
        tick_ms_p50=stats["tick_ms_p50"], word_emission_p50_ms=stats["word_emission_p50_ms"],
        failed_ticks=stats["n_failed_ticks"])
    log("train", kernel="flash_encoder_attn", launches=counts["flash_encoder_attn"],
        launches_by_SxT={f"{s}x{t}": n for (s, t), n in sorted(counts["k1_shapes"].items())})
    _check_k1_bodies("train", counts)
    if stats["n_failed_ticks"]:
        raise AssertionError(f"train: {stats['n_failed_ticks']} ticks failed serving the trained checkpoint")
    if counts["flash_encoder_attn"] <= eval_counts["flash_encoder_attn"]:
        raise AssertionError("train: K1 never launched serving the trained checkpoint")
    return dict(report=report, counts=counts, stats=stats, npz=npz)


def phase_kernels_train(launched: dict) -> dict:
    """K1 in bf16 at every (S, T) the train phase launched it: the eval's
    full-window encode at 8 lanes, and the served checkpoint's encoder
    window, tail and prefill buckets at its sessions' lanes. Fails on a
    launched (S, T) it did not check."""
    records = {}
    for S, T in sorted(launched):
        if (S, T) == (1500, 1500):
            label, b, vt = "train eval encoder full window", TRAIN_BATCH, False
        elif S == T:
            label, b, vt = "train serving encoder tail", TRAIN_SESSIONS, False
        elif T == 1500 and S in PREFIX_BUCKETS:
            label, b, vt = f"train serving prefill, bucket {S}", TRAIN_SESSIONS, True
        else:
            raise AssertionError(f"the train run launched K1 at an unchecked shape {(S, T)}")
        records[(S, T)] = _check_k1(label, "base", S, T, T, vt, torch.bfloat16, b, H)
    return records


# ---------------------------------------------------------------------------
# capacity and e2e: the port's two measuring programs on the card
# ---------------------------------------------------------------------------

# (model, widths, tail frames, pool dtypes): harness/capacity.py's base arm
# and the headline model at its narrowest width in every pool dtype
CAPACITY_ARMS = (("base", (96,), 384, ("enc",)), ("large-v3", (24,), 160, ("bf16", "f8", "f8d")))
CAPACITY_REF_MODEL = "large-v3-turbo"  # the reference arm's widths (1280 wide, 128 mels)
CAPACITY_REF_LAYERS = 4  # its encoder depth (turbo's decoder has 4 layers)
CAPACITY_REF_LANES = 2
CAPACITY_REF_TOL = 1e-4  # card against CPU in f32: no_speech_p, and the pools' max |difference| over max(1, max |value|)
E2E_SESSIONS = 16        # harness/e2e_serving.py --n
E2E_SECONDS = 20.0       # --duration
E2E_WARM = 5.0           # --warm
E2E_SHAKEOUT = 10.0      # --shakeout


def phase_reference_capacity() -> None:
    """One capacity arm (harness/capacity.py's ``Arm``: its inputs and
    pools drawn as the sweep draws them) at large-v3-turbo widths with the
    encoder cut to CAPACITY_REF_LAYERS layers, f32 weights and pools,
    CAPACITY_REF_LANES lanes, on the card and on the CPU: the whole-group
    anchor, then the pooled inc tick on the pools it left. The packed
    integers must be equal, no_speech_p and every pool within
    CAPACITY_REF_TOL (the pools relative to their largest value)."""
    from dataclasses import replace

    from whisperlivekit_tpu_torch.harness import capacity as C
    from whisperlivekit_tpu_torch.models.whisper import model as wm
    from whisperlivekit_tpu_torch.models.whisper.dims import MODEL_DIMS

    dims = replace(MODEL_DIMS[CAPACITY_REF_MODEL], n_audio_layer=CAPACITY_REF_LAYERS)
    tail = next(t for name, _, t, _, _ in C.SWEEP if name == CAPACITY_REF_MODEL)
    outs, arms = {}, {}
    before = (flash_encoder_attn.launches, xkv_splice.launches)
    for side, dev in (("card", CARD), ("cpu", "cpu")):
        model = wm.init_params(dims, torch.Generator().manual_seed(7), torch.float32, dev)
        arm = C.Arm(model, dims, CAPACITY_REF_LANES, "bf16", np.random.default_rng(0), C._suppress(dims, dev),
                    *C._align(dims, CAPACITY_REF_MODEL, dev), tail, dev,
                    pool_dt=torch.float32, state_dt=torch.float32)
        with torch.inference_mode():
            outs[side] = [arm.anchor_tick()[0].cpu(), arm.inc_tick()[0].cpu()]
        arms[side] = arm
        if side == "card":
            launched = (flash_encoder_attn.launches - before[0], xkv_splice.launches - before[1])
    ok = True
    for tick, (g, c) in enumerate(zip(outs["card"], outs["cpu"])):
        ints = torch.equal(g[:, :-1], c[:, :-1])
        ns_err = (g[:, -1].view(torch.float32) - c[:, -1].view(torch.float32)).abs().max().item()
        log("reference", model=f"capacity arm, {CAPACITY_REF_MODEL} widths, {CAPACITY_REF_LAYERS}+"
            f"{dims.n_text_layer} layers, f32 random", lanes=CAPACITY_REF_LANES,
            tick=("anchor_group", "inc_skv")[tick], ints_equal=ints, no_speech_err=ns_err,
            kept=g[:, 2 * C.DECODE_STEPS].tolist())
        ok = ok and ints and ns_err <= CAPACITY_REF_TOL
    pool_err = {}
    for key in C.Arm.POOLS:
        got, want = arms["card"].state[key].cpu().double(), arms["cpu"].state[key].double()
        pool_err[key] = (got - want).abs().max().item() / max(1.0, want.abs().max().item())
    log("reference", model="capacity arm", pool_max_abs_err=pool_err, kernel_launches=dict(
        flash_encoder_attn=launched[0], xkv_splice=launched[1]))
    if not ok or max(pool_err.values()) > CAPACITY_REF_TOL or not all(launched):
        raise AssertionError(f"the card's capacity arm disagrees with the CPU (pools {pool_err}) or a kernel "
                             f"did not launch ({launched})")


def phase_capacity() -> dict:
    """harness/capacity.py's ``bench_model`` on the card at full width:
    the card-against-CPU arm first (phase_reference_capacity), then the base
    form's arm at 96 lanes and large-v3 at 24 lanes with bf16, f8 and f8d
    pools. Every arm must run (no skip, no out-of-memory), K1 must launch in
    both models' runs on tensor cores, and K2 in large-v3's, two thirds of
    its launches (the f8 and f8d arms') on the f8 route. Each model's run
    counts its kernels from 0."""
    import gc

    from whisperlivekit_tpu_torch.harness import capacity as C
    from whisperlivekit_tpu_torch.models.whisper.dims import MODEL_DIMS
    from whisperlivekit_tpu_torch.streaming import alignatt as A

    phase_reference_capacity()
    gc.collect()
    torch.cuda.empty_cache()
    results, counts = {}, {}
    for name, widths, tail, dtypes in CAPACITY_ARMS:
        t = time.perf_counter()
        _reset_kernel_counts()
        C.bench_model(name, widths, results, tail_frames=tail, dtypes=dtypes, device=CARD)
        torch.cuda.synchronize()
        counts[name] = _kernel_counts()
        log("capacity", model=name, s=round(time.perf_counter() - t, 1))
        for B in widths:
            for dt in dtypes:
                rec = results[f"{name}_B{B}_{dt}"]
                if not isinstance(rec, dict):
                    raise AssertionError(f"capacity arm {name} B={B} {dt}: {rec}")
                log("capacity", arm=f"{name}_B{B}_{dt}", **rec)
        log("capacity", model=name, peak_streams=results[f"{name}_peak_streams"],
            peak_streams_unconstrained=results[f"{name}_peak_streams_unconstrained"],
            peak_tick_ms=results[f"{name}_peak_tick_ms"])
        c = counts[name]
        log("capacity", model=name, kernel="flash_encoder_attn", launches=c["flash_encoder_attn"],
            launches_by_SxT={f"{s}x{t}": n for (s, t), n in sorted(c["k1_shapes"].items())})
        log("capacity", model=name, kernel="xkv_splice", launches=c["xkv_splice"], f8_route=c["xkv_splice_f8"])
        _check_k1_bodies("capacity", c)
        gc.collect()
        torch.cuda.empty_cache()
    base, large = (counts[arm[0]] for arm in CAPACITY_ARMS)
    if not (base["flash_encoder_attn"] and large["flash_encoder_attn"] and large["xkv_splice"]):
        raise AssertionError(f"a kernel never launched in the capacity phase: {counts}")
    if large["xkv_splice_f8"] != 2 * (large["xkv_splice"] - large["xkv_splice_f8"]):
        raise AssertionError(f"K2's f8 route took {large['xkv_splice_f8']} of {large['xkv_splice']} launches, "
                             "not the f8 and f8d arms'")
    # the pooled arms' K1 call sites: the encoder's window and tail, the
    # anchor's prefill at the cap's bucket and the inc tick's refresh rows
    dims = MODEL_DIMS[CAPACITY_ARMS[1][0]]
    geom = dict(n_audio_ctx=dims.n_audio_ctx, n_text_layer=dims.n_text_layer,
                pool_t=-(-dims.n_audio_ctx // 128) * 128, tail_frames=CAPACITY_ARMS[1][2],
                prefix_buckets=(C.SERVING_PREFIX_CAP,), group_width=max(CAPACITY_ARMS[1][1]),
                refresh_rows=(A.SKV_REFRESH_ROWS,), k1_dtypes=(torch.bfloat16,))
    total = {k: base[k] + large[k] for k in ("flash_encoder_attn", "xkv_splice", "xkv_splice_f8")}
    return dict(results=results, base=base, large=large, total=total, geom=geom)


def phase_e2e(keep: str) -> dict:
    """harness/e2e_serving.py's ``run`` on the card: ``random:large-v3``
    with f8 pools (its defaults), E2E_SESSIONS sessions, E2E_WARM s poured,
    E2E_SHAKEOUT s untimed and E2E_SECONDS s measured, the VAD on with the
    seeded Silero stand-in (written under VAD_STANDIN_DIR, as the vad phase
    does) in WLK_TPU_ASSET_DIR. The run (its priming run included) counts
    its kernels from 0. Fails on a rejected session or one without output,
    a failed tick or a pool recovery (counted across the benchmark's
    resets of the scheduler's counters), on another VAD serving, or when
    K1 or K2 did not launch or K2 left the f8 route."""
    import gc
    import os

    from whisperlivekit_tpu_torch.engine.core import TranscriptionEngine
    from whisperlivekit_tpu_torch.engine.scheduler import BatchScheduler
    from whisperlivekit_tpu_torch.harness import e2e_serving as E
    from whisperlivekit_tpu_torch.harness import harness as TH
    from whisperlivekit_tpu_torch.harness import vad_checkpoint as VC
    from whisperlivekit_tpu_torch.harness.vocab import install_standin_vocab
    from whisperlivekit_tpu_torch.streaming import alignatt as A

    gc.collect()
    torch.cuda.empty_cache()
    path = VC.write_silero_standin(VAD_STANDIN_DIR, VAD_SEED, calibrate=VC.calibration_audio(VAD_SEED + 1))
    was = os.environ.get("WLK_TPU_ASSET_DIR")
    install_standin_vocab(path.parent)
    failed, recovered = [], []
    real_reset = BatchScheduler.reset_stats

    def counted_reset(sched):
        failed.append(sched.n_failed_ticks)
        recovered.append(A.TICK_PHASE_STATS.get("pool_recovery", (0,))[0])
        real_reset(sched)

    out = f"{keep}/e2e.json"  # the summary, for the table phase
    argv = ["--n", str(E2E_SESSIONS), "--duration", str(E2E_SECONDS), "--warm", str(E2E_WARM),
            "--shakeout", str(E2E_SHAKEOUT), "--out", out]
    BatchScheduler.reset_stats = counted_reset
    TH.reset_engine_cache()
    try:
        t = time.perf_counter()
        _reset_kernel_counts()
        summary = E.run(argv)
        torch.cuda.synchronize()
        counts = _kernel_counts()
        wall = time.perf_counter() - t
        (engine,) = TH._engine_cache.values()
        sched = engine.scheduler
        failed.append(sched.n_failed_ticks)
        recovered.append(A.TICK_PHASE_STATS.get("pool_recovery", (0,))[0])
        geom = dict(_large_geom(engine), k1_dtypes=(torch.bfloat16,))  # the path's dtype
    finally:
        BatchScheduler.reset_stats = real_reset
        TH.reset_engine_cache()
        TranscriptionEngine.reset()
        if was is None:
            os.environ.pop("WLK_TPU_ASSET_DIR", None)
        else:
            os.environ["WLK_TPU_ASSET_DIR"] = was
    gc.collect()
    torch.cuda.empty_cache()
    (run,) = summary["runs"]
    st = run["scheduler"]
    log("e2e", model=summary["model"], xkv_dtype=summary["xkv_dtype"], vad=summary["vad"],
        device=repr(summary["device"]), sessions=run["n_sessions"], admitted=run["n_admitted"],
        duration_s=E2E_SECONDS, warm_s=E2E_WARM, shakeout_s=E2E_SHAKEOUT, wall_s=round(wall, 1))
    log("e2e", word_emission_p50_ms=run["word_emission_p50_ms"], word_emission_p95_ms=run["word_emission_p95_ms"],
        keep_up=run["keep_up"], lag_mid_p50_ms=run["emission_lag_mid_p50_ms"],
        lag_late_p50_ms=run["emission_lag_late_p50_ms"], frontier_advances=run["n_frontier_advances"],
        without_output=run["n_sessions_without_output"], mean_infer_ms=run["mean_infer_ms"],
        max_sustained_streams=summary["max_sustained_streams"],
        max_sustained_streams_at_500ms_p50=summary["max_sustained_streams_at_500ms_p50"])
    log("e2e", ticks=st["n_ticks"], avg_lanes=st["avg_lanes_per_tick"], tick_ms_p50=st["tick_ms_p50"],
        tick_ms_p95=st["tick_ms_p95"], queue_wait_p50_ms=st["queue_wait_p50_ms"],
        sched_word_emission_p50_ms=st["word_emission_p50_ms"], failed_ticks_by_window=failed,
        pool_recoveries_by_window=recovered, tick_phases=st["tick_phases"], xkv=st.get("xkv"))
    log("e2e", kernel="flash_encoder_attn", launches=counts["flash_encoder_attn"],
        launches_by_SxT={f"{s}x{t}": n for (s, t), n in sorted(counts["k1_shapes"].items())})
    log("e2e", kernel="xkv_splice", launches=counts["xkv_splice"], f8_route=counts["xkv_splice_f8"])
    _check_k1_bodies("e2e", counts)
    if run["n_rejected"] or run["n_sessions_without_output"]:
        raise AssertionError(f"e2e: {run['n_rejected']} sessions rejected, {run['n_sessions_without_output']} "
                             "without output")
    if any(failed) or any(recovered):
        raise AssertionError(f"e2e: failed ticks {failed}, pool recoveries {recovered}")
    if summary["vad"] != "SileroJITVAD":
        raise AssertionError(f"e2e: the {summary['vad']} VAD served, not the Silero stand-in")
    if not (counts["flash_encoder_attn"] and counts["xkv_splice"]) or counts["xkv_splice_f8"] != counts["xkv_splice"]:
        raise AssertionError(f"e2e: a kernel never launched, or K2 left the f8 route: {counts}")
    return dict(summary=summary, counts=counts, geom=geom, out=out)


# ---------------------------------------------------------------------------
# ab, tick_cost, table, scatter, qwen3_capacity: the port's other measuring
# programs (twins of the JAX side's scripts) on the card
# ---------------------------------------------------------------------------

AB_REF_LAYERS = 2        # encoder and decoder depth of the f32 card-vs-CPU A/B (base widths)
AB_REF_TICKS = 12
AB_REF_TOL = 1e-4        # the A/B's float fields, card against CPU, over max(1, |CPU value|)
AB_INTS = ("n_ticks_compared", "inc_tick_mix", "gate_frames", "committed_tokens", "xkv_dtype", "n_ticks",
           "gate_flip_rate")
AB_DECODER_TICKS = 22    # run_decoder_ab's ticks at large-v3 (21 inc ticks an arm)
TICK_COST_ARGV = ["--n", "24", "--ticks", "20", "--model", "large-v3", "--xkv-dtype", "f8"]
SCATTER_SECONDS = 4.0    # the scatter dataset's one clip of event audio
SCATTER_SEED = 11


class EngineLog:
    """Records every engine harness/ab_inc_exact.py builds and every session
    its ``make_inc_session`` wires, while in effect."""

    def __init__(self):
        from whisperlivekit_tpu_torch.harness import ab_inc_exact as AB

        self.AB, self.engines, self.sessions = AB, [], []

    def __enter__(self):
        self.real_build, self.real_make = self.AB.build_engine, self.AB.make_inc_session

        def build(*a, **k):
            self.engines.append(self.real_build(*a, **k))
            return self.engines[-1]

        def make(engine, group_width=1):
            self.sessions.append(self.real_make(engine, group_width))
            return self.sessions[-1]
        self.AB.build_engine, self.AB.make_inc_session = build, make
        return self

    def __exit__(self, *exc):
        self.AB.build_engine, self.AB.make_inc_session = self.real_build, self.real_make


def _xkv_geom(eng, xkv) -> dict:
    """The large form's kernel geometry of an engine and a cross-KV
    allocator with at least one group (see k1_large_cases)."""
    from whisperlivekit_tpu_torch.streaming import alignatt as A

    k = xkv.groups[0].k
    return dict(n_audio_ctx=eng.dims.n_audio_ctx, n_text_layer=eng.dims.n_text_layer, pool_t=k.shape[-1],
                tail_frames=eng.cfg.enc_tail_frames, prefix_buckets=eng.prefix_buckets,
                group_width=xkv.group_width,
                refresh_rows=(A.SKV_REFRESH_ROWS, A._skv_full_refresh_rows(eng, xkv.skv_width)),
                k1_dtypes=(torch.bfloat16,))


def phase_reference_ab(tok) -> None:
    """harness/ab_inc_exact.py's ``run_model`` and ``run_decoder_ab`` at
    base widths with AB_REF_LAYERS + AB_REF_LAYERS layers in f32, the same
    seeded weights on the card and on the CPU, AB_REF_TICKS ticks, with the
    cross-KV pools off and forced on (the engine maker is the smoke's; the
    fallback alignment heads, the published ones naming deeper layers).
    Every integer field must be equal (tick mix, gate frames, committed
    token counts and agreement), the float fields within AB_REF_TOL."""
    from dataclasses import replace

    from whisperlivekit_tpu_torch.harness import ab_inc_exact as AB
    from whisperlivekit_tpu_torch.models.whisper import model as wm
    from whisperlivekit_tpu_torch.models.whisper.dims import MODEL_DIMS
    from whisperlivekit_tpu_torch.streaming.alignatt import AlignAttConfig, AlignAttEngine

    dims = replace(MODEL_DIMS["base"], n_audio_layer=AB_REF_LAYERS, n_text_layer=AB_REF_LAYERS)
    real = AB.build_engine
    try:
        for xkv_cache in (False, True):
            def build(model, ft, xkv_dtype, decoder_dtype="bf16", weights=None, enc_tail_frames=0, device=None):
                m = wm.init_params(dims, torch.Generator().manual_seed(7), torch.float32, device)
                if decoder_dtype == "f8":
                    m = wm.quantize_decoder_f8(m)
                cfg = AlignAttConfig(language="en", frame_threshold=ft, xkv_cache_dtype=xkv_dtype,
                                     enc_tail_frames=enc_tail_frames, xkv_cache=xkv_cache)
                return AlignAttEngine(m, dims, tok, cfg)
            AB.build_engine = build
            for name, run in (("run_model", lambda dev: AB.run_model("base", AB_REF_TICKS / 60, 1, "bf16", 3,
                                                                       device=dev)),
                              ("run_decoder_ab", lambda dev: AB.run_decoder_ab("base", AB_REF_TICKS / 60, 1, "bf16",
                                                                               device=dev))):
                card, cpu = run(CARD), run("cpu")
                ints = {k: card[k] for k in AB_INTS if k in card}
                ints_equal = ints == {k: cpu[k] for k in AB_INTS if k in cpu}
                errs = {}
                for k, v in (card.get("encoder_divergence") or {}).items():
                    want = cpu["encoder_divergence"][k]
                    if k == "n_samples":
                        ints_equal = ints_equal and v == want
                    elif v is not None or want is not None:
                        errs[k] = abs(v - want) / max(1.0, abs(want))
                log("reference", program=f"ab_inc_exact.{name}", model=f"base widths {AB_REF_LAYERS}+"
                    f"{AB_REF_LAYERS} layers, f32 random", xkv_cache=xkv_cache, ticks=AB_REF_TICKS,
                    ints_equal=ints_equal, float_err=errs, **ints)
                if not ints_equal or any(e > AB_REF_TOL for e in errs.values()):
                    raise AssertionError(f"ab {name} (xkv_cache={xkv_cache}): the card disagrees with the CPU: "
                                         f"card {card}, CPU {cpu}")
    finally:
        AB.build_engine = real


def phase_ab(train_npz: str) -> dict:
    """harness/ab_inc_exact.py on the card: the f32 reference
    (phase_reference_ab), then at full width ``run_model("large-v3", 0.75,
    1, "bf16", 5)`` (45 ticks: the eviction re-anchor runs),
    ``run_decoder_ab("large-v3", AB_DECODER_TICKS / 60, 1, "f8")`` and ``run_model("base",
    1.0, 1, "bf16", 5)`` on the train phase's structured checkpoint with its
    event audio, reset every 30 s. Each run counts its kernels from 0.
    Checks that anchor and inc ticks both ran and the encoder divergence
    has samples, that both arms committed tokens, that K1 launched on
    tensor cores in every run and K2 in the large-v3 runs (on the f8 route
    in the f8 one only)."""
    import gc

    from whisperlivekit_tpu_torch.harness import ab_inc_exact as AB
    from whisperlivekit_tpu_torch.models.whisper.tokenizer import get_tokenizer

    phase_reference_ab(get_tokenizer(True, language="en", task="transcribe"))
    runs, counts, geoms = {}, {}, {}
    plans = (
        ("large-v3 inc_vs_exact", lambda: AB.run_model("large-v3", 0.75, 1, "bf16", 5)),
        ("large-v3 decoder_bf16_vs_f8", lambda: AB.run_decoder_ab("large-v3", AB_DECODER_TICKS / 60, 1, "f8")),
        ("base structured", lambda: AB.run_model("base", 1.0, 1, "bf16", 5, weights=train_npz,
                                                 audio_kind="events", reset_every_s=30)),
    )
    for name, run in plans:
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        with EngineLog() as el:
            _reset_kernel_counts()
            runs[name] = run()
            torch.cuda.synchronize()
            counts[name] = _kernel_counts()
        pooled = [s for s in el.sessions if s.xkv_alloc is not None and s.xkv_alloc.groups]
        if pooled:
            geoms[name] = _xkv_geom(el.engines[0], pooled[0].xkv_alloc)
        del el
        r, c = runs[name], counts[name]
        log("ab", run=name, s=round(time.perf_counter() - t, 1), result=json.dumps(r))
        log("ab", run=name, kernel="flash_encoder_attn", launches=c["flash_encoder_attn"],
            launches_by_SxT={f"{s}x{t}": n for (s, t), n in sorted(c["k1_shapes"].items())})
        log("ab", run=name, kernel="xkv_splice", launches=c["xkv_splice"], f8_route=c["xkv_splice_f8"])
        _check_k1_bodies("ab", c)
        if "inc_tick_mix" in r:
            mix, div, toks = r["inc_tick_mix"], r["encoder_divergence"], r["committed_tokens"]
            if not (mix["inc"] and mix["anchor"] and div["n_samples"] and toks["n_inc"] and toks["n_exact"]):
                raise AssertionError(f"ab {name}: a tick mode, a divergence sample or an arm's tokens missing: {r}")
        elif not (r["committed_tokens"]["n_bf16"] and r["committed_tokens"]["n_f8"]):
            raise AssertionError(f"ab {name}: an arm committed no token: {r}")
        large, f8 = name.startswith("large-v3"), "f8" in name
        if not c["flash_encoder_attn"] or (large and not c["xkv_splice"]) or (not large and c["xkv_splice"]):
            raise AssertionError(f"ab {name}: K1 or K2 launched where it should not, or not where it should: {c}")
        if c["xkv_splice_f8"] != (c["xkv_splice"] if f8 else 0):
            raise AssertionError(f"ab {name}: K2's f8 route took {c['xkv_splice_f8']} of {c['xkv_splice']} launches")
    total = {k: sum(c[k] for c in counts.values()) for k in ("flash_encoder_attn", "xkv_splice", "xkv_splice_f8")}
    large_shapes = Counter()
    for name, c in counts.items():
        if name.startswith("large-v3"):
            large_shapes += Counter(c["k1_shapes"])
    return dict(runs=runs, counts=counts, total=total, geoms=geoms, large_k1_shapes=dict(large_shapes),
                base_k1_shapes=counts["base structured"]["k1_shapes"])


def phase_tick_cost(e2e: dict) -> dict:
    """harness/e2e_tick_cost.py on the card: ``random`` large-v3 bf16 from a
    seed, f8 pools, 24 sessions, 20 ticks, its scheduler's warm pass timed
    apart; counts the kernels from 0 before the engine is built. Checks
    that every tick after the first served 24 lanes, that the modes include
    ``anchor_xkv`` and ``inc_xkv``, and that K1 (tensor cores) and K2 (all
    on the f8 route) launched. Prints the rows, the summary and the warm
    pass, beside the e2e phase's scheduler tick p50 / p95."""
    import gc
    import io

    from whisperlivekit_tpu_torch.engine import scheduler as SCH
    from whisperlivekit_tpu_torch.harness import e2e_tick_cost as TC

    gc.collect()
    torch.cuda.empty_cache()
    scheds = []
    real = SCH.BatchScheduler

    class Recorded(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            scheds.append(self)

    SCH.BatchScheduler = Recorded
    out = io.StringIO()
    try:
        t = time.perf_counter()
        _reset_kernel_counts()
        with contextlib.redirect_stdout(out):
            res = TC.run(TICK_COST_ARGV)
        torch.cuda.synchronize()
        counts = _kernel_counts()
        wall = time.perf_counter() - t
    finally:
        SCH.BatchScheduler = real
    (sched,) = scheds
    geom = _xkv_geom(sched.engine, sched.xkv)
    del scheds, sched
    gc.collect()
    torch.cuda.empty_cache()
    for row in res["rows"]:
        log("tick_cost", **row)
    summ, st = res["summary"], e2e["summary"]["runs"][0]["scheduler"]
    log("tick_cost", argv=" ".join(TICK_COST_ARGV), wall_s=round(wall, 1), warm_pass_s=res["warm_pass_s"],
        summary=json.dumps(summ))
    log("tick_cost", e2e_sched_tick_ms_p50=st["tick_ms_p50"], e2e_sched_tick_ms_p95=st["tick_ms_p95"],
        tick_wall_ms_p50=summ["tick_wall_ms_p50"], tick_wall_ms_p95=summ["tick_wall_ms_p95"],
        tick_device_ms_p50=summ["tick_device_ms_p50"],
        prepare_ms_mean=summ["prepare_ms_mean"], finish_ms_mean=summ["finish_ms_mean"])
    log("tick_cost", kernel="flash_encoder_attn", launches=counts["flash_encoder_attn"],
        launches_by_SxT={f"{s}x{t}": n for (s, t), n in sorted(counts["k1_shapes"].items())})
    log("tick_cost", kernel="xkv_splice", launches=counts["xkv_splice"], f8_route=counts["xkv_splice_f8"])
    _check_k1_bodies("tick_cost", counts)
    lanes = [r["lanes"] for r in res["rows"][1:]]
    modes = {m for r in res["rows"] for m in r["modes"]}
    if len(res["rows"]) != 20 or set(lanes) != {24} or not {"anchor_xkv", "inc_xkv"} <= modes:
        raise AssertionError(f"tick_cost: lanes after the first tick {lanes}, modes {modes}")
    if not (counts["flash_encoder_attn"] and counts["xkv_splice"]) or counts["xkv_splice_f8"] != counts["xkv_splice"]:
        raise AssertionError(f"tick_cost: a kernel never launched, or K2 left the f8 route: {counts}")
    return dict(result=res, counts=counts, geom=geom)


def phase_table(capacity: dict, e2e: dict, card: str) -> dict:
    """harness/capacity_table.py over the capacity phase's sweep and the
    e2e phase's summary, both written as the programs' ``--out`` artifacts
    in a temporary directory, the page too. Checks that every arm the
    capacity phase ran has its row with the same numbers, that the e2e
    rows are there and that the page names the card; prints the page."""
    import tempfile
    from pathlib import Path

    from whisperlivekit_tpu_torch.harness import capacity as C
    from whisperlivekit_tpu_torch.harness import capacity_table as CT

    results = capacity["results"]
    head = C.headline(results[f"{CAPACITY_ARMS[-1][0]}_peak_streams"])
    with tempfile.TemporaryDirectory(prefix="wlk_table_") as tmp:
        sweep, page = Path(tmp) / "capacity.json", Path(tmp) / "CAPACITY_torch.md"
        sweep.write_text(json.dumps(C.artifact(head, results, CARD, "smoke"), indent=1) + "\n")
        if CT.main([str(sweep), "--e2e", e2e["out"], "--out", str(page)]) != 0:
            raise AssertionError("table: capacity_table.main failed")
        text = page.read_text()
    for ln in text.splitlines():
        if ln.startswith(("| ", "- ", "**Headline")):
            log("table", line=repr(ln))
    missing = []
    for name, widths, _, dtypes in CAPACITY_ARMS:
        for B in widths:
            for dt in dtypes:
                a = results[f"{name}_B{B}_{dt}"]
                row = (f"| {name} | {B} | {dt} | {a['inc_ms']} ms | {a['anchor_ms']} ms | {a['amortized_ms']} ms | "
                       f"**{a['streams']}** |")
                if row not in text.splitlines():
                    missing.append(row)
    runs = e2e["summary"]["runs"]
    e2e_rows = [ln for ln in text.splitlines() if ln.startswith(tuple(f"| {r['n_sessions']} | " for r in runs))]
    log("table", arms_missing=len(missing), e2e_rows=len(e2e_rows), names_card=f"device {card}" in text)
    if missing or len(e2e_rows) != len(runs) or f"device {card}" not in text:
        raise AssertionError(f"table: arms missing {missing}, e2e rows {e2e_rows}, or the card unnamed")
    return dict(text=text)


def phase_scatter() -> dict:
    """harness/scatter.py on ``random:base`` over a dataset it writes in a
    temporary directory: one SCATTER_SECONDS clip of event audio
    (harness/train_structured.py) with its words as the reference; all
    three policies, aware both ways, ``--compare-exact``: 8 points. The
    LocalAgreement and windowed backends are pinned at LA_PINNED (the la
    phase's: random weights rarely end a window, and each call would
    decode 6 attempts x 224 steps). Counts the kernels from 0. Checks that
    every point has its rtf and wer, that the exact and incremental points
    are both there and that K1 launched on tensor cores."""
    import os
    import tempfile
    import wave
    from pathlib import Path

    from whisperlivekit_tpu_torch.engine import core
    from whisperlivekit_tpu_torch.harness import scatter as S
    from whisperlivekit_tpu_torch.harness import train_structured as TS
    from whisperlivekit_tpu_torch.harness.vocab import install_standin_vocab
    from whisperlivekit_tpu_torch.models.whisper.tokenizer import get_tokenizer

    real_init = core.TranscriptionEngine.__init__

    def pinned_init(self, *a, **k):
        real_init(self, *a, **k)
        if type(self.asr).__name__ == "LocalAgreementASR":
            self.asr.asr.transcribe_kargs.update(LA_PINNED)

    was = os.environ.get("WLK_TPU_ASSET_DIR")
    with tempfile.TemporaryDirectory(prefix="wlk_scatter_") as tmp:
        install_standin_vocab(f"{tmp}/vocab")
        words, _ = TS.word_vocab(get_tokenizer(True, language="en", task="transcribe"))
        data = Path(tmp) / "data"
        data.mkdir()
        audio = TS.events_audio(SCATTER_SECONDS, seed=SCATTER_SEED, t0=0.0)
        with wave.open(str(data / "events.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())
        ref = " ".join(TS.events_words(SCATTER_SEED, 0.0, SCATTER_SECONDS, words))
        (data / "events.txt").write_text(ref)
        core.TranscriptionEngine.__init__ = pinned_init
        try:
            t = time.perf_counter()
            _reset_kernel_counts()
            rc = S.main(["--dataset-dir", str(data), "--models", "random:base", "--compare-exact",
                         "--out", f"{tmp}/scatter.json"])
            torch.cuda.synchronize()
            counts = _kernel_counts()
            wall = time.perf_counter() - t
            points = json.loads(Path(f"{tmp}/scatter.json").read_text())["results"] if rc == 0 else []
        finally:
            core.TranscriptionEngine.__init__ = real_init
            if was is None:
                os.environ.pop("WLK_TPU_ASSET_DIR", None)
            else:
                os.environ["WLK_TPU_ASSET_DIR"] = was
    log("scatter", clip_s=SCATTER_SECONDS, ref_words=len(ref.split()), la_pinned=LA_PINNED, rc=rc,
        wall_s=round(wall, 1))
    for p in points:
        log("scatter", **p)
    log("scatter", kernel="flash_encoder_attn", launches=counts["flash_encoder_attn"],
        launches_by_SxT={f"{s}x{t}": n for (s, t), n in sorted(counts["k1_shapes"].items())})
    _check_k1_bodies("scatter", counts)
    if (rc != 0 or len(points) != 8 or any(p["rtf"] is None or p["wer"] is None for p in points)
            or {p["encode"] for p in points} != {"incremental", "exact"} or not counts["flash_encoder_attn"]):
        raise AssertionError(f"scatter: rc {rc}, points {points}, K1 launches {counts['flash_encoder_attn']}")
    return dict(points=points, counts=counts)


def phase_qwen3_capacity() -> dict:
    """harness/capacity_qwen3.py on the card at Qwen3-ASR-0.6B's full dims
    (24-layer tower, 28-layer Qwen3, bf16) over B 8-64. Checks that every B
    ran (none out of memory) and recorded its decode steps; prints each B's
    tick ms, streams and steps."""
    import gc
    import io
    import tempfile
    from pathlib import Path

    from whisperlivekit_tpu_torch.harness import capacity_qwen3 as Q

    gc.collect()
    torch.cuda.empty_cache()
    out = io.StringIO()
    with tempfile.TemporaryDirectory(prefix="wlk_qwen3_") as tmp:
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = Q.main(["--out", f"{tmp}/q.json"])
        wall = time.perf_counter() - t
        res = json.loads(Path(f"{tmp}/q.json").read_text())
    gc.collect()
    torch.cuda.empty_cache()
    log("qwen3_capacity", rc=rc, wall_s=round(wall, 1), device=repr(res["device"]),
        peak_streams=res["peak_streams"])
    for B in Q.B_SWEEP:
        log("qwen3_capacity", B=B, **(res[f"B{B}"] if isinstance(res.get(f"B{B}"), dict) else
                                      {"result": res.get(f"B{B}")}))
    bad = [B for B in Q.B_SWEEP if not isinstance(res.get(f"B{B}"), dict) or len(res[f"B{B}"]["decode_steps"]) != 3]
    if rc != 0 or bad:
        raise AssertionError(f"qwen3_capacity: B {bad} did not run or recorded no steps: {res}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k3-ab", metavar="LOG_MEL_CU", default=None,
                    help="only time K3 against PR 3/4's DFT-by-product log_mel.cu at this path, in turns")
    ap.add_argument("--k4", action="store_true",
                    help="only check and time K4 and one turbo decode step with and without it")
    args = ap.parse_args(argv)
    if args.k3_ab:
        card = phase_device()
        phase_k3_ab(args.k3_ab)
        print(card, flush=True)
        return 0
    if args.k4:
        card = phase_device()
        phase_kernels_k4()
        print(card, flush=True)
        return 0
    watch = LogWatch()
    logging.getLogger().addHandler(watch)
    t0 = time.perf_counter()

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        log("time", step=name, s=round(time.perf_counter() - t, 1), total_s=round(time.perf_counter() - t0, 1))
        return out

    card = timed("device", phase_device)
    records = timed("kernels", phase_kernels)
    k4_records = timed("kernels_k4", phase_kernels_k4)
    main_run = timed("main", phase_main)
    front = timed("front", phase_front)
    large = timed("large", phase_large)
    f8 = timed("f8", phase_f8, large)
    beam = timed("beam", phase_beam)
    beam_records = timed("kernels_beam", phase_kernels_beam, beam["counts"]["k1_shapes"])
    load = timed("load", phase_load, card)
    groups = timed("groups", phase_groups)
    la = timed("la", phase_la)
    la_records = timed("kernels_la", phase_kernels_la, la["counts"]["k1_shapes"])
    dt = timed("diar_tr", phase_diar_tr, main_run)
    dt_records = timed("kernels_diar_tr", phase_kernels_base, "diar_tr", dt["counts"]["k1_shapes"])
    vad = timed("vad", phase_vad, main_run)
    vad_records = timed("kernels_vad", phase_kernels_base, "vad", vad["counts"]["k1_shapes"])
    timed("causal", phase_causal)
    vox = timed("voxtral", phase_voxtral)
    vox_records = timed("kernels_voxtral", phase_kernels_voxtral, vox["counts"]["k1_shapes"])
    keep = tempfile.mkdtemp(prefix="wlk_smoke_")  # the train npz and the e2e summary, for later phases
    try:
        train = timed("train", phase_train, keep)
        train_records = timed("kernels_train", phase_kernels_train, train["counts"]["k1_shapes"])
        capacity = timed("capacity", phase_capacity)
        cap_records = timed("kernels_capacity", phase_kernels_base, "capacity",
                            capacity["base"]["k1_shapes"], CAPACITY_ARMS[0][1][0])
        e2e = timed("e2e", phase_e2e, keep)
        ab = timed("ab", phase_ab, train["npz"])
        tick_cost = timed("tick_cost", phase_tick_cost, e2e)
        timed("table", phase_table, capacity, e2e, card)
        scatter = timed("scatter", phase_scatter)
        timed("qwen3_capacity", phase_qwen3_capacity)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    # the ab runs and the scatter sweep serve the base form one lane at a time
    one_lane_records = timed("kernels_ab_scatter", phase_kernels_base, "ab and scatter",
                             Counter(ab["base_k1_shapes"]) + Counter(scatter["counts"]["k1_shapes"]), 1)
    large_records = timed("kernels_large", phase_kernels_large,
                          {"large-v3": large["geom"], "large-v3 f8": f8["geom"], LOAD_MODEL: load["geom"],
                           f"{GROUP_MODEL} groups": groups["geom"], "large-v3 capacity": capacity["geom"],
                           "large-v3 e2e": e2e["geom"], "large-v3 tick_cost": tick_cost["geom"],
                           **{f"{name} (ab)": g for name, g in ab["geoms"].items()}},
                          Counter(large["counts"]["k1_shapes"]) + Counter(f8["counts"]["k1_shapes"])
                          + Counter(load["counts"]["k1_shapes"]) + Counter(groups["counts"]["k1_shapes"])
                          + Counter(capacity["large"]["k1_shapes"])
                          + Counter(e2e["counts"]["k1_shapes"]) + Counter(tick_cost["counts"]["k1_shapes"])
                          + Counter(ab["large_k1_shapes"]))
    k3_launched = (Counter(front["counts"]["k3_shapes"]) + Counter(large["counts"]["k3_shapes"])
                   + Counter(f8["counts"]["k3_shapes"]) + Counter(load["counts"]["k3_shapes"]))
    k3_records = timed("kernels_k3", phase_kernels_k3, k3_launched)
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
    k1_errs += [r["max_abs_err"] for r in beam_records.values()]
    k1_errs += [r["max_abs_err"] for r in la_records.values()]
    k1_errs += [r["max_abs_err"] for r in dt_records.values()]
    k1_errs += [r["max_abs_err"] for r in vad_records.values()]
    k1_errs += [r["max_abs_err"] for r in vox_records.values()]
    k1_errs += [r["max_abs_err"] for r in train_records.values()]
    k1_errs += [r["max_abs_err"] for r in cap_records.values()]
    k1_errs += [r["max_abs_err"] for r in one_lane_records.values()]
    G = large["geom"]["group_width"]
    k1 = large_records[("flash_encoder_attn", 1500, 1500, "bfloat16", G)]
    L = large["geom"]["n_text_layer"]
    k2 = large_records[("xkv_splice", L, G, "bfloat16", "bfloat16")]
    k2_f8 = large_records[("xkv_splice", L, G, "float8_e4m3fn", "bfloat16")]
    k3 = k3_records[(8, 480000, 80)]
    fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    launches = {"flash_encoder_attn": {"base": main_run["launches"],
                                       "front": front["counts"]["flash_encoder_attn"],
                                       "large": large["counts"]["flash_encoder_attn"],
                                       "f8": f8["counts"]["flash_encoder_attn"],
                                       "beam": beam["counts"]["flash_encoder_attn"],
                                       "load": load["counts"]["flash_encoder_attn"],
                                       "groups": groups["counts"]["flash_encoder_attn"],
                                       "la": la["counts"]["flash_encoder_attn"],
                                       "diar_tr": dt["counts"]["flash_encoder_attn"],
                                       "vad": vad["counts"]["flash_encoder_attn"],
                                       "voxtral": vox["counts"]["flash_encoder_attn"],
                                       "train": train["counts"]["flash_encoder_attn"],
                                       "capacity": capacity["total"]["flash_encoder_attn"],
                                       "e2e": e2e["counts"]["flash_encoder_attn"],
                                       "ab": ab["total"]["flash_encoder_attn"],
                                       "tick_cost": tick_cost["counts"]["flash_encoder_attn"],
                                       "scatter": scatter["counts"]["flash_encoder_attn"]},
                "xkv_splice": {"large": large["counts"]["xkv_splice"], "f8": f8["counts"]["xkv_splice"],
                               "load": load["counts"]["xkv_splice"], "groups": groups["counts"]["xkv_splice"],
                               "capacity": capacity["total"]["xkv_splice"], "e2e": e2e["counts"]["xkv_splice"],
                               "ab": ab["total"]["xkv_splice"], "tick_cost": tick_cost["counts"]["xkv_splice"]},
                "log_mel_pallas": {"front": front["counts"]["log_mel_pallas"],
                                   "large": large["counts"]["log_mel_pallas"],
                                   "f8": f8["counts"]["log_mel_pallas"],
                                   "load": load["counts"]["log_mel_pallas"]},
                # every greedy AlignAtt decode step, on every path that runs _tick_core
                "dry_penalty": {name: run["counts"]["dry_penalty"] for name, run in (
                    ("base", main_run), ("front", front), ("large", large), ("f8", f8),
                    ("beam", beam), ("load", load), ("groups", groups), ("e2e", e2e),
                    ("tick_cost", tick_cost))}}
    if not launches["dry_penalty"]["base"]:
        raise AssertionError("K4 never launched on the base form's main path")
    # K2's f8 route (float8_e4m3fn pools from bf16 tails): its own record
    extra = {"xkv_splice": {"f8": dict(
        {f: k2_f8[f] for f in fields + ("device_ms",)}, timed_shape=f"{L}x{G}x{LH}x{DH}"
        f"x{large['geom']['pool_t']} float8_e4m3fn pool, bfloat16 tails",
        launches_by_path={"f8": f8["counts"]["xkv_splice_f8"], "capacity": capacity["total"]["xkv_splice_f8"],
                          "e2e": e2e["counts"]["xkv_splice_f8"], "ab": ab["total"]["xkv_splice_f8"],
                          "tick_cost": tick_cost["counts"]["xkv_splice_f8"]})}}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0][0], "replaces": KERNELS[name][1],
         "launches": sum(launches[name].values()), "launches_by_path": launches[name],
         "max_abs_err": err, **{f: rec[f] for f in fields}, "timed_shape": shape,
         **{f: rec[f] for f in ("dft_bound_ms", "device_ms", "library_device_ms", "body", "load_route",
                                 "stft_chain_ms", "default_front_ms", "host_us", "plain_host_us",
                                 "launches_per_call") if f in rec},
         **({"f32_source": KERNELS[name][0][1]} if len(KERNELS[name][0]) > 1 else {}),
         **extra.get(name, {})}
        for name, rec, err, shape in (
            ("flash_encoder_attn", k1, max(k1_errs), f"B{G}xH{LH}xS1500xT1500xDh{DH} bf16"),
            ("xkv_splice", k2, 0.0, f"{large['geom']['n_text_layer']}x{G}x{LH}x{DH}"
                                    f"x{large['geom']['pool_t']} bf16"),
            ("log_mel_pallas", k3, max(r["max_abs_err"] for r in k3_records.values()),
             "B8xN480000, 80 mels, f32"),
            ("dry_penalty", k4_records[64], 0.0, f"B64xL{K4_L}xV{K4_V} f32"),
        )
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
