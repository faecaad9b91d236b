"""Qwen3-ASR causal streaming policy: append-only encode, constant compute/s
(port of whisperlivekit_tpu/streaming/qwen3_causal.py).

Every ~2 s audio block is encoded exactly once by the block-causal tower;
the text decoder keeps one KV over ``[prompt | audio tokens]``; each update
decodes a fresh greedy hypothesis whose KV lands after the audio prefix and
is overwritten by the next block (no cache copies); text commits by a
stable-prefix rule with word hold-back; the audio window is bounded
(~15 s) with segment resets at sentence boundaries — so memory and
per-second compute are constant in stream length.

Word timestamps are interpolated estimates across the un-committed audio
span (~1 s precision, like the reference's qwen3/voxtral interpolation).

The host policy is the JAX module's line for line; the device calls run
the port's models on the holder's device. The local caches (no pooled
service) live there too. The tokenizer of a checkpoint directory is
``transformers``' ``AutoTokenizer`` when the directory holds tokenizer
files; without any, the debug tokenizer (id N decodes to "tN"). Files that
are present while ``transformers`` is missing raise (the JAX loader falls
back on any exception).
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..audio.mel import log_mel_spectrogram
from ..models import llama as lm
from ..models import qwen3_asr as qm
from ..timed import PUNCTUATION_MARKS, ASRToken, ChangeSpeaker, Transcript

logger = logging.getLogger(__name__)

MIN_DURATION_REAL_SILENCE = 5.0

#: files whose presence marks a checkpoint directory's tokenizer
TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "vocab.json", "tokenizer.model")

#: seed of the random weights behind ``random:<size>`` (voxtral realtime: seed + 1)
RANDOM_WEIGHTS_SEED = 0


def _has_punct(word: str) -> bool:
    return any(ch in PUNCTUATION_MARKS for ch in word)


class DebugWordTokenizer:
    """Deterministic id→word tokenizer for random-weight runs (no egress, no
    HF tokenizer): id N decodes to "tN". Real checkpoints use AutoTokenizer."""

    eos_id = 0

    def decode(self, ids: List[int]) -> str:
        return " ".join(f"t{i}" for i in ids)

    def encode(self, text: str) -> List[int]:
        out = []
        for w in text.split():
            if w.startswith("t") and w[1:].isdigit():
                out.append(int(w[1:]))
        return out


class Qwen3CausalASR:
    """Engine-level holder: weights + tokenizer + policy knobs (shared).
    ``params`` is the ``Qwen3ASR`` module, on the device that serves it."""

    sep = " "

    #: fixed prompt-context pad budget (tokens): per-session carry ids are
    #: right-padded to this length so the pooled prime stays one program
    CTX_BUDGET = 32

    def __init__(
        self,
        params,
        dims: qm.Qwen3ASRDims,
        tokenizer=None,
        prompt_ids: Optional[List[int]] = None,
        hyp_start_ids: Optional[List[int]] = None,
        eos_id: Optional[int] = None,
        window_s: float = 15.0,
        hold_back_words: int = 2,
        max_new: int = 48,
        context: str = "",
        stable_iterations: Optional[int] = None,
        segment_max_steps: int = 200,
        segment_keep_tail_steps: int = 0,
        prompt_context_words: int = 0,
    ):
        self.params = params
        self.dims = dims
        self.tokenizer = tokenizer or DebugWordTokenizer()
        self.prompt_ids = list(prompt_ids or [1, 2, 3])
        if context:
            # static text context (reference qwen3_streaming_context) becomes
            # part of the shared prompt — identical for every lane, so the
            # pooled prime's tiled prompt is preserved
            self.prompt_ids.extend(self.tokenizer.encode(context))
        self.hyp_start_ids = list(hyp_start_ids or [4])
        self.eos_id = eos_id if eos_id is not None else getattr(self.tokenizer, "eos_id", 0)
        self.window_s = window_s
        self.hold_back_words = hold_back_words
        self.max_new = max_new
        # reference auto rule: 2 for windowed re-encode, 1 for causal
        self.stable_iterations = 1 if stable_iterations is None else max(1, stable_iterations)
        self.segment_max_steps = max(1, segment_max_steps)
        self.segment_keep_tail_steps = max(0, segment_keep_tail_steps)
        self.prompt_context_words = max(0, prompt_context_words)
        self.ctx_budget = (
            self.CTX_BUDGET
            if (self.prompt_context_words or self.segment_keep_tail_steps)
            else 0
        )
        # decoder cache sized for prompt + carry context + every ADMITTED
        # audio block (the flush policy admits ceil(window/block) blocks)
        # + hypothesis
        window_tokens = dims.window_blocks(window_s) * dims.block_tokens
        self.text_cache_len = (
            len(self.prompt_ids) + self.ctx_budget + window_tokens
            + len(self.hyp_start_ids) + max_new + 8
        )

    @property
    def device(self) -> torch.device:
        return self.params.device


def _checkpoint_dir(path) -> bool:
    import os

    return bool(path) and os.path.isdir(path) and os.path.isfile(os.path.join(path, "config.json"))


def load_hf_word_tokenizer(path: str, what: str):
    """The directory's tokenizer through ``transformers``, or None (with a
    warning) when it holds no tokenizer file. Files present without
    ``transformers`` raise ImportError."""
    import os

    if not any(os.path.isfile(os.path.join(path, f)) for f in TOKENIZER_FILES):
        logger.warning("%s tokenizer files absent from %s; debug tokenizer", what, path)
        return None
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            f"{path} holds {what} tokenizer files, but the transformers package is not installed"
        ) from e
    return _HFWordTokenizer(AutoTokenizer.from_pretrained(path))


def load_qwen3_causal(config, device=None, dtype=torch.float32) -> "Qwen3CausalASR":
    """Resolve the causal tower: an HF checkpoint directory (config.json +
    safetensors, `qfuxa/qwen3-asr-0.6b-streaming` layout) or random weights
    (``random:<size>`` / no path — CI and zero-egress hosts), on ``device``
    in ``dtype``. ``device=None`` means the card (``default_device``, which
    raises without CUDA).

    Sizes: ``dev-tiny`` (the default), ``uni-moe-2.0-omni``
    (``qm.UNIMOE_2_OMNI``: Uni-MoE-2.0-Omni's published widths, 26.8 B
    parameters drawn on the device in ``dtype``); any other size gets the
    tiny tower under the tiny text tower. A checkpoint directory whose
    config.json has ``model_type`` ``grin_qwen2_vl`` gets its dims from that
    config (``qm.dims_from_grin_qwen2_vl``; an ``audio_config`` there sets
    the tower) and its weights from the directory's safetensors in the
    layout ``qm.convert_hf_state_dict`` reads (not the published
    checkpoint's). A checkpoint's ``audio_config`` may set the tower's
    ``downsample``, ``block_frames`` and ``max_frames``.

    Differs from the JAX loader on purpose: a checkpoint whose text tower
    holds ``self_attn.q_norm.weight`` gets ``qk_norm`` and its q/k norms
    (the JAX loader's dims never set the flag and drop them)."""
    import dataclasses
    import json
    import os

    from ..engine.core import default_device

    device = torch.device(device) if device is not None else default_device()
    path = getattr(config, "qwen3_tower_checkpoint", None) or config.model_path
    window_s = float(getattr(config, "qwen3_window_sec", 15.0) or 15.0)
    stable = getattr(config, "qwen3_stable_iterations", None)
    knobs = dict(
        window_s=window_s,
        hold_back_words=int(getattr(config, "qwen3_hold_back_words", 2)),
        max_new=int(getattr(config, "qwen3_max_new_tokens", 48)),
        context=str(getattr(config, "qwen3_context", "") or ""),
        stable_iterations=None if stable is None else int(stable),
        segment_max_steps=int(getattr(config, "qwen3_segment_max_steps", 200)),
        segment_keep_tail_steps=int(getattr(config, "qwen3_segment_keep_tail_steps", 0)),
        prompt_context_words=int(getattr(config, "qwen3_prompt_context_words", 0)),
    )
    block_frames = int(getattr(config, "qwen3_block_frames", 0) or 0)
    if not block_frames:
        # block duration from chunk_sec (reference qwen3_streaming_chunk_sec):
        # enc frames run at 50/s (block_samples = block_frames * 320 @ 16 kHz)
        chunk_sec = float(getattr(config, "qwen3_chunk_sec", 2.0) or 2.0)
        derived = max(10, int(round(chunk_sec * 50)))
        block_frames = derived if derived != 100 else 0  # 100 = dims default

    if _checkpoint_dir(path):
        with open(os.path.join(path, "config.json")) as f:
            hf_cfg = json.load(f)
        from pathlib import Path

        from ..models.whisper.load import _read_safetensors_dir

        sd = _read_safetensors_dir(Path(path))
        audio_cfg = hf_cfg.get("audio_config", {})
        if hf_cfg.get("model_type") == "grin_qwen2_vl":
            dims = qm.dims_from_grin_qwen2_vl(hf_cfg, audio_cfg)
        else:
            text = lm.dims_from_hf_config(hf_cfg.get("text_config", hf_cfg))
            if qm.has_qk_norm(sd):
                text = dataclasses.replace(text, qk_norm=True)
            tower = {k: audio_cfg[k] for k in ("downsample", "block_frames", "max_frames") if k in audio_cfg}
            dims = qm.Qwen3ASRDims(
                text=text,
                n_mels=audio_cfg.get("num_mel_bins", 128),
                d_audio=audio_cfg.get("d_model", 1024),
                audio_heads=audio_cfg.get("encoder_attention_heads", 16),
                audio_layers=audio_cfg.get("encoder_layers", 24),
                audio_ff=audio_cfg.get("encoder_ffn_dim", 4096),
                **tower,
            )
        if block_frames:
            dims = dataclasses.replace(dims, block_frames=block_frames)
        params = qm.convert_hf_state_dict(sd, dims, dtype=dtype, device=device)
        del sd
        tokenizer = load_hf_word_tokenizer(path, "qwen3")
        return Qwen3CausalASR(params, dims, tokenizer=tokenizer, **knobs)

    size = (path or config.model_size or "").replace("random:", "")
    if size in ("", "dev-tiny", "random"):
        dims = qm.DEV_TINY
    elif size == "uni-moe-2.0-omni":
        dims = qm.UNIMOE_2_OMNI
    else:
        dims = qm.Qwen3ASRDims(text=qm.DEV_TINY_TEXT)
    if block_frames:
        dims = dataclasses.replace(dims, block_frames=block_frames)
    gen = torch.Generator(device=device).manual_seed(RANDOM_WEIGHTS_SEED)
    params = qm.init_params(dims, gen, dtype=dtype, device=device)
    logger.warning("qwen3 causal backend running RANDOM weights (%s)", size or "dev-tiny")
    return Qwen3CausalASR(params, dims, **knobs)


class _HFWordTokenizer:
    """Thin adapter: HF tokenizer → the decode/encode/eos_id surface."""

    def __init__(self, tok):
        self._tok = tok
        self.eos_id = tok.eos_token_id or 0

    def decode(self, ids):
        return self._tok.decode(ids, skip_special_tokens=True)

    def encode(self, text):
        return self._tok.encode(text, add_special_tokens=False)


class StablePrefixCommitter:
    """Commit the agreed prefix of successive hypotheses, holding back the
    frontier words still under revision.

    ``stable_iters`` (reference ``qwen3_streaming_stable_iterations``) is how
    many consecutive PREVIOUS hypotheses a prefix must agree with before it
    commits: 1 = agree with the last hypothesis (the causal default), 2 = the
    last two (the reference's windowed auto), etc."""

    def __init__(self, hold_back: int, stable_iters: int = 1):
        self.hold_back = hold_back
        self.stable_iters = max(1, stable_iters)
        self.history: List[List[str]] = []
        self.n_committed = 0

    def reset(self) -> None:
        self.history = []
        self.n_committed = 0

    def step(self, words: List[str], final: bool = False) -> Tuple[List[str], List[str]]:
        """Returns (newly committed words, uncommitted tail)."""
        if final:
            stable = len(words)
        else:
            # not enough history yet => nothing is stable
            stable = 0
            if len(self.history) >= self.stable_iters:
                stable = len(words)
                for prev in self.history[-self.stable_iters:]:
                    agree = 0
                    for a, b in zip(prev, words):
                        if a != b:
                            break
                        agree += 1
                    stable = min(stable, agree)
            stable = min(stable, max(len(words) - self.hold_back, 0))
        self.history.append(list(words))
        del self.history[: -self.stable_iters]
        new = words[self.n_committed : stable] if stable > self.n_committed else []
        if stable > self.n_committed:
            self.n_committed = stable
        return new, words[self.n_committed :]


class Qwen3CausalProcessor:
    """Per-session online processor (the standard duck-typed contract)."""

    SAMPLING_RATE = 16000

    def __init__(self, holder: Qwen3CausalASR, service=None):
        self.h = holder
        self.dims = holder.dims
        self.service = service          # CausalBatchService: pooled lane mode
        self._lane_token = None         # LaneToken while a pool lane is held
        self.speaker = -1
        self.stream_time = 0.0          # audio-stream clock (insert end times)
        self.time_base = 0.0            # segment start in stream time
        self.audio_buffer = np.zeros(0, np.float32)
        self.committer = StablePrefixCommitter(
            holder.hold_back_words, holder.stable_iterations
        )
        self.buffer_tail: List[str] = []
        self._segment_committed_end = 0.0
        self.n_blocks_encoded = 0       # cumulative; tests pin encode-once
        self._samples_appended = 0      # real (un-padded) samples this segment
        self._needs_prime = True        # caches primed lazily at the first tick
        self.frames_filled = 0
        self.text_pos = len(holder.prompt_ids)
        self.blocks_this_segment = 0
        self._recent_words: List[str] = []  # committed tail for prompt carry
        self._carry_ids: List[int] = []     # context re-primed after a reset
        self._last_hyp_steps = 0            # hypothesis length at the last decode
        if service is not None:
            # async variants discovered by the session's InferenceRunner;
            # the OpBatcher packs concurrent sessions' ops into shared calls
            self.process_iter_async = self._process_iter_async
            self.start_silence_async = self._start_silence_async
            self.finish_async = self._start_silence_async
            self.new_speaker_async = self._new_speaker_async

    # ---- cache lifecycle ---------------------------------------------------

    def _local_prime(self) -> None:
        h = self.h
        B, dev, dtype = 1, h.device, self._dtype()
        self.tower_cache = qm.init_tower_cache(self.dims, B, dtype=dtype, device=dev)
        self.text_cache = lm.init_cache(self.dims.text, B, h.text_cache_len, dtype=dtype, device=dev)
        ids = h.prompt_ids + self._carry_ids
        prompt = torch.tensor([ids], dtype=torch.long, device=dev)
        with torch.no_grad():
            lm.forward(
                h.params.text,
                lm.embed_tokens(h.params.text, prompt),
                torch.zeros(B, dtype=torch.long, device=dev),
                self.text_cache,
                self.dims.text,
                last_only=True,
            )

    async def _ensure_primed(self) -> None:
        if not self._needs_prime:
            return
        if self.service is not None:
            if self._lane_token is None:
                lane = self.service.pools.acquire()
                if lane is None:
                    raise RuntimeError("causal lane pool exhausted")
                from .qwen3_batch import LaneToken

                self._lane_token = LaneToken(lane)
            await self.service.prime(self._lane_token, self._carry_ids)
        else:
            self._local_prime()
        self.text_pos = len(self.h.prompt_ids) + len(self._carry_ids)
        self._needs_prime = False

    def _dtype(self):
        return self.h.params.dtype

    def _segment_reset(self, keep_tail_steps: int = 0) -> None:
        """Drop the audio window + caches (re-primed lazily at the next
        tick); text continuity lives in the committed transcript (constant
        memory for unbounded streams).

        ``prompt_context_words`` committed words — plus ``keep_tail_steps``
        extra on a forced (max-steps) flush — are tokenized and carried into
        the next segment's prompt at the lazy re-prime, bounded by the fixed
        ``ctx_budget`` so pooled lanes share one prime call shape."""
        h = self.h
        self.time_base = self._appended_time()
        self.committer.reset()
        self.buffer_tail = []
        self._samples_appended = 0
        self.frames_filled = 0
        self.blocks_this_segment = 0
        carry_n = max(h.prompt_context_words, keep_tail_steps)
        if carry_n and h.ctx_budget and self._recent_words:
            text = " ".join(self._recent_words[-carry_n:])
            self._carry_ids = h.tokenizer.encode(text)[-h.ctx_budget:]
        else:
            self._carry_ids = []
        self.text_pos = len(h.prompt_ids) + len(self._carry_ids)
        self._needs_prime = True

    # ---- contract: audio in ---------------------------------------------------

    def insert_audio_chunk(self, audio: np.ndarray, end_time: float) -> None:
        self.audio_buffer = np.concatenate([self.audio_buffer, np.asarray(audio, np.float32)])
        self.stream_time = end_time

    def _appended_time(self) -> float:
        """Audio-clock time of the encoded frontier: REAL samples, so the
        zero-pad on a final partial block never overshoots the stream clock."""
        return self.time_base + self._samples_appended / self.SAMPLING_RATE

    # ---- contract: the tick ----------------------------------------------------

    def process_iter(self, is_last: bool = False) -> Tuple[List[ASRToken], float]:
        """Sync entry (local caches). The shared tick is an async coroutine
        whose ops never actually suspend in local mode, so one send() drives
        it to completion — the pooled path awaits the same coroutine."""
        coro = self._tick(is_last)
        try:
            coro.send(None)
        except StopIteration as done:
            return done.value
        coro.close()
        raise RuntimeError(
            "pooled causal session must run through process_iter_async"
        )

    async def _process_iter_async(self, is_last: bool = False):
        return await self._tick(is_last)

    async def _start_silence_async(self):
        return await self._tick(True)

    async def _tick(self, is_last: bool) -> Tuple[List[ASRToken], float]:
        bs = self.dims.block_samples
        has_blocks = len(self.audio_buffer) >= bs or (
            is_last and len(self.audio_buffer) > 0
        )
        if not has_blocks and (not is_last or self.blocks_this_segment == 0):
            pending = getattr(self, "_pending_overflow_tokens", []) or []
            self._pending_overflow_tokens = []
            return pending, self._appended_time()
        await self._ensure_primed()

        while len(self.audio_buffer) >= bs or (is_last and len(self.audio_buffer) > 0):
            block = self.audio_buffer[:bs]
            self.audio_buffer = self.audio_buffer[bs:]
            real = len(block)
            if real < bs:  # is_last: zero-pad the final partial block
                block = np.pad(block, (0, bs - real))
            if (self.frames_filled + self.dims.block_frames > self.dims.max_frames
                    or self._window_full()):
                await self._flush_segment()
                await self._ensure_primed()
            await self._op_append(block)
            self._samples_appended += real

        processed = self._appended_time()
        words = await self._op_decode_words()
        # a sentence boundary lets the window drop everything behind it —
        # but only after committing the whole hypothesis (the held-back
        # frontier words' audio is gone after the reset)
        sentence_done = (
            not is_last
            and self.blocks_this_segment > 1
            and any(_has_punct(w) for w in words)
        )
        # a runaway hypothesis (no sentence boundary for segment_max_steps
        # decode steps) forces the same flush, optionally carrying the
        # hypothesis tail into the next segment's prompt
        steps_exhausted = (
            not is_last
            and not sentence_done
            and self._last_hyp_steps >= self.h.segment_max_steps
        )
        new_words, tail = self.committer.step(
            words, final=is_last or sentence_done or steps_exhausted
        )
        self.buffer_tail = tail
        if new_words:
            self._recent_words.extend(new_words)
            del self._recent_words[: -max(self.h.prompt_context_words,
                                          self.h.segment_keep_tail_steps, 1)]
        tokens = self._timestamp(new_words, processed)
        if sentence_done:
            self._segment_reset()
        elif steps_exhausted:
            self._segment_reset(keep_tail_steps=self.h.segment_keep_tail_steps)
        return tokens, processed

    def _window_full(self) -> bool:
        return (
            self.blocks_this_segment * self.dims.block_samples / self.SAMPLING_RATE
            >= self.h.window_s
        )

    async def _flush_segment(self) -> None:
        """Window overflow between sentences: commit what we have, reset."""
        words = await self._op_decode_words()
        new_words, _ = self.committer.step(words, final=True)
        if new_words:
            self._recent_words.extend(new_words)
            del self._recent_words[: -max(self.h.prompt_context_words,
                                          self.h.segment_keep_tail_steps, 1)]
        self._pending_overflow_tokens = self._timestamp(new_words, self._appended_time())
        self._segment_reset(keep_tail_steps=self.h.segment_keep_tail_steps)

    async def _op_append(self, block: np.ndarray) -> None:
        if self.service is not None:
            await self.service.append(
                self._lane_token, block, self.frames_filled, self.text_pos
            )
        else:
            dev = self.h.device
            mel = log_mel_spectrogram(torch.from_numpy(block).to(dev), n_mels=self.dims.n_mels)
            qm.append_audio_block(
                self.h.params,
                mel[None],
                self.tower_cache,
                self.text_cache,
                torch.tensor([self.frames_filled], dtype=torch.long, device=dev),
                torch.tensor([self.text_pos], dtype=torch.long, device=dev),
                self.dims,
            )
        self.frames_filled += self.dims.block_frames
        self.text_pos += self.dims.block_tokens
        self.blocks_this_segment += 1
        self.n_blocks_encoded += 1

    async def _op_decode_words(self) -> List[str]:
        h = self.h
        if self.service is not None:
            ids = await self.service.decode(self._lane_token, self.text_pos)
        else:
            dev = h.device
            toks, n, _ = qm.decode_hypothesis(
                h.params, self.text_cache,
                torch.tensor([h.hyp_start_ids], dtype=torch.long, device=dev),
                torch.tensor([self.text_pos], dtype=torch.long, device=dev),
                h.eos_id, self.dims, max_new=h.max_new,
            )
            ids = toks[0, : int(n[0])].tolist()
        self._last_hyp_steps = len(ids)
        text = h.tokenizer.decode(ids)
        return text.split()

    def close(self) -> None:
        if self.service is not None and self._lane_token is not None:
            # mark dead FIRST: ops still queued for this session execute
            # against the scratch row, never a re-acquired lane
            self._lane_token.alive = False
            self.service.pools.release(self._lane_token.lane)
            self._lane_token = None

    @property
    def lane(self) -> Optional[int]:
        return self._lane_token.lane if self._lane_token else None

    def _timestamp(self, words: List[str], upto: float) -> List[ASRToken]:
        """Linear interpolation across the span since the last commit —
        ~1 s estimates, same class of precision as the reference."""
        out: List[ASRToken] = []
        if not words:
            # collect any overflow-flush tokens produced mid-tick
            out = getattr(self, "_pending_overflow_tokens", [])
            self._pending_overflow_tokens = []
            return out
        span_start = max(self._segment_committed_end, self.time_base)
        span_end = max(upto, span_start + 0.02 * len(words))
        step = (span_end - span_start) / len(words)
        for i, w in enumerate(words):
            out.append(
                ASRToken(
                    start=round(span_start + i * step, 2),
                    end=round(span_start + (i + 1) * step, 2),
                    text=" " + w,
                    speaker=self.speaker,
                )
            )
        self._segment_committed_end = span_end
        pending = getattr(self, "_pending_overflow_tokens", [])
        self._pending_overflow_tokens = []
        return pending + out

    # ---- contract: events -----------------------------------------------------

    def get_buffer(self) -> Transcript:
        if not self.buffer_tail:
            return Transcript(None, None, "")
        return Transcript(
            start=self._segment_committed_end,
            end=self._appended_time(),
            text=" ".join(self.buffer_tail),
        )

    def start_silence(self):
        return self.process_iter(is_last=True)

    def end_silence(self, duration: float, offset: float) -> None:
        self.stream_time += duration
        if duration < MIN_DURATION_REAL_SILENCE:
            gap = int(self.SAMPLING_RATE * duration)
            if gap > 0:
                self.audio_buffer = np.concatenate(
                    [self.audio_buffer, np.zeros(gap, np.float32)]
                )
        else:
            self.audio_buffer = np.zeros(0, np.float32)
            self._segment_reset()
            self.time_base = duration + offset
            self._segment_committed_end = self.time_base

    async def _new_speaker_async(self, change: ChangeSpeaker):
        """Pooled path: flush the frontier BEFORE the reset (the sync entry
        cannot await; the worker discovers this variant and publishes the
        returned tokens)."""
        tokens, _ = await self._tick(True)
        self._reset_for_speaker(change)
        return tokens

    def new_speaker(self, change: ChangeSpeaker):
        tokens: List[ASRToken] = []
        if self.service is None:
            tokens, _ = self.process_iter(is_last=True)
        self._reset_for_speaker(change)
        return tokens

    def _reset_for_speaker(self, change: ChangeSpeaker) -> None:
        self.audio_buffer = np.zeros(0, np.float32)
        self._segment_reset()
        self.speaker = change.speaker
        self.time_base = change.start
        self._segment_committed_end = change.start

    def finish(self) -> Tuple[List[ASRToken], float]:
        return self.process_iter(is_last=True)

    def warmup(self, audio: np.ndarray) -> None:
        """is_last pads a partial block, so even sub-block warmup audio runs
        the full append + decode path (fail-loud at startup)."""
        self.insert_audio_chunk(audio, len(audio) / self.SAMPLING_RATE)
        self.process_iter(is_last=True)
