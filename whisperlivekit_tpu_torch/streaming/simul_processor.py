"""SimulStreaming per-session online processor (policy wrapper + guards).

Implements the duck-typed online-processor contract consumed by the session
pipeline (reference audio_processor.py:492-615): ``insert_audio_chunk``,
``process_iter(is_last) -> (tokens, processed_upto)``, ``get_buffer``,
``start_silence``, ``end_silence``, ``new_speaker``, ``warmup``.

Output stability guards are reference parity (simul_whisper/backend.py:39-287):
stale/rewound-token filtering against the committed watermark, repetition-loop
detection over recent words, and full-segment reset on unstable output.

Port of whisperlivekit_tpu/streaming/simul_processor.py: host logic, copied
intact apart from the imports.
"""

from __future__ import annotations

import logging
import re
from typing import List, Tuple

import numpy as np

from ..timed import ASRToken, ChangeSpeaker, Transcript
from ..engine.trace import TRACER
from .alignatt import AlignAttEngine, AlignAttSession

logger = logging.getLogger(__name__)

MIN_DURATION_REAL_SILENCE = 5.0  # seconds (reference audio_processor.py:26)
_WORD_RE = re.compile(r"\w+", re.UNICODE)


class SimulStreamingOnlineProcessor:
    SAMPLING_RATE = 16000
    _COMMITTED_EPSILON = 0.05
    _INTRA_BATCH_REWIND_SECONDS = 0.75
    _REWIND_RESET_SECONDS = 1.0
    _RECENT_WORD_HISTORY = 80
    _MIN_REPETITION_WORDS = 12

    def __init__(self, engine: AlignAttEngine, tokenizer=None, scheduler=None):
        self.engine = engine
        self.model = AlignAttSession(engine, tokenizer=tokenizer)
        self.scheduler = scheduler  # BatchScheduler | None: batched device ticks
        if scheduler is not None and getattr(scheduler, "pool", None) is not None:
            self.model.pool = scheduler.pool
        if scheduler is not None and getattr(scheduler, "enc_pool", None) is not None:
            self.model.enc_pool = scheduler.enc_pool
        if scheduler is not None and getattr(scheduler, "xkv", None) is not None:
            self.model.xkv_alloc = scheduler.xkv
        beam_mode = engine.cfg.decoder_type == "beam" and engine.cfg.beam_size > 1
        if scheduler is not None and not beam_mode:
            # async variants are discovered by AudioProcessor._infer via the
            # "<name>_async" convention; only exposed when batching is on
            # (the packed tick is greedy; beam sessions run solo ticks).
            self.process_iter_async = self._process_iter_async
            self.start_silence_async = self._start_silence_async
            self.finish_async = self._start_silence_async
        self.end = 0.0
        self.buffer: List[ASRToken] = []
        self._last_committed_end = 0.0
        self._recent_words: List[str] = []

    # ---- audio ingress ---------------------------------------------------

    def insert_audio_chunk(self, audio: np.ndarray, audio_stream_end_time: float) -> None:
        self.end = audio_stream_end_time
        self.model.insert_audio(np.asarray(audio, np.float32))

    # ---- silence / speaker events -----------------------------------------

    def start_silence(self):
        return self.process_iter(is_last=True)

    def end_silence(self, silence_duration: float, offset: float) -> None:
        self.end += silence_duration
        if silence_duration < MIN_DURATION_REAL_SILENCE:
            gap = int(self.SAMPLING_RATE * silence_duration)
            if gap > 0:
                self.model.insert_audio(np.zeros(gap, np.float32))
        else:
            self.model.refresh_segment(complete=True)
            self.model.global_time_offset = silence_duration + offset
            self._last_committed_end = max(
                self._last_committed_end, self.model.global_time_offset
            )
            self._recent_words = []

    def new_speaker(self, change: ChangeSpeaker) -> None:
        self.process_iter(is_last=True)
        self.model.refresh_segment(complete=True)
        self.model.speaker = change.speaker
        self.model.global_time_offset = change.start
        self._last_committed_end = max(self._last_committed_end, change.start)
        self._recent_words = []

    # ---- buffer view -----------------------------------------------------

    def get_buffer(self) -> Transcript:
        return Transcript.from_tokens(tokens=self.buffer, sep="")

    # ---- guards ------------------------------------------------------------

    @staticmethod
    def _words_from_tokens(tokens: List[ASRToken]) -> List[str]:
        words: List[str] = []
        for token in tokens:
            words.extend(_WORD_RE.findall((token.text or "").casefold()))
        return words

    @classmethod
    def _has_repetition_loop(cls, words: List[str]) -> bool:
        if len(words) < cls._MIN_REPETITION_WORDS:
            return False
        # long single-word run
        run = 1
        for prev, cur in zip(words, words[1:]):
            run = run + 1 if cur == prev else 1
            if run >= 8:
                return True
        # tail n-gram repeated ≥3 times
        max_ngram = min(8, len(words) // 2)
        for size in range(2, max_ngram + 1):
            reps = 1
            cursor = len(words)
            while cursor - 2 * size >= 0:
                if words[cursor - size : cursor] != words[cursor - 2 * size : cursor - size]:
                    break
                reps += 1
                cursor -= size
            if reps >= 3 and reps * size >= cls._MIN_REPETITION_WORDS:
                return True
        # dominant n-gram coverage
        for size in range(2, max_ngram + 1):
            counts: dict = {}
            for i in range(len(words) - size + 1):
                g = tuple(words[i : i + size])
                counts[g] = counts.get(g, 0) + 1
            if not counts:
                continue
            top = max(counts.values())
            if (
                top >= 4
                and top * size >= cls._MIN_REPETITION_WORDS
                and top * size / len(words) >= 0.55
            ):
                return True
        return False

    def _filter_stable_words(self, tokens: List[ASRToken]) -> List[ASRToken]:
        stable: List[ASRToken] = []
        last_end = self._last_committed_end
        last_start = self._last_committed_end
        for token in tokens:
            t_start = float(token.start or 0.0)
            t_end = float(token.end or t_start)
            if t_end < t_start:
                continue
            if t_end <= self._last_committed_end + self._COMMITTED_EPSILON:
                continue
            if stable and last_end - t_end > self._INTRA_BATCH_REWIND_SECONDS:
                continue
            # attention frames are not strictly ordered; clamp starts
            # monotonically so any display span over a committed run keeps
            # start <= end (line = [first.start, last.end])
            if t_start < last_start:
                t_start = last_start
                t_end = max(t_end, t_start)
                token = ASRToken(
                    start=round(t_start, 2), end=round(t_end, 2), text=token.text,
                    speaker=token.speaker, detected_language=token.detected_language,
                    probability=token.probability,
                )
            stable.append(token)
            last_end = max(last_end, t_end)
            last_start = max(last_start, t_start)
        return stable

    def _reset_after_unstable_output(self, reason: str) -> None:
        logger.warning("[SimulStreaming guard] %s; resetting current segment", reason)
        self.model.refresh_segment(complete=True)
        self.model.global_time_offset = max(self._last_committed_end, self.end)
        self.buffer = []
        self._recent_words = []

    def _remember_committed_words(self, tokens: List[ASRToken]) -> None:
        words = self._words_from_tokens(tokens)
        if words:
            self._recent_words.extend(words)
            self._recent_words = self._recent_words[-self._RECENT_WORD_HISTORY :]

    # ---- main tick -----------------------------------------------------------

    # final-flush drain bound: ticks whose decode exhausted the per-tick
    # step budget (STOP_CAP) keep their tokens and continue — mid-stream the
    # next 1 s tick picks up naturally, but is_last is the LAST tick, so it
    # re-ticks here until the gate/EOT stops it (the reference instead gives
    # one infer a ~50-token cap, reference align_att_base.py:206-214; the
    # batched engine keeps per-tick budgets small to bound a looping lane's
    # group tax and drains flushes in this loop)
    _FINAL_DRAIN_TICKS = 8

    def process_iter(self, is_last: bool = False) -> Tuple[List[ASRToken], float]:
        try:
            timestamped_words = self.model.infer(is_last=is_last)
            if is_last:
                from .alignatt import STOP_CAP

                for _ in range(self._FINAL_DRAIN_TICKS):
                    if getattr(self.model, "last_stop_reason", None) != STOP_CAP:
                        break
                    timestamped_words += self.model.infer(is_last=True)
        except Exception:
            logger.exception("SimulStreaming processing error")
            return [], self.end
        return self._postprocess(timestamped_words)

    async def _process_iter_async(self, is_last: bool = False) -> Tuple[List[ASRToken], float]:
        """Scheduler path: this session's tick joins the packed device batch."""
        try:
            ti = self._traced_prepare(is_last)
            if ti is None:
                return [], self.end
            timestamped_words = await self.scheduler.submit(self.model, ti)
            if is_last:
                from .alignatt import STOP_CAP

                for _ in range(self._FINAL_DRAIN_TICKS):
                    if getattr(self.model, "last_stop_reason", None) != STOP_CAP:
                        break
                    ti = self._traced_prepare(True)
                    if ti is None:
                        break
                    timestamped_words += await self.scheduler.submit(self.model, ti)
        except Exception:
            logger.exception("SimulStreaming scheduled tick error")
            return [], self.end
        return self._postprocess(timestamped_words)

    def _traced_prepare(self, is_last: bool):
        with TRACER.span("session.prepare", lanes=1, sid=id(self.model)):
            return self.model.prepare_tick(is_last)

    async def _start_silence_async(self) -> Tuple[List[ASRToken], float]:
        return await self._process_iter_async(is_last=True)

    def _postprocess(self, timestamped_words: List[ASRToken]) -> Tuple[List[ASRToken], float]:
        try:
            if not timestamped_words:
                return [], self.end

            if (
                self.engine.cfg.language == "auto"
                and timestamped_words[0].detected_language is None
            ):
                self.buffer.extend(timestamped_words)
                return [], self.end

            stable = self._filter_stable_words(timestamped_words)
            if not stable:
                max_end = max(float(t.end or 0.0) for t in timestamped_words)
                if self._last_committed_end - max_end > self._REWIND_RESET_SECONDS:
                    self._reset_after_unstable_output(
                        f"all emitted words rewound behind committed time "
                        f"{self._last_committed_end:.2f}s"
                    )
                self.buffer = []
                return [], self.end

            loop_words = self._recent_words + self._words_from_tokens(stable)
            if self._has_repetition_loop(loop_words):
                self._reset_after_unstable_output("repetition loop detected")
                return [], self.end

            self.buffer = []
            self._last_committed_end = max(
                self._last_committed_end, max(float(t.end or 0.0) for t in stable)
            )
            self._remember_committed_words(stable)
            return stable, self.end
        except Exception:
            logger.exception("SimulStreaming processing error")
            return [], self.end

    def finish(self) -> Tuple[List[ASRToken], float]:
        return self.process_iter(is_last=True)

    def close(self) -> None:
        """Release shared resources (audio-pool lane)."""
        self.model.release_pool_lane()

    def warmup(self, audio: np.ndarray, init_prompt: str = "") -> None:
        self.model.insert_audio(np.asarray(audio, np.float32))
        self.model.infer(True)
        self.model.refresh_segment(complete=True)
