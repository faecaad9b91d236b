"""Windowed native-streaming policy (the reference's Qwen3 'windowed' mode).

Reference behavior (reference README.md:185-264, qwen3_streaming shims
qwen3_streaming/_shim.py): re-transcribe a bounded left-context window
(≤ ~12 s) on every update; commit the stable prefix but hold back the last N
words (they are still under revision at the window frontier); on sentence
punctuation, reset the window behind the committed text so compute per
second stays constant.

Generalized here over any batch backend (whisper included): it extends
LocalAgreement's commit machinery with a bounded window + word hold-back,
giving a third policy choice ``backend_policy=windowed``.

A copy of whisperlivekit_tpu/streaming/windowed.py.
"""

from __future__ import annotations

import logging
from typing import List, Tuple

from ..timed import ASRToken
from .local_agreement import OnlineASRProcessor

logger = logging.getLogger(__name__)


class WindowedStreamingProcessor(OnlineASRProcessor):
    """Bounded-window re-transcription with word hold-back."""

    def __init__(
        self,
        asr,
        window_sec: float = 12.0,
        hold_back_words: int = 6,
        sentence_reset: bool = True,
        chunk_sec: float = 0.0,
        right_context_ms: int = 0,
        context: str = "",
    ):
        super().__init__(asr)
        self.window_sec = window_sec
        self.hold_back_words = hold_back_words
        self.sentence_reset = sentence_reset
        # reference qwen3_streaming_chunk_sec: re-transcribe only after this
        # much new audio accumulated (0 = every update)
        self.chunk_sec = max(0.0, chunk_sec)
        # reference qwen3_streaming_right_context_ms: the frontier span is
        # lookahead context — tokens inside it never commit this update
        self.right_context_sec = max(0, right_context_ms) / 1000.0
        # reference qwen3_streaming_context: static text prepended to the
        # rolling committed-words prompt
        self.context = context
        self._last_transcribed_upto = 0.0

    def process_iter(self) -> Tuple[List[ASRToken], float]:
        processed_upto = self.get_audio_buffer_end_time()
        if (
            self.chunk_sec
            and processed_upto - self._last_transcribed_upto < self.chunk_sec
        ):
            return [], self._last_transcribed_upto
        self._last_transcribed_upto = processed_upto
        prompt_text, _ = self.prompt()
        if self.context:
            prompt_text = (self.context + " " + (prompt_text or "")).strip()
        res = self.asr.transcribe(self.audio_buffer, init_prompt=prompt_text)
        tokens = self.asr.ts_words(res)

        # time-based frontier hold-back: the last right_context_ms of audio
        # is lookahead only
        if self.right_context_sec > 0:
            buffer_duration = len(self.audio_buffer) / self.SAMPLING_RATE
            cutoff = buffer_duration - self.right_context_sec
            tokens = [t for t in tokens if t.end <= cutoff]

        # hold back the frontier words: they are still under revision
        if self.hold_back_words > 0 and len(tokens) > self.hold_back_words:
            tokens = tokens[: -self.hold_back_words]
        elif self.hold_back_words > 0:
            tokens = []

        self.transcript_buffer.insert(tokens, self.buffer_time_offset)
        committed = self.transcript_buffer.flush()
        self.committed.extend(committed)
        if committed:
            self.time_of_last_asr_output = self.committed[-1].end

        # sentence reset: a committed sentence end lets the window drop
        # everything behind it (constant compute per second)
        if self.sentence_reset and committed:
            for tok in reversed(committed):
                if tok.has_punctuation():
                    self.chunk_at(tok.end)
                    break

        # bounded window: never re-encode more than window_sec
        buffer_duration = len(self.audio_buffer) / self.SAMPLING_RATE
        if buffer_duration > self.window_sec:
            cut_to = self.get_audio_buffer_end_time() - self.window_sec
            last_committed = self.committed[-1].end if self.committed else cut_to
            self.chunk_at(min(cut_to, max(last_committed, self.buffer_time_offset)))

        return committed, processed_upto

    def finish(self) -> Tuple[List[ASRToken], float]:
        """Flush without hold-back: final hypothesis is as good as it gets."""
        prompt_text, _ = self.prompt()
        if self.context:
            prompt_text = (self.context + " " + (prompt_text or "")).strip()
        if len(self.audio_buffer) >= int(0.2 * self.SAMPLING_RATE):
            res = self.asr.transcribe(self.audio_buffer, init_prompt=prompt_text)
            tokens = self.asr.ts_words(res)
            self.transcript_buffer.insert(tokens, self.buffer_time_offset)
            committed = self.transcript_buffer.flush()
            self.committed.extend(committed)
        remaining = self.transcript_buffer.buffer
        final_upto = self.get_audio_buffer_end_time()
        self.buffer_time_offset = final_upto
        return remaining, final_upto
