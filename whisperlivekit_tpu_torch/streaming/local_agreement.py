"""LocalAgreement (WhisperStreaming) policy.

Behavioral parity with reference local_agreement/online_asr.py:11-425:
HypothesisBuffer commits the longest common prefix between successive
hypotheses (LocalAgreement-2), with n-gram dedup against the committed tail
and an optional high-confidence fast path; OnlineASRProcessor re-transcribes
the rolling audio buffer each tick and trims it at sentence/segment
boundaries. The batch backend is the port's transcribe() pipeline
(decoding/transcribe.py) on the model's device.

Port of whisperlivekit_tpu/streaming/local_agreement.py: the policy classes
are copies; the backend ``TorchWhisperASR`` is the JAX module's
``JAXWhisperASR``.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..timed import ASRToken, ChangeSpeaker, Sentence, Transcript

logger = logging.getLogger(__name__)


class HypothesisBuffer:
    """LocalAgreement-2 commit buffer (reference online_asr.py:11-94)."""

    def __init__(self, confidence_validation: bool = False):
        self.confidence_validation = confidence_validation
        self.committed_in_buffer: List[ASRToken] = []
        self.buffer: List[ASRToken] = []
        self.new: List[ASRToken] = []
        self.last_committed_time = 0.0
        self.last_committed_word: Optional[str] = None

    def insert(self, new_tokens: List[ASRToken], offset: float) -> None:
        new_tokens = [t.with_offset(offset) for t in new_tokens]
        self.new = [t for t in new_tokens if t.start > self.last_committed_time - 0.1]

        if self.new:
            first = self.new[0]
            if abs(first.start - self.last_committed_time) < 1 and self.committed_in_buffer:
                max_ngram = min(len(self.committed_in_buffer), len(self.new), 5)
                for i in range(1, max_ngram + 1):
                    committed_ngram = " ".join(
                        t.text for t in self.committed_in_buffer[-i:]
                    )
                    new_ngram = " ".join(t.text for t in self.new[:i])
                    if committed_ngram == new_ngram:
                        for _ in range(i):
                            self.new.pop(0)
                        break

    def flush(self) -> List[ASRToken]:
        committed: List[ASRToken] = []
        while self.new:
            cur = self.new[0]
            if (
                self.confidence_validation
                and cur.probability
                and cur.probability > 0.95
            ):
                committed.append(cur)
                self.last_committed_word = cur.text
                self.last_committed_time = cur.end
                self.new.pop(0)
                if self.buffer:
                    self.buffer.pop(0)
            elif not self.buffer:
                break
            elif cur.text == self.buffer[0].text:
                committed.append(cur)
                self.last_committed_word = cur.text
                self.last_committed_time = cur.end
                self.buffer.pop(0)
                self.new.pop(0)
            else:
                break
        self.buffer = self.new
        self.new = []
        self.committed_in_buffer.extend(committed)
        return committed

    def pop_committed(self, time: float) -> None:
        while self.committed_in_buffer and self.committed_in_buffer[0].end <= time:
            self.committed_in_buffer.pop(0)


class OnlineASRProcessor:
    """Windowed re-transcription with stable-prefix commits
    (reference online_asr.py:97-425)."""

    SAMPLING_RATE = 16000

    def __init__(self, asr):
        self.asr = asr
        self.tokenize: Optional[Callable] = getattr(asr, "tokenizer", None)
        self.confidence_validation = getattr(asr, "confidence_validation", False)
        self.global_time_offset = 0.0
        self.buffer_trimming_way = getattr(asr, "buffer_trimming", "segment")
        self.buffer_trimming_sec = getattr(asr, "buffer_trimming_sec", 15.0)
        if self.buffer_trimming_way not in ("sentence", "segment"):
            raise ValueError("buffer_trimming must be 'sentence' or 'segment'")
        if self.buffer_trimming_sec <= 0:
            raise ValueError("buffer_trimming_sec must be positive")
        self.init()

    def init(self, offset: Optional[float] = None) -> None:
        self.audio_buffer = np.array([], dtype=np.float32)
        self.transcript_buffer = HypothesisBuffer(self.confidence_validation)
        self.buffer_time_offset = offset if offset is not None else 0.0
        self.transcript_buffer.last_committed_time = self.buffer_time_offset
        self.committed: List[ASRToken] = []
        self.time_of_last_asr_output = 0.0

    # ---- pipeline contract ----------------------------------------------------

    def get_audio_buffer_end_time(self) -> float:
        return self.buffer_time_offset + len(self.audio_buffer) / self.SAMPLING_RATE

    def insert_audio_chunk(self, audio: np.ndarray, audio_stream_end_time=None) -> None:
        self.audio_buffer = np.append(self.audio_buffer, audio)

    def start_silence(self):
        if self.audio_buffer.size == 0:
            return [], self.get_audio_buffer_end_time()
        return self.process_iter()

    def end_silence(self, silence_duration: Optional[float], offset: float) -> None:
        if not silence_duration or silence_duration <= 0:
            return
        if silence_duration < 5:
            gap = int(self.SAMPLING_RATE * silence_duration)
            if gap > 0:
                self.insert_audio_chunk(np.zeros(gap, np.float32))
        else:
            self.init(offset=silence_duration + offset)
        self.global_time_offset += silence_duration

    def new_speaker(self, change: ChangeSpeaker) -> None:
        self.process_iter()
        self.init(offset=change.start)

    def get_buffer(self) -> Transcript:
        return self.concatenate_tokens(self.transcript_buffer.buffer)

    # ---- prompt ---------------------------------------------------------------

    def prompt(self) -> Tuple[str, str]:
        k = len(self.committed)
        while k > 0 and self.committed[k - 1].end > self.buffer_time_offset:
            k -= 1
        prompt_tokens = self.committed[:k]
        words = [t.text for t in prompt_tokens]
        chosen: List[str] = []
        length = 0
        while words and length < 200:
            w = words.pop(-1)
            length += len(w) + 1
            chosen.append(w)
        context = self.asr.sep.join(t.text for t in self.committed[k:])
        return self.asr.sep.join(chosen[::-1]), context

    # ---- main tick --------------------------------------------------------------

    def process_iter(self) -> Tuple[List[ASRToken], float]:
        processed_upto = self.get_audio_buffer_end_time()
        prompt_text, _ = self.prompt()
        res = self.asr.transcribe(self.audio_buffer, init_prompt=prompt_text)
        tokens = self.asr.ts_words(res)
        self.transcript_buffer.insert(tokens, self.buffer_time_offset)
        committed_tokens = self.transcript_buffer.flush()
        self.committed.extend(committed_tokens)

        if committed_tokens:
            self.time_of_last_asr_output = self.committed[-1].end

        buffer_duration = len(self.audio_buffer) / self.SAMPLING_RATE
        if not committed_tokens and buffer_duration > self.buffer_trimming_sec:
            since = self.get_audio_buffer_end_time() - self.time_of_last_asr_output
            if since > self.buffer_trimming_sec:
                logger.warning(
                    "No ASR output for %.2fs; resetting buffer to prevent freezing",
                    since,
                )
                self.init(offset=self.get_audio_buffer_end_time())
                return [], processed_upto

        if committed_tokens and self.buffer_trimming_way == "sentence":
            if buffer_duration > self.buffer_trimming_sec:
                self.chunk_completed_sentence()

        s = self.buffer_trimming_sec if self.buffer_trimming_way == "segment" else 30
        if len(self.audio_buffer) / self.SAMPLING_RATE > s:
            self.chunk_completed_segment(res)
        return committed_tokens, processed_upto

    # ---- trimming ----------------------------------------------------------------

    def chunk_completed_sentence(self) -> None:
        buffer_duration = len(self.audio_buffer) / self.SAMPLING_RATE
        if not self.committed:
            if buffer_duration > self.buffer_trimming_sec:
                self.chunk_at(self.buffer_time_offset + buffer_duration / 2)
            return
        sentences = self.words_to_sentences(self.committed)
        chunk_done = False
        if len(sentences) >= 2:
            while len(sentences) > 2:
                sentences.pop(0)
            self.chunk_at(sentences[-2].end)
            chunk_done = True
        if not chunk_done and buffer_duration > self.buffer_trimming_sec:
            self.chunk_at(self.committed[-1].end)

    def chunk_completed_segment(self, res) -> None:
        buffer_duration = len(self.audio_buffer) / self.SAMPLING_RATE
        if not self.committed:
            if buffer_duration > self.buffer_trimming_sec:
                self.chunk_at(self.buffer_time_offset + buffer_duration / 2)
            return
        ends = self.asr.segments_end_ts(res)
        last_committed_time = self.committed[-1].end
        chunk_done = False
        if len(ends) > 1:
            e = ends[-2] + self.buffer_time_offset
            while len(ends) > 2 and e > last_committed_time:
                ends.pop(-1)
                e = ends[-2] + self.buffer_time_offset
            if e <= last_committed_time:
                self.chunk_at(e)
                chunk_done = True
        if not chunk_done and buffer_duration > self.buffer_trimming_sec:
            self.chunk_at(last_committed_time)

    def chunk_at(self, time: float) -> None:
        self.transcript_buffer.pop_committed(time)
        cut = time - self.buffer_time_offset
        self.audio_buffer = self.audio_buffer[int(cut * self.SAMPLING_RATE) :]
        self.buffer_time_offset = time

    def words_to_sentences(self, tokens: List[ASRToken]) -> List[Sentence]:
        if not tokens:
            return []
        full_text = " ".join(t.text for t in tokens)
        if self.tokenize:
            try:
                sentence_texts = self.tokenize(full_text)
            except Exception:
                sentence_texts = self.tokenize([full_text])
        else:
            sentence_texts = [full_text]

        sentences: List[Sentence] = []
        idx = 0
        for sent_text in sentence_texts:
            sent_text = sent_text.strip()
            if not sent_text:
                continue
            sent_tokens = []
            accumulated = ""
            while idx < len(tokens) and len(accumulated) < len(sent_text):
                t = tokens[idx]
                accumulated = (accumulated + " " + t.text).strip() if accumulated else t.text
                sent_tokens.append(t)
                idx += 1
            if sent_tokens:
                sentences.append(
                    Sentence(
                        start=sent_tokens[0].start,
                        end=sent_tokens[-1].end,
                        text=" ".join(t.text for t in sent_tokens),
                    )
                )
        return sentences

    def finish(self) -> Tuple[List[ASRToken], float]:
        remaining = self.transcript_buffer.buffer
        final_upto = self.buffer_time_offset + len(self.audio_buffer) / self.SAMPLING_RATE
        self.buffer_time_offset = final_upto
        return remaining, final_upto

    def concatenate_tokens(self, tokens, sep=None, offset: float = 0) -> Transcript:
        sep = sep if sep is not None else self.asr.sep
        text = sep.join(t.text for t in tokens)
        if tokens:
            return Transcript(offset + tokens[0].start, offset + tokens[-1].end, text)
        return Transcript(None, None, text)


class TorchWhisperASR:
    """Batch backend for LocalAgreement on the port's transcribe() pipeline
    (role of reference local_agreement/backends.py WhisperASR; the JAX
    package's ``JAXWhisperASR``). One backend serves every session of an
    engine; each session calls ``transcribe`` from its own worker thread.
    One re-entrant lock, ``_session_lock``, orders the calls: they run one
    at a time (eager decode loops in several threads at once hand the
    interpreter lock around at every launch and convoy), and a
    ``SessionASRProxy``, which takes the same lock to swap
    ``original_language`` around its call, is never seen by another
    session's call (in the JAX package a default-language call made during
    a proxied one reads the proxy's language)."""

    sep = " "

    def __init__(
        self,
        decoder,
        language: Optional[str] = None,
        model_name: Optional[str] = None,
        buffer_trimming: str = "segment",
        buffer_trimming_sec: float = 15.0,
        confidence_validation: bool = False,
        beam_size: Optional[int] = None,
        tokenizer: Optional[Callable] = None,
    ):
        self.decoder = decoder
        self.original_language = None if language == "auto" else language
        self.model_name = model_name
        self.buffer_trimming = buffer_trimming
        self.buffer_trimming_sec = buffer_trimming_sec
        self.confidence_validation = confidence_validation
        self.beam_size = beam_size
        self.tokenizer = tokenizer  # optional sentence tokenizer
        self.transcribe_kargs: dict = {}
        self._session_lock = threading.RLock()

    def transcribe(self, audio: np.ndarray, init_prompt: str = "") -> dict:
        from ..decoding.transcribe import transcribe as run

        with self._session_lock:
            return run(
                self.decoder,
                np.asarray(audio, np.float32),
                language=self.original_language,
                initial_prompt=init_prompt or None,
                word_timestamps=True,
                condition_on_previous_text=True,
                model_name=self.model_name,
                beam_size=self.beam_size,
                **self.transcribe_kargs,
            )

    def ts_words(self, res: dict) -> List[ASRToken]:
        tokens: List[ASRToken] = []
        for segment in res["segments"]:
            if segment.get("no_speech_prob", 0.0) > 0.9:
                continue
            for word in segment.get("words", []):
                tokens.append(
                    ASRToken(
                        start=word["start"],
                        end=word["end"],
                        text=word["word"],
                        probability=word.get("probability"),
                    )
                )
        return tokens

    def segments_end_ts(self, res: dict) -> List[float]:
        return [s["end"] for s in res["segments"]]

    def use_vad(self) -> None:
        self.transcribe_kargs["no_speech_threshold"] = 0.6
