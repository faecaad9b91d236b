"""TestHarness: in-process pipeline runner — test infra AND the offline engine.

Reference parity: test_harness.py:95-749. Wraps AudioProcessor without any
server/WebSocket; `feed` at speed 0 (instant) or 1.0 (real-time);
`pause()` injects silence; `cut()` is an abrupt stop; `snapshot_at(t)` reads
history; TestState exposes text/speaker/silence/timing accessors and WER.
The CLI transcribe/run/diagnose subcommands run on this class — test
infrastructure is the offline product surface.

Port of whisperlivekit_tpu/harness/harness.py over the port's engine and
AudioProcessor. ``TestHarness(**kwargs)`` hands its kwargs to the port's
``TranscriptionEngine``: without ``device`` the engine serves on the card
(and raises without CUDA); ``device="cpu"`` is how a test asks for the CPU.
Engines are cached by kwargs in this module's ``_engine_cache``, apart from
the JAX package's.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set

import numpy as np

from ..audio.io import float32_to_s16le, load_audio
from ..timed import FrontData
from .wer import compute_wer

logger = logging.getLogger(__name__)

SAMPLE_RATE = 16000
BYTES_PER_SAMPLE = 2

_engine_cache: Dict[tuple, Any] = {}


def _parse_time(time_str: str) -> float:
    """H:MM:SS.cc → seconds."""
    parts = time_str.split(":")
    h, m = int(parts[0]), int(parts[1])
    s = float(parts[2])
    return h * 3600 + m * 60 + s


def load_audio_pcm(audio_path: str, sample_rate: int = SAMPLE_RATE) -> bytes:
    """Decode any audio file to raw s16le mono PCM bytes."""
    audio = load_audio(audio_path, sample_rate)
    return float32_to_s16le(audio)


@dataclass
class TestState:
    """Observable transcription state at a point in time."""

    lines: List[Dict[str, Any]] = field(default_factory=list)
    buffer_transcription: str = ""
    buffer_diarization: str = ""
    buffer_translation: str = ""
    remaining_time_transcription: float = 0.0
    remaining_time_transcription_processing: float = 0.0
    remaining_time_transcription_policy: float = 0.0
    remaining_time_diarization: float = 0.0
    audio_position: float = 0.0
    status: str = ""
    error: str = ""

    @classmethod
    def from_front_data(cls, fd: FrontData, audio_position: float = 0.0) -> "TestState":
        d = fd.as_dict()
        return cls(
            lines=d.get("lines", []),
            buffer_transcription=d.get("buffer_transcription", ""),
            buffer_diarization=d.get("buffer_diarization", ""),
            buffer_translation=d.get("buffer_translation", ""),
            remaining_time_transcription=d.get("remaining_time_transcription", 0),
            remaining_time_transcription_processing=d.get(
                "remaining_time_transcription_processing", 0
            ),
            remaining_time_transcription_policy=d.get(
                "remaining_time_transcription_policy", 0
            ),
            remaining_time_diarization=d.get("remaining_time_diarization", 0),
            audio_position=audio_position,
            status=d.get("status", ""),
            error=d.get("error", ""),
        )

    # ---- text ----------------------------------------------------------------

    @property
    def speech_lines(self) -> List[Dict[str, Any]]:
        return [ln for ln in self.lines if ln.get("text")]

    @property
    def committed_text(self) -> str:
        return " ".join(ln["text"].strip() for ln in self.speech_lines).strip()

    @property
    def text(self) -> str:
        parts = [self.committed_text]
        if self.buffer_transcription:
            parts.append(self.buffer_transcription.strip())
        return " ".join(p for p in parts if p).strip()

    @property
    def committed_word_count(self) -> int:
        return len(self.committed_text.split())

    @property
    def buffer_word_count(self) -> int:
        return len(self.buffer_transcription.split())

    # ---- speakers --------------------------------------------------------------

    @property
    def speakers(self) -> Set[int]:
        return {ln["speaker"] for ln in self.speech_lines}

    @property
    def n_speakers(self) -> int:
        return len(self.speakers)

    def speaker_at(self, time_s: float) -> Optional[int]:
        ln = self.line_at(time_s)
        return ln["speaker"] if ln else None

    def speakers_in(self, start_s: float, end_s: float) -> Set[int]:
        return {ln["speaker"] for ln in self.lines_between(start_s, end_s) if ln.get("text")}

    @property
    def speaker_timeline(self) -> List[Dict[str, Any]]:
        return [
            {
                "speaker": ln["speaker"],
                "start": _parse_time(ln["start"]),
                "end": _parse_time(ln["end"]),
            }
            for ln in self.speech_lines
        ]

    @property
    def n_speaker_changes(self) -> int:
        timeline = self.speaker_timeline
        return sum(
            1
            for a, b in zip(timeline, timeline[1:])
            if a["speaker"] != b["speaker"]
        )

    # ---- silence ------------------------------------------------------------------

    @property
    def has_silence(self) -> bool:
        return any(ln["speaker"] == -2 for ln in self.lines)

    @property
    def silence_segments(self) -> List[Dict[str, Any]]:
        return [ln for ln in self.lines if ln["speaker"] == -2]

    def silence_at(self, time_s: float) -> bool:
        for ln in self.silence_segments:
            if _parse_time(ln["start"]) <= time_s <= _parse_time(ln["end"]):
                return True
        return False

    # ---- time queries ---------------------------------------------------------------

    def line_at(self, time_s: float) -> Optional[Dict[str, Any]]:
        for ln in self.speech_lines:
            if _parse_time(ln["start"]) <= time_s <= _parse_time(ln["end"]):
                return ln
        return None

    def text_at(self, time_s: float) -> Optional[str]:
        ln = self.line_at(time_s)
        return ln["text"] if ln else None

    def lines_between(self, start_s: float, end_s: float) -> List[Dict[str, Any]]:
        out = []
        for ln in self.lines:
            s, e = _parse_time(ln["start"]), _parse_time(ln["end"])
            if s < end_s and e > start_s:
                out.append(ln)
        return out

    def text_between(self, start_s: float, end_s: float) -> str:
        return " ".join(
            ln["text"].strip() for ln in self.lines_between(start_s, end_s) if ln.get("text")
        ).strip()

    # ---- metrics ---------------------------------------------------------------------

    def wer(self, reference: str, english: bool = False) -> float:
        """``english=True`` applies the OpenAI EnglishTextNormalizer — the
        methodology behind published Whisper WERs (harness/normalizers.py)."""
        return compute_wer(reference, self.text, english=english)["wer"]

    def wer_detailed(self, reference: str, english: bool = False) -> Dict:
        return compute_wer(reference, self.text, english=english)

    # ---- timing invariants -------------------------------------------------------------

    @property
    def timestamps(self) -> List[Dict[str, Any]]:
        return [
            {"start": _parse_time(ln["start"]), "end": _parse_time(ln["end"])}
            for ln in self.lines
        ]

    @property
    def timing_valid(self) -> bool:
        return all(t["start"] <= t["end"] for t in self.timestamps)

    @property
    def timing_monotonic(self) -> bool:
        ts = self.timestamps
        return all(a["start"] <= b["start"] for a, b in zip(ts, ts[1:]))

    @property
    def timing_errors(self) -> List[str]:
        errors = []
        ts = self.timestamps
        for i, t in enumerate(ts):
            if t["start"] > t["end"]:
                errors.append(f"line {i}: start {t['start']} > end {t['end']}")
        for i, (a, b) in enumerate(zip(ts, ts[1:])):
            if a["start"] > b["start"]:
                errors.append(f"lines {i}->{i+1}: starts not monotonic")
        return errors


class AudioPlayer:
    """Timeline control over a PCM byte buffer fed to a harness."""

    def __init__(self, harness: "TestHarness", pcm_data: bytes, sample_rate: int = SAMPLE_RATE):
        self.harness = harness
        self.pcm = pcm_data
        self.sample_rate = sample_rate
        self._offset = 0

    @property
    def position(self) -> float:
        return self._offset / (self.sample_rate * BYTES_PER_SAMPLE)

    @property
    def duration(self) -> float:
        return len(self.pcm) / (self.sample_rate * BYTES_PER_SAMPLE)

    @property
    def remaining(self) -> float:
        return self.duration - self.position

    @property
    def done(self) -> bool:
        return self._offset >= len(self.pcm)

    async def play(self, duration_s: Optional[float] = None, speed: float = 1.0,
                   chunk_duration: float = 0.5) -> None:
        end_offset = len(self.pcm)
        if duration_s is not None:
            end_offset = min(
                end_offset,
                self._offset + int(duration_s * self.sample_rate) * BYTES_PER_SAMPLE,
            )
        chunk_bytes = int(chunk_duration * self.sample_rate * BYTES_PER_SAMPLE)
        while self._offset < end_offset:
            end = min(self._offset + chunk_bytes, end_offset)
            await self.harness._feed_bytes(self.pcm[self._offset : end])
            sent = (end - self._offset) / (self.sample_rate * BYTES_PER_SAMPLE)
            self._offset = end
            if speed > 0:
                await asyncio.sleep(sent / speed)

    async def play_until(self, time_s: float, speed: float = 1.0) -> None:
        await self.play(duration_s=max(0.0, time_s - self.position), speed=speed)

    def seek(self, time_s: float) -> None:
        self._offset = int(time_s * self.sample_rate) * BYTES_PER_SAMPLE

    def reset(self) -> None:
        self._offset = 0


class TestHarness:
    """Async context manager driving one AudioProcessor in-process."""

    def __init__(self, **kwargs: Any):
        kwargs.setdefault("pcm_input", True)
        self._engine_kwargs = kwargs
        self._processor = None
        self._results_gen = None
        self._collect_task: Optional[asyncio.Task] = None
        self._state = TestState()
        self._audio_position = 0.0
        self._history: List[TestState] = []
        self._on_update: Optional[Callable[[TestState], None]] = None

    async def __aenter__(self) -> "TestHarness":
        from ..engine.core import TranscriptionEngine
        from ..session.processor import AudioProcessor

        cache_key = tuple(sorted((k, repr(v)) for k, v in self._engine_kwargs.items()))
        if cache_key not in _engine_cache:
            TranscriptionEngine.reset()
            _engine_cache[cache_key] = TranscriptionEngine(**self._engine_kwargs)
        engine = _engine_cache[cache_key]

        self._processor = AudioProcessor(transcription_engine=engine)
        self._results_gen = await self._processor.create_tasks()
        self._collect_task = asyncio.create_task(self._collect_results())
        return self

    async def __aexit__(self, *exc: Any) -> None:
        if self._processor:
            await self._processor.cleanup()
        if self._collect_task and not self._collect_task.done():
            self._collect_task.cancel()
            try:
                await self._collect_task
            except asyncio.CancelledError:
                pass

    async def _collect_results(self) -> None:
        try:
            async for fd in self._results_gen:
                self._state = TestState.from_front_data(fd, self._audio_position)
                self._history.append(self._state)
                if self._on_update:
                    self._on_update(self._state)
        except asyncio.CancelledError:
            pass
        except Exception as e:
            logger.warning("Result collector ended: %s", e)

    # ---- properties ------------------------------------------------------------

    @property
    def state(self) -> TestState:
        return self._state

    @property
    def history(self) -> List[TestState]:
        return self._history

    @property
    def audio_position(self) -> float:
        return self._audio_position

    @property
    def metrics(self):
        return self._processor.metrics if self._processor else None

    def on_update(self, callback: Callable[[TestState], None]) -> None:
        self._on_update = callback

    def probe(self) -> dict:
        """Pipeline + backend internals (AudioProcessor.probe_internals)."""
        if self._processor is None:
            return {}
        return self._processor.probe_internals()

    def snapshot_at(self, t: float) -> Optional[TestState]:
        """Latest state whose audio position is ≤ t."""
        best = None
        for st in self._history:
            if st.audio_position <= t:
                best = st
        return best

    # ---- feeding --------------------------------------------------------------

    def load_audio(self, source) -> AudioPlayer:
        path = source.path if hasattr(source, "path") else str(source)
        return AudioPlayer(self, load_audio_pcm(path))

    async def _feed_bytes(self, data: bytes) -> None:
        await self._processor.process_audio(data)
        self._audio_position += len(data) / (SAMPLE_RATE * BYTES_PER_SAMPLE)

    async def feed(self, audio_path: str, speed: float = 1.0, chunk_duration: float = 0.5) -> None:
        await self.feed_pcm(load_audio_pcm(audio_path), speed=speed, chunk_duration=chunk_duration)

    async def feed_audio(self, audio: np.ndarray, speed: float = 1.0, chunk_duration: float = 0.5) -> None:
        await self.feed_pcm(float32_to_s16le(audio), speed=speed, chunk_duration=chunk_duration)

    async def feed_pcm(self, pcm_data: bytes, speed: float = 1.0, chunk_duration: float = 0.5) -> None:
        chunk_bytes = int(chunk_duration * SAMPLE_RATE * BYTES_PER_SAMPLE)
        offset = 0
        while offset < len(pcm_data):
            end = min(offset + chunk_bytes, len(pcm_data))
            await self._feed_bytes(pcm_data[offset:end])
            offset = end
            if speed > 0:
                await asyncio.sleep(chunk_duration / speed)

    async def pause(self, duration_s: float, speed: float = 1.0) -> None:
        """Silence injection; > 5 s triggers silence-segment detection."""
        await self.feed_pcm(
            bytes(int(duration_s * SAMPLE_RATE) * BYTES_PER_SAMPLE), speed=speed
        )

    silence = pause

    # ---- waiting ---------------------------------------------------------------

    async def wait_for(
        self,
        predicate: Callable[[TestState], bool],
        timeout: float = 30.0,
        poll_interval: float = 0.1,
    ) -> TestState:
        deadline = asyncio.get_event_loop().time() + timeout
        while asyncio.get_event_loop().time() < deadline:
            if predicate(self._state):
                return self._state
            await asyncio.sleep(poll_interval)
        raise TimeoutError(
            f"Condition not met within {timeout}s. Current state: "
            f"{len(self._state.lines)} lines, "
            f"buffer='{self._state.buffer_transcription[:50]}', "
            f"audio_pos={self._audio_position:.1f}s"
        )

    async def wait_for_text(self, timeout: float = 30.0) -> TestState:
        return await self.wait_for(lambda s: bool(s.text.strip()), timeout=timeout)

    async def wait_for_lines(self, n: int = 1, timeout: float = 30.0) -> TestState:
        return await self.wait_for(lambda s: len(s.speech_lines) >= n, timeout=timeout)

    async def wait_for_silence(self, timeout: float = 30.0) -> TestState:
        return await self.wait_for(lambda s: s.has_silence, timeout=timeout)

    async def wait_for_speakers(self, n: int = 2, timeout: float = 30.0) -> TestState:
        return await self.wait_for(lambda s: s.n_speakers >= n, timeout=timeout)

    async def drain(self, seconds: float = 2.0) -> None:
        await asyncio.sleep(seconds)

    # ---- finishing --------------------------------------------------------------

    async def finish(self, timeout: float = 30.0) -> TestState:
        await self._processor.process_audio(b"")
        if self._collect_task:
            try:
                await asyncio.wait_for(self._collect_task, timeout=timeout)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                logger.warning("Timed out waiting for pipeline flush")
        return self._state

    async def cut(self, timeout: float = 5.0) -> TestState:
        """Abrupt stop: EOF with a short flush window; partial results OK."""
        return await self.finish(timeout=timeout)


def reset_engine_cache() -> None:
    _engine_cache.clear()
    from ..engine.core import TranscriptionEngine

    TranscriptionEngine.reset()
