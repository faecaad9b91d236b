"""Shared timed-data vocabulary used by every layer of the framework.

This is the wire-format-compatible equivalent of the reference's
``whisperlivekit/timed_objects.py`` (ASRToken/Transcript/Silence/SpeakerSegment/
Translation/Segment/FrontData/State, reference timed_objects.py:17-254). The JSON
emitted by :meth:`FrontData.as_dict` and :meth:`Segment.as_dict` matches the
reference server's WebSocket payloads so existing clients keep working.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

# Sentence-final punctuation across latin + CJK scripts; used by the line
# segmentation logic (reference timed_objects.py:4).
PUNCTUATION_MARKS = frozenset({".", "!", "?", "。", "！", "？"})

#: Speaker id used for silence segments on the wire.
SILENCE_SPEAKER = -2
#: Speaker id meaning "no diarization / unattributed".
NO_SPEAKER = -1


def format_time(seconds: float) -> str:
    """Render seconds as ``H:MM:SS.cc`` (centiseconds), reference-compatible."""
    centis = int(round(seconds * 100))
    h, rem = divmod(centis, 360000)
    m, rem = divmod(rem, 6000)
    s, cs = divmod(rem, 100)
    return f"{h}:{m:02d}:{s:02d}.{cs:02d}"


@dataclass
class Timed:
    start: Optional[float] = 0
    end: Optional[float] = 0

    def duration(self) -> float:
        return (self.end or 0.0) - (self.start or 0.0)


@dataclass
class TimedText(Timed):
    text: Optional[str] = ""
    speaker: Optional[int] = NO_SPEAKER
    detected_language: Optional[str] = None

    def has_punctuation(self) -> bool:
        t = (self.text or "").strip()
        return any(ch in PUNCTUATION_MARKS for ch in t)

    def contains_timespan(self, other: "TimedText") -> bool:
        return self.start <= other.start and self.end >= other.end

    def is_within(self, other: "TimedText") -> bool:
        return other.contains_timespan(self)

    def __bool__(self) -> bool:  # empty text == falsy, used by buffer display
        return bool(self.text)

    def __str__(self) -> str:
        return str(self.text)


@dataclass
class ASRToken(TimedText):
    """One committed (or hypothesized) word with timestamps in stream seconds."""

    probability: Optional[float] = None

    def with_offset(self, offset: float) -> "ASRToken":
        return ASRToken(
            start=self.start + offset,
            end=self.end + offset,
            text=self.text,
            speaker=self.speaker,
            detected_language=self.detected_language,
            probability=self.probability,
        )

    def is_silence(self) -> bool:
        return False


@dataclass
class Sentence(TimedText):
    pass


@dataclass
class Transcript(TimedText):
    """A span of concatenated ASR tokens (the unstable hypothesis buffer)."""

    @classmethod
    def from_tokens(
        cls,
        tokens: List[ASRToken],
        sep: Optional[str] = None,
        offset: float = 0,
    ) -> "Transcript":
        joiner = " " if sep is None else sep
        if not tokens:
            return cls(start=None, end=None, text=joiner.join(()))
        return cls(
            start=offset + tokens[0].start,
            end=offset + tokens[-1].end,
            text=joiner.join(t.text for t in tokens),
        )


@dataclass
class SpeakerSegment(Timed):
    """A diarization span: who spoke between start and end (no text)."""

    speaker: Optional[int] = NO_SPEAKER


@dataclass
class Translation(TimedText):
    pass


@dataclass
class HypothesisTail(TimedText):
    """Unstable hypothesis snapshot forwarded to draft-ahead translators only."""

    pass


@dataclass
class Silence:
    start: Optional[float] = None
    end: Optional[float] = None
    duration: Optional[float] = None
    is_starting: bool = False
    has_ended: bool = False

    def compute_duration(self) -> Optional[float]:
        if self.start is None or self.end is None:
            return None
        self.duration = self.end - self.start
        return self.duration

    def is_silence(self) -> bool:
        return True


@dataclass
class ChangeSpeaker:
    speaker: int
    start: float


@dataclass
class Segment(TimedText):
    """Display line: a punctuation-delimited run of tokens or a silence gap."""

    tokens: Optional[List[ASRToken]] = None
    translation: Optional[Any] = None

    @classmethod
    def from_tokens(
        cls,
        tokens: List[Union[ASRToken, Silence]],
        is_silence: bool = False,
    ) -> Optional["Segment"]:
        if not tokens:
            return None
        first, last = tokens[0], tokens[-1]
        if is_silence:
            return cls(start=first.start, end=last.end, text=None, speaker=SILENCE_SPEAKER)
        return cls(
            start=first.start,
            end=last.end,
            text="".join(t.text for t in tokens),
            speaker=NO_SPEAKER,
            detected_language=first.detected_language,
        )

    def is_silence(self) -> bool:
        return self.speaker == SILENCE_SPEAKER

    def as_dict(self) -> Dict[str, Any]:
        # Wire format identical to reference Segment.to_dict
        # (timed_objects.py:168-183): unattributed speaker renders as 1.
        out: Dict[str, Any] = {
            "speaker": int(self.speaker) if self.speaker != NO_SPEAKER else 1,
            "text": self.text,
            "start": format_time(self.start),
            "end": format_time(self.end),
        }
        if self.translation:
            out["translation"] = self.translation
        if self.detected_language:
            out["detected_language"] = self.detected_language
        return out

    # Alias kept so code written against the reference API keeps working.
    to_dict = as_dict


@dataclass
class PuncSegment(Segment):
    pass


class SilentSegment(Segment):
    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self.speaker = SILENCE_SPEAKER
        self.text = ""


@dataclass
class FrontData:
    """One WebSocket frame of incremental results (reference FrontData)."""

    status: str = ""
    error: str = ""
    lines: List[Segment] = field(default_factory=list)
    buffer_transcription: str = ""
    buffer_diarization: str = ""
    buffer_translation: str = ""
    remaining_time_transcription: float = 0.0
    remaining_time_transcription_processing: float = 0.0
    remaining_time_transcription_policy: float = 0.0
    remaining_time_diarization: float = 0.0

    def as_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "status": self.status,
            "lines": [
                ln.as_dict()
                for ln in self.lines
                if (ln.text or ln.speaker == SILENCE_SPEAKER)
            ],
            "buffer_transcription": self.buffer_transcription,
            "buffer_diarization": self.buffer_diarization,
            "buffer_translation": self.buffer_translation,
            "remaining_time_transcription": self.remaining_time_transcription,
            "remaining_time_transcription_processing": self.remaining_time_transcription_processing,
            "remaining_time_transcription_policy": self.remaining_time_transcription_policy,
            "remaining_time_diarization": self.remaining_time_diarization,
        }
        if self.error:
            out["error"] = self.error
        return out

    to_dict = as_dict


@dataclass
class State:
    """Per-session accumulated results + update buffers drained by TokensAlignment.

    Mirrors the reference State (timed_objects.py:232-254): persistent committed
    tokens and watermarks, plus ``new_*`` staging lists that the results
    formatter consumes.
    """

    tokens: List[ASRToken] = field(default_factory=list)
    buffer_transcription: Transcript = field(default_factory=Transcript)
    end_buffer: float = 0.0
    end_transcription_processed: float = 0.0
    end_transcription_committed: float = 0.0
    end_attributed_speaker: float = 0.0
    remaining_time_transcription: float = 0.0
    remaining_time_transcription_processing: float = 0.0
    remaining_time_transcription_policy: float = 0.0
    remaining_time_diarization: float = 0.0

    new_tokens: List[Union[ASRToken, Silence]] = field(default_factory=list)
    new_translation: List[Any] = field(default_factory=list)
    new_diarization: List[Any] = field(default_factory=list)
    #: True when new_diarization is a CUMULATIVE snapshot (diart-style
    #: backends relabel history) — consumers replace instead of extend
    new_diarization_replaces: bool = False
    new_tokens_buffer: List[Any] = field(default_factory=list)
    new_translation_buffer: TimedText = field(default_factory=TimedText)
