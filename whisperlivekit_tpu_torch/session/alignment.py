"""TokensAlignment: merge ASR tokens, diarization and translation into lines.

Same *contract* as the reference (reference tokens_alignment.py:19-303 and
docs/alignement_principles.md): punctuation-delimited display lines, speaker
attribution by maximum time-overlap, silence lines (speaker = -2),
translation attachment by time containment, retention pruning (unlimited for
mode=full, 300 s default for mode=diff).

Different *construction*: the timeline is processed by three small engines —

- :class:`_PlainLineFolder` — an incremental fold over the token stream for
  the no-diarization path (each token consumed exactly once; closed lines are
  never recomputed);
- :class:`_SpeakerView` — a recompute-on-read view for the diarization path
  (speaker attribution is retroactive, so lines are rebuilt from the retained
  timeline with a two-pointer overlap sweep);
- :class:`_Retention` — one pruning rule applied to every retained sequence.
"""

from __future__ import annotations

import math
from dataclasses import replace
from time import time
from typing import Any, Iterable, List, Optional, Sequence, Tuple, Union

from ..timed import (
    ASRToken,
    PuncSegment,
    Segment,
    Silence,
    SilentSegment,
    SpeakerSegment,
    TimedText,
)

_DEFAULT_RETENTION_SECONDS = 300.0


def resolve_retention_seconds(requested: Optional[float], mode: str) -> float:
    """Explicit setting wins (≤0 = unlimited); otherwise full-mode clients get
    unlimited history, diff-mode clients the bounded default."""
    if requested is not None:
        return math.inf if float(requested) <= 0 else float(requested)
    return _DEFAULT_RETENTION_SECONDS if mode == "diff" else math.inf


class _Retention:
    """Drop items whose ``end`` precedes the retention cutoff.

    One policy object shared by every retained sequence; keeps the pruning
    rule (measured from the newest token, never pruning at cutoff ≤ 0) in a
    single place.
    """

    def __init__(self, seconds: float) -> None:
        self.seconds = seconds

    def cutoff(self, timeline: Sequence[Any]) -> Optional[float]:
        if not timeline or math.isinf(self.seconds):
            return None
        cut = timeline[-1].end - self.seconds
        return cut if cut > 0 else None

    @staticmethod
    def apply(items: list, cut: float) -> list:
        keep_from = next((i for i, it in enumerate(items) if it.end >= cut), len(items))
        return items[keep_from:] if keep_from else items


class _PlainLineFolder:
    """Incremental line builder for the no-diarization path.

    Folds each incoming token exactly once into (closed lines, open line):
    a silence token closes the open line and opens/extends a silence line;
    anything else extends the open line. Closed lines are immutable history.
    """

    def __init__(self) -> None:
        self.closed: List[Segment] = []
        self.open_tokens: List[ASRToken] = []

    def fold(self, items: Iterable[Union[ASRToken, Silence]], now: float) -> None:
        for item in items:
            if item.is_silence():
                self._close_open_line()
                self._extend_silence(item, now)
            else:
                self.open_tokens.append(item)

    def _close_open_line(self) -> None:
        if self.open_tokens:
            self.closed.append(Segment.from_tokens(self.open_tokens))
            self.open_tokens = []

    def _extend_silence(self, item: Silence, now: float) -> None:
        end = item.end if item.has_ended else now
        if self.closed and self.closed[-1].is_silence():
            self.closed[-1].end = end
        else:
            self.closed.append(SilentSegment(start=item.start, end=end))

    def lines(self) -> List[Segment]:
        out = list(self.closed)
        if self.open_tokens:
            out.append(Segment.from_tokens(self.open_tokens))
        return out


def _break_points(timeline: Sequence[Union[ASRToken, Silence]]) -> Iterable[Tuple[int, int, bool]]:
    """Yield (start, stop, is_silence) index runs splitting ``timeline`` at
    silences and sentence-final punctuation (punctuation closes its run)."""
    run_start = 0
    for i, item in enumerate(timeline):
        if item.is_silence():
            if i > run_start:
                yield run_start, i, False
            yield i, i + 1, True
            run_start = i + 1
        elif item.has_punctuation():
            yield run_start, i + 1, False
            run_start = i + 1
    if run_start < len(timeline):
        yield run_start, len(timeline), False


class _SpeakerView:
    """Diarization-path view: rebuilds attributed lines from the retained
    timeline (attribution is retroactive — later diarization can relabel
    earlier text, so nothing here is incremental on purpose)."""

    def __init__(self, timeline: Sequence, diar: Sequence[SpeakerSegment]) -> None:
        self.timeline = timeline
        self.diar = diar

    def speaker_runs(self) -> List[SpeakerSegment]:
        """Adjacent same-speaker diarization spans merged, on copies (growing
        the stored spans in place would corrupt them a little more on every
        refresh — reference tokens_alignment.py:188-195)."""
        runs: List[SpeakerSegment] = []
        for seg in self.diar:
            if runs and runs[-1].speaker == seg.speaker:
                runs[-1].end = seg.end
            else:
                runs.append(replace(seg))
        return runs

    def punc_segments(self) -> List[PuncSegment]:
        out = []
        for a, b, is_sil in _break_points(self.timeline):
            seg = PuncSegment.from_tokens(list(self.timeline[a:b]), is_silence=is_sil)
            if seg:
                out.append(seg)
        return out

    @staticmethod
    def _overlap(a: TimedText, b: TimedText) -> float:
        return max(0.0, min(a.end, b.end) - max(a.start, b.start))

    def attributed_lines(self) -> Tuple[List[Segment], str]:
        """(merged attributed lines, text pending beyond diarization's reach)."""
        runs = self.speaker_runs()
        diar_frontier = runs[-1].end if runs else None
        pending_text: List[str] = []
        lines: List[Segment] = []

        for seg in self.punc_segments():
            if not seg.is_silence():
                if diar_frontier is not None and seg.start >= diar_frontier:
                    # diarization hasn't caught up: hold the text back
                    pending_text.append(seg.text)
                else:
                    seg.speaker = self._best_speaker(seg, runs)
            if lines and lines[-1].speaker == seg.speaker:
                last = lines[-1]
                if last.text:
                    last.text += seg.text
                last.end = seg.end
            else:
                lines.append(seg)
        return lines, "".join(pending_text)

    def _best_speaker(self, seg: Segment, runs: List[SpeakerSegment]) -> int:
        best_overlap, best = 0.0, 1
        for run in runs:
            if run.start >= seg.end:
                break  # runs are time-ordered; nothing later can overlap
            ov = self._overlap(seg, run)
            if ov > best_overlap:
                best_overlap, best = ov, run.speaker + 1
        return best


class TokensAlignment:
    """Drains a session State's ``new_*`` staging buffers and renders the
    display lines for FrontData. One instance per session."""

    def __init__(
        self,
        state: Any,
        args: Any,
        sep: Optional[str],
        retention_seconds: Optional[float] = None,
    ) -> None:
        self.state = state
        self.diarization = getattr(args, "diarization", False)
        self.sep: str = sep if sep is not None else " "
        self.beg_loop: Optional[float] = None

        # retained history (post-retention); all_tokens interleaves ASRToken
        # and ended Silence objects in stream order
        self.all_tokens: List[Union[ASRToken, Silence]] = []
        self.all_diarization_segments: List[SpeakerSegment] = []
        self.all_translation_segments: List[Any] = []

        # most recent drain (consumed incrementally by the plain-line folder)
        self.new_tokens: List[Union[ASRToken, Silence]] = []
        self.new_tokens_buffer: List[Any] = []
        self.new_translation_buffer: Union[TimedText, str] = TimedText()

        self._folder = _PlainLineFolder()
        self._retention = _Retention(
            retention_seconds if retention_seconds is not None else _DEFAULT_RETENTION_SECONDS
        )

    # -- compat surface (attribute names shared with the session State docs) --

    @property
    def _retention_seconds(self) -> float:
        return self._retention.seconds

    @property
    def validated_segments(self) -> List[Segment]:
        return self._folder.closed

    @validated_segments.setter
    def validated_segments(self, v: List[Segment]) -> None:
        self._folder.closed = v

    @property
    def current_line_tokens(self) -> List[ASRToken]:
        return self._folder.open_tokens

    @current_line_tokens.setter
    def current_line_tokens(self, v: List[ASRToken]) -> None:
        self._folder.open_tokens = v

    # ---- ingestion -----------------------------------------------------------

    def update(self) -> None:
        """Swap out the State's staging buffers and extend retained history."""
        staged = {
            "new_tokens": self.state.new_tokens,
            "new_diarization": self.state.new_diarization,
            "new_translation": self.state.new_translation,
            "new_tokens_buffer": self.state.new_tokens_buffer,
        }
        self.state.new_tokens = []
        self.state.new_diarization = []
        self.state.new_translation = []
        self.state.new_tokens_buffer = []

        self.new_tokens = staged["new_tokens"]
        self.new_tokens_buffer = staged["new_tokens_buffer"]
        self.all_tokens.extend(staged["new_tokens"])
        if getattr(self.state, "new_diarization_replaces", False) and staged["new_diarization"]:
            # cumulative backends (diart) re-emit the whole relabeled history
            self.all_diarization_segments = list(staged["new_diarization"])
            self.state.new_diarization_replaces = False
        else:
            self.all_diarization_segments.extend(staged["new_diarization"])
        self.all_translation_segments.extend(staged["new_translation"])
        self.new_translation_buffer = self.state.new_translation_buffer

    # ---- pruning --------------------------------------------------------------

    def _prune(self) -> None:
        cut = self._retention.cutoff(self.all_tokens)
        if cut is None:
            return
        self.all_tokens = self._retention.apply(self.all_tokens, cut)
        self.all_diarization_segments = self._retention.apply(
            self.all_diarization_segments, cut
        )
        self.all_translation_segments = self._retention.apply(
            self.all_translation_segments, cut
        )
        self._folder.closed = self._retention.apply(self._folder.closed, cut)
        self._folder.open_tokens = self._retention.apply(self._folder.open_tokens, cut)

    # ---- translation attach ----------------------------------------------------

    def add_translation(self, segment: Segment) -> None:
        """Attach the first contiguous run of contained translation spans."""
        if segment.translation is None:
            segment.translation = ""
        started = False
        for ts in self.all_translation_segments:
            if ts.is_within(segment):
                started = True
                if ts.text:
                    segment.translation += ts.text + self.sep
            elif started and segment.translation:
                break

    # ---- reference-named views (diarization path) -------------------------------

    def compute_punctuations_segments(self) -> List[PuncSegment]:
        return _SpeakerView(self.all_tokens, self.all_diarization_segments).punc_segments()

    def concatenate_diar_segments(self) -> List[SpeakerSegment]:
        return _SpeakerView(self.all_tokens, self.all_diarization_segments).speaker_runs()

    def get_lines_diarization(self) -> Tuple[List[Segment], str]:
        return _SpeakerView(
            self.all_tokens, self.all_diarization_segments
        ).attributed_lines()

    # ---- main view --------------------------------------------------------------

    def get_lines(
        self,
        diarization: bool = False,
        translation: bool = False,
        current_silence: Optional[Silence] = None,
        audio_time: Optional[float] = None,
    ) -> Tuple[List[Segment], str, str]:
        # the "now" for an open silence is the audio-stream clock, never wall
        # time (wall clocks make real-time tests flaky; reference discipline)
        if audio_time is not None:
            now = audio_time
        elif self.beg_loop:
            now = time() - self.beg_loop
        else:
            now = 0.0

        if diarization:
            lines, diarization_buffer = self.get_lines_diarization()
        else:
            diarization_buffer = ""
            self._folder.fold(self.new_tokens, now)
            lines = self._folder.lines()

        if current_silence:
            end = current_silence.end if current_silence.has_ended else now
            if lines and lines[-1].is_silence():
                lines[-1] = SilentSegment(start=lines[-1].start, end=end)
            else:
                lines.append(SilentSegment(start=current_silence.start, end=end))

        if translation:
            for seg in lines:
                if not seg.is_silence():
                    self.add_translation(seg)

        self._prune()
        buffer_translation = (
            self.new_translation_buffer.text
            if isinstance(self.new_translation_buffer, TimedText)
            else (self.new_translation_buffer or "")
        )
        return lines, diarization_buffer, buffer_translation
