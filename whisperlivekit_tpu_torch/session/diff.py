"""Incremental WebSocket protocol (?mode=diff).

Wire parity with reference diff_protocol.py:31-108: first message is a full
``{"type": "snapshot", "seq": 1, ...}``; afterwards ``{"type": "diff"}``
messages carry only ``new_lines`` after the common prefix plus
``lines_pruned`` when retention dropped leading lines.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

from ..timed import FrontData


@dataclass
class DiffTracker:
    seq: int = 0
    _prev_lines: List[Dict[str, Any]] = field(default_factory=list)
    _sent_snapshot: bool = False

    def to_message(self, front_data: FrontData) -> Dict[str, Any]:
        self.seq += 1
        full = front_data.as_dict()
        current = full["lines"]

        if not self._sent_snapshot:
            self._sent_snapshot = True
            self._prev_lines = current[:]
            return {"type": "snapshot", "seq": self.seq, **full}

        msg: Dict[str, Any] = {
            "type": "diff",
            "seq": self.seq,
            "status": full["status"],
            "n_lines": len(current),
            "buffer_transcription": full["buffer_transcription"],
            "buffer_diarization": full["buffer_diarization"],
            "buffer_translation": full["buffer_translation"],
            "remaining_time_transcription": full["remaining_time_transcription"],
            "remaining_time_transcription_processing": full[
                "remaining_time_transcription_processing"
            ],
            "remaining_time_transcription_policy": full[
                "remaining_time_transcription_policy"
            ],
            "remaining_time_diarization": full["remaining_time_diarization"],
        }
        if full.get("error"):
            msg["error"] = full["error"]

        # front-pruning detection: locate current[0] in prev
        prune = 0
        if current and self._prev_lines:
            first = current[0]
            for i, prev_line in enumerate(self._prev_lines):
                if prev_line == first:
                    prune = i
                    break
            else:
                prune = len(self._prev_lines)
        elif not current:
            prune = len(self._prev_lines)
        if prune:
            msg["lines_pruned"] = prune

        common = 0
        limit = min(len(self._prev_lines) - prune, len(current))
        while common < limit and self._prev_lines[prune + common] == current[common]:
            common += 1
        if current[common:]:
            msg["new_lines"] = current[common:]

        self._prev_lines = current[:]
        return msg

    def reset(self) -> None:
        self.seq = 0
        self._prev_lines = []
        self._sent_snapshot = False
