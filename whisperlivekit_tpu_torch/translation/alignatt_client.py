"""AlignAtt MT sidecar WebSocket client (streaming LLM translation).

Protocol parity target: reference translation_alignatt.py:60-394 —
committed words sent with timestamps (attendable), unstable hypothesis tail
without; append-only committed target text; finals on punctuation/silence/
speaker change; latency presets; persistent socket with exponential-backoff
reconnect that RESUMES via ``accepted_target_prefix`` (the server continues
the target text instead of restarting it); pacing max(0.5s, 1.2×last_call).

Wire protocol (mirrored by the in-process fake in
tests/test_translation_sidecar.py):
  → {"type":"start", source/target language, context, preset,
     "accepted_target_prefix": resume state, "committed_words": full history}
  → {"type":"update", "committed_words": NEW words only, "hypothesis_tail"}
  ← {"committed_target": full target so far, "draft": unstable continuation}

(The port's copy of whisperlivekit_tpu/translation/alignatt_client.py.)
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import List, Optional, Tuple

from ..timed import ASRToken, HypothesisTail, TimedText, Translation

logger = logging.getLogger(__name__)

LATENCY_PRESETS = {
    "quality": {"wait_k": 5, "commit_threshold": 0.85},
    "balanced": {"wait_k": 3, "commit_threshold": 0.7},
    "low": {"wait_k": 1, "commit_threshold": 0.5},
}


class AlignAttTranslationClient:
    wants_hypothesis_tail = True

    def __init__(self, config, src: str, tgt: str):
        self.url = getattr(config, "alignatt_url", "ws://localhost:8765")
        self.latency = getattr(config, "alignatt_latency", "balanced")
        self.context = getattr(config, "alignatt_context", "")
        self.preset = LATENCY_PRESETS.get(self.latency, LATENCY_PRESETS["balanced"])
        self.src, self.tgt = src, tgt

        self._committed_words: List[ASRToken] = []
        self._sent_upto = 0               # committed words acknowledged by the server
        self._tail: Optional[HypothesisTail] = None
        self.accepted_target_prefix = ""  # target text the server committed
        self._last_call = 0.0
        self._last_call_at = 0.0
        self._min_interval = 0.5
        self._ws = None
        self._down_until = 0.0
        self._backoff = 1.0
        self.n_reconnects = 0

    # ---- session contract ---------------------------------------------------

    def insert_tokens(self, items) -> None:
        items = items if isinstance(items, list) else [items]
        for item in items:
            if isinstance(item, HypothesisTail):
                self._tail = item
            elif isinstance(item, ASRToken):
                self._committed_words.append(item)

    def insert_silence(self, duration: float) -> None:
        pass

    def validate_buffer_and_reset(self) -> Tuple[Optional[Translation], TimedText]:
        """Finalize at a segment boundary: commit everything drafted."""
        out = None
        if self.accepted_target_prefix or self._committed_words:
            text = self.accepted_target_prefix or "".join(
                t.text or "" for t in self._committed_words
            )
            if self._committed_words:
                out = Translation(
                    start=self._committed_words[0].start,
                    end=self._committed_words[-1].end,
                    text=text,
                )
        self._committed_words = []
        self._sent_upto = 0
        self._tail = None
        self.accepted_target_prefix = ""
        return out, TimedText()

    # ---- the per-update call (async-first: the pipeline's TranslateWorker
    # discovers process_async; plain process() covers sync harnesses) --------

    async def process_async(self) -> Tuple[Optional[Translation], TimedText]:
        now = time.monotonic()
        if now < self._down_until or not self._committed_words:
            return None, TimedText(text=self.accepted_target_prefix)
        interval = max(self._min_interval, 1.2 * self._last_call)
        if now - self._last_call_at < interval:
            return None, TimedText(text=self.accepted_target_prefix)

        t0 = time.monotonic()
        try:
            committed_target, draft = await self._call()
        except Exception as e:
            self._mark_down(e)
            return None, TimedText(text=self.accepted_target_prefix)
        self._last_call = time.monotonic() - t0
        self._last_call_at = time.monotonic()
        self._backoff = 1.0

        # append-only: the server's committed target never shrinks
        if committed_target and len(committed_target) > len(self.accepted_target_prefix):
            self.accepted_target_prefix = committed_target
        # finals only on punctuation: emitted via validate_buffer_and_reset
        if self._committed_words and self._committed_words[-1].has_punctuation():
            return self.validate_buffer_and_reset()
        return None, TimedText(text=self.accepted_target_prefix + (draft or ""))

    def process(self) -> Tuple[Optional[Translation], TimedText]:
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return asyncio.run(self.process_async())
        raise RuntimeError(
            "process() called inside a running event loop; use process_async()"
        )

    # ---- sidecar IO ------------------------------------------------------------

    def _mark_down(self, err) -> None:
        logger.warning("alignatt sidecar unavailable: %s (backoff %.1fs)", err, self._backoff)
        self._down_until = time.monotonic() + self._backoff
        self._backoff = min(self._backoff * 2, 30.0)
        self._ws = None
        self._sent_upto = 0  # resend history after reconnect (resume)

    @staticmethod
    def _word_dicts(words: List[ASRToken]) -> List[dict]:
        return [{"text": w.text, "start": w.start, "end": w.end} for w in words]

    async def _connect(self):
        import websockets

        ws = await websockets.connect(self.url, open_timeout=2)
        # resume handshake: full source history + the target prefix the
        # previous connection had accepted, so the server continues rather
        # than retranslating from scratch (reference :201-267)
        await ws.send(json.dumps({
            "type": "start",
            "source_language": self.src,
            "target_language": self.tgt,
            "context": self.context,
            "preset": self.preset,
            "accepted_target_prefix": self.accepted_target_prefix,
            "committed_words": self._word_dicts(self._committed_words),
        }))
        self._sent_upto = len(self._committed_words)
        if self._ws is not None:
            self.n_reconnects += 1
        return ws

    async def _call(self) -> Tuple[str, str]:
        if self._ws is None:
            self._ws = await self._connect()
        ws = self._ws
        try:
            await ws.send(json.dumps({
                "type": "update",
                "committed_words": self._word_dicts(
                    self._committed_words[self._sent_upto:]
                ),
                "hypothesis_tail": self._tail.text if self._tail else "",
            }))
            self._sent_upto = len(self._committed_words)
            reply = json.loads(await asyncio.wait_for(ws.recv(), timeout=10))
        except Exception:
            # connection died mid-call: drop it so the next call reconnects
            # with the resume handshake; re-raise for backoff accounting
            try:
                await ws.close()
            except Exception:
                pass
            self._ws = None
            self.n_reconnects += 1
            raise
        return reply.get("committed_target", ""), reply.get("draft", "")
