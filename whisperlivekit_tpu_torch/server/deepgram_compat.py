"""Deepgram-compatible /v1/listen WebSocket (aiohttp).

Protocol parity with reference deepgram_compat.py:120-310: Metadata on open;
committed lines → Results(is_final=true, word timestamps interpolated across
the segment span); buffer → interim Results; silence after speech →
UtteranceEnd; optional SpeechStarted (?vad_events=true); KeepAlive /
CloseStream / Finalize control messages.

A copy of whisperlivekit_tpu/server/deepgram_compat.py; the engine and the
AudioProcessor it drives are the port's.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
import uuid

from aiohttp import WSMsgType, web

logger = logging.getLogger(__name__)


def _parse_time_str(time_str: str) -> float:
    parts = time_str.split(":")
    if len(parts) == 3:
        return int(parts[0]) * 3600 + int(parts[1]) * 60 + float(parts[2])
    if len(parts) == 2:
        return int(parts[0]) * 60 + float(parts[1])
    return float(parts[0])


def _line_to_words(line: dict) -> list:
    text = line.get("text", "")
    if not text or not text.strip():
        return []
    speaker = line.get("speaker", 0)
    if speaker == -2:
        return []
    start = _parse_time_str(line.get("start", "0:00:00"))
    end = _parse_time_str(line.get("end", "0:00:00"))
    words = text.split()
    if not words:
        return []
    step = (end - start) / max(len(words), 1)
    return [
        {
            "word": w,
            "start": round(start + i * step, 3),
            "end": round(start + (i + 1) * step, 3),
            "confidence": 0.0,
            "punctuated_word": w,
            "speaker": speaker if speaker > 0 else 0,
        }
        for i, w in enumerate(words)
    ]


def _lines_to_result(lines: list, is_final: bool, speech_final: bool, start_time: float = 0.0) -> dict:
    all_words = []
    parts = []
    for line in lines:
        if line.get("speaker") == -2:
            continue
        all_words.extend(_line_to_words(line))
        text = line.get("text", "")
        if text and text.strip():
            parts.append(text.strip())
    transcript = " ".join(parts)
    if all_words:
        seg_start, seg_end = all_words[0]["start"], all_words[-1]["end"]
    else:
        seg_start = seg_end = start_time
    return {
        "type": "Results",
        "channel_index": [0, 1],
        "duration": round(seg_end - seg_start, 3),
        "start": round(seg_start, 3),
        "is_final": is_final,
        "speech_final": speech_final,
        "channel": {
            "alternatives": [
                {"transcript": transcript, "confidence": 0.0, "words": all_words}
            ]
        },
    }


class DeepgramAdapter:
    def __init__(self, ws: web.WebSocketResponse):
        self.ws = ws
        self.request_id = str(uuid.uuid4())
        self._sent_lines = 0
        self._last_word_end = 0.0
        self._speech_started_sent = False
        self._vad_events = False

    async def send_metadata(self, config) -> None:
        backend = getattr(config, "backend", "torch") if config else "torch"
        await self.ws.send_json(
            {
                "type": "Metadata",
                "request_id": self.request_id,
                "sha256": "",
                "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
                "duration": 0,
                "channels": 1,
                "models": [backend],
                "model_info": {backend: {"name": backend, "version": "whisperlivekit-tpu"}},
            }
        )

    async def process_update(self, fd: dict) -> None:
        lines = fd.get("lines", [])
        buffer = fd.get("buffer_transcription", "")
        speech_lines = [l for l in lines if l.get("speaker", 0) != -2]
        n_speech = len(speech_lines)

        if n_speech > self._sent_lines:
            result = _lines_to_result(
                speech_lines[self._sent_lines :], is_final=True, speech_final=True
            )
            await self.ws.send_json(result)
            words = result["channel"]["alternatives"][0]["words"]
            if words:
                self._last_word_end = words[-1]["end"]
            self._sent_lines = n_speech
        elif buffer and buffer.strip():
            if self._vad_events and not self._speech_started_sent:
                await self.ws.send_json(
                    {"type": "SpeechStarted", "channel_index": [0], "timestamp": 0.0}
                )
                self._speech_started_sent = True
            await self.ws.send_json(
                {
                    "type": "Results",
                    "channel_index": [0, 1],
                    "duration": 0.0,
                    "start": self._last_word_end,
                    "is_final": False,
                    "speech_final": False,
                    "channel": {
                        "alternatives": [
                            {"transcript": buffer.strip(), "confidence": 0.0, "words": []}
                        ]
                    },
                }
            )

        silence_lines = [l for l in lines if l.get("speaker") == -2]
        if silence_lines and n_speech > 0:
            for sil in silence_lines:
                if _parse_time_str(sil.get("start", "0:00:00")) >= self._last_word_end:
                    await self.ws.send_json(
                        {
                            "type": "UtteranceEnd",
                            "channel": [0, 1],
                            "last_word_end": round(self._last_word_end, 3),
                        }
                    )
                    self._speech_started_sent = False
                    break


async def handle_deepgram_websocket(request: web.Request, engine, config) -> web.WebSocketResponse:
    from ..session.processor import AudioProcessor

    language = request.query.get("language")
    vad_events = request.query.get("vad_events", "false").lower() == "true"

    ws = web.WebSocketResponse(heartbeat=30)
    await ws.prepare(request)
    logger.info("Deepgram-compat WebSocket opened")

    from ..engine.core import EngineAtCapacity

    try:
        processor = AudioProcessor(transcription_engine=engine, language=language)
    except EngineAtCapacity as e:
        logger.warning("rejecting /v1/listen session: %s", e)
        await ws.send_json({"type": "Error", "error": "server_busy", "detail": str(e)})
        await ws.close(code=1013, message=b"server busy")
        return ws
    adapter = DeepgramAdapter(ws)
    adapter._vad_events = vad_events
    await adapter.send_metadata(config)

    results_generator = await processor.create_tasks()

    async def pump():
        try:
            async for response in results_generator:
                await adapter.process_update(response.as_dict())
        except (asyncio.CancelledError, ConnectionResetError):
            pass
        except Exception:
            logger.exception("Deepgram compat results error")

    results_task = asyncio.create_task(pump())
    try:
        async for msg in ws:
            if msg.type == WSMsgType.BINARY:
                if msg.data:
                    await processor.process_audio(msg.data)
                else:
                    await processor.process_audio(b"")
                    break
            elif msg.type == WSMsgType.TEXT:
                try:
                    ctrl = json.loads(msg.data)
                except json.JSONDecodeError:
                    logger.warning("Invalid JSON control message")
                    continue
                mtype = ctrl.get("type", "")
                if mtype == "CloseStream":
                    await processor.process_audio(b"")
                    break
                if mtype == "Finalize":
                    await processor.process_audio(b"")
                elif mtype == "KeepAlive":
                    pass
            else:
                break
    finally:
        if not results_task.done():
            results_task.cancel()
        try:
            await results_task
        except (asyncio.CancelledError, Exception):
            pass
        await processor.cleanup()
        logger.info("Deepgram-compat WebSocket cleaned up")
    return ws
