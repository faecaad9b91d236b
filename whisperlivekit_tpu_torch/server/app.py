"""HTTP/WebSocket server on aiohttp (port of whisperlivekit_tpu/server/app.py).

Serves `/` (web UI), `/health`, WS `/asr` (token auth via ?token= or Bearer,
per-session language/mode, config message, results pump, ready_to_stop), WS
`/v1/listen` (Deepgram-compatible), POST `/v1/audio/transcriptions`
(OpenAI-compatible REST, json/verbose_json/text/srt/vtt) and GET
`/v1/models` through the port's engine, which serves on the card unless the
server is given ``device="cpu"``.

Run: ``python -m whisperlivekit_tpu_torch.cli serve --model-path <file.pt|hf_dir>``
(or ``python -m whisperlivekit_tpu_torch.server.app`` with the same flags).
"""

from __future__ import annotations

import asyncio
import hmac
import logging
import os
from typing import Optional

from aiohttp import WSMsgType, web

from ..config import WLKConfig, parse_cors_origins
from ..session.diff import DiffTracker
from ..engine.core import EngineAtCapacity, TranscriptionEngine
from ..session.processor import AudioProcessor
from .deepgram_compat import _parse_time_str, handle_deepgram_websocket

logger = logging.getLogger(__name__)


def _token_ok(config: WLKConfig, token: Optional[str]) -> bool:
    expected = config.api_token or os.environ.get("WLK_API_TOKEN")
    if not expected:
        return True
    # constant-time comparison (timing side channel)
    return hmac.compare_digest(token or "", expected)


def _bearer(request: web.Request) -> Optional[str]:
    auth = request.headers.get("Authorization", "")
    if auth.lower().startswith("bearer "):
        return auth[7:].strip()
    return request.query.get("token")


def _srt_timestamp(seconds: float, fmt: str) -> str:
    h = int(seconds // 3600)
    m = int((seconds % 3600) // 60)
    s = int(seconds % 60)
    ms = int(round((seconds % 1) * 1000))
    sep = "," if fmt == "srt" else "."
    return f"{h:02d}:{m:02d}:{s:02d}{sep}{ms:03d}"


def format_openai_response(front_data, response_format: str, language, duration: float):
    """FrontData → OpenAI-compatible payload (reference basic_server.py:208-270)."""
    d = front_data.as_dict()
    lines = d.get("lines", [])
    text_parts = [l["text"] for l in lines if l.get("text") and l.get("speaker", 0) != -2]
    full_text = " ".join(text_parts).strip()

    if response_format == "text":
        return full_text

    segments = []
    words = []
    for line in lines:
        if line.get("speaker") == -2 or not line.get("text"):
            continue
        start = _parse_time_str(line.get("start", "0:00:00"))
        end = _parse_time_str(line.get("end", "0:00:00"))
        segments.append(
            {"id": len(segments), "start": round(start, 2), "end": round(end, 2), "text": line["text"]}
        )
        seg_words = line["text"].split()
        if seg_words:
            wd = (end - start) / max(len(seg_words), 1)
            for j, w in enumerate(seg_words):
                words.append(
                    {"word": w, "start": round(start + j * wd, 2), "end": round(start + (j + 1) * wd, 2)}
                )

    if response_format == "verbose_json":
        return {
            "task": "transcribe",
            "language": language or "unknown",
            "duration": round(duration, 2),
            "text": full_text,
            "words": words,
            "segments": segments,
        }

    if response_format in ("srt", "vtt"):
        out = []
        if response_format == "vtt":
            out.append("WEBVTT\n")
        for i, seg in enumerate(segments):
            if response_format == "srt":
                out.append(f"{i + 1}")
            out.append(
                f"{_srt_timestamp(seg['start'], response_format)} --> "
                f"{_srt_timestamp(seg['end'], response_format)}"
            )
            out.append(seg["text"])
            out.append("")
        return "\n".join(out)

    return {"text": full_text}


class WLKServer:
    def __init__(self, config: WLKConfig, engine: Optional[TranscriptionEngine] = None, device=None):
        self.config = config
        self.engine = engine
        self.device = device  # the engine's, when the server builds it (None: the card)
        self.app = web.Application(client_max_size=512 * 1024 * 1024)
        self.app.router.add_get("/", self.index)
        self.app.router.add_get("/health", self.health)
        self.app.router.add_get("/asr", self.asr_websocket)
        self.app.router.add_get("/v1/listen", self.deepgram_websocket)
        self.app.router.add_post("/v1/audio/transcriptions", self.create_transcription)
        self.app.router.add_get("/v1/models", self.list_models)
        self.app.on_startup.append(self._on_startup)
        self._cors = parse_cors_origins(config.cors_origins)
        if self._cors:
            self.app.on_response_prepare.append(self._add_cors_headers)

    async def _add_cors_headers(self, request, response):
        origin = request.headers.get("Origin")
        if origin and (origin in self._cors or "*" in self._cors):
            response.headers["Access-Control-Allow-Origin"] = origin

    async def _on_startup(self, app) -> None:
        if self.engine is None:
            self.engine = TranscriptionEngine(self.config, device=self.device)
            logger.info("TranscriptionEngine initialized")
        try:
            self.engine.warmup_synthetic()
        except Exception:
            logger.exception("engine warmup FAILED — inference is likely broken")
            raise

    # ---- endpoints ----------------------------------------------------------

    async def index(self, request: web.Request) -> web.Response:
        from .web import render_index

        return web.Response(text=render_index(), content_type="text/html")

    async def health(self, request: web.Request) -> web.Response:
        payload = {
            "status": "ok",
            "backend": "torch",
            "device": str(getattr(self.engine, "device", "")),
            "ready": self.engine is not None,
        }
        sched = getattr(self.engine, "scheduler", None)
        if sched is not None:
            payload["scheduler"] = sched.stats()
        if hasattr(self.engine, "session_capacity"):
            payload["active_sessions"] = self.engine.active_sessions
            payload["session_capacity"] = self.engine.session_capacity()
        return web.json_response(payload)

    async def list_models(self, request: web.Request) -> web.Response:
        model_size = getattr(self.config, "model_size", "base")
        return web.json_response(
            {
                "object": "list",
                "data": [
                    {
                        "id": f"whisper-{model_size}",
                        "object": "model",
                        "owned_by": "whisperlivekit-tpu",
                    }
                ],
            }
        )

    async def asr_websocket(self, request: web.Request) -> web.WebSocketResponse:
        token = request.query.get("token") or _bearer(request)
        if not _token_ok(self.config, token):
            raise web.HTTPUnauthorized(reason="invalid or missing API token")

        session_language = request.query.get("language")
        mode = request.query.get("mode", "full")
        session_target_language = request.query.get("target_language")

        ws = web.WebSocketResponse(heartbeat=30)
        await ws.prepare(request)
        logger.info("WebSocket /asr opened (language=%s mode=%s)", session_language, mode)

        try:
            processor = AudioProcessor(
                transcription_engine=self.engine,
                language=session_language,
                mode=mode,
                target_language=session_target_language,
            )
        except EngineAtCapacity as e:
            # explicit rejection beats admitting onto the degraded fallback
            # path (every live session would pay for the overflow lane)
            logger.warning("rejecting /asr session: %s", e)
            await ws.send_json({"type": "error", "error": "server_busy", "detail": str(e)})
            await ws.close(code=1013, message=b"server busy")  # 1013 = try again later
            return ws
        diff_tracker = DiffTracker() if mode == "diff" else None

        await ws.send_json(
            {"type": "config", "useAudioWorklet": bool(self.config.pcm_input), "mode": mode}
        )

        results_generator = await processor.create_tasks()

        async def pump_results():
            try:
                async for response in results_generator:
                    if diff_tracker is not None:
                        await ws.send_json(diff_tracker.to_message(response))
                    else:
                        await ws.send_json(response.as_dict())
                await ws.send_json({"type": "ready_to_stop"})
            except (ConnectionResetError, asyncio.CancelledError):
                pass
            except Exception:
                logger.exception("Error in WebSocket results handler")

        pump_task = asyncio.create_task(pump_results())
        try:
            async for msg in ws:
                if msg.type == WSMsgType.BINARY:
                    await processor.process_audio(msg.data)
                elif msg.type in (WSMsgType.CLOSE, WSMsgType.CLOSING, WSMsgType.ERROR):
                    break
        finally:
            if not pump_task.done():
                pump_task.cancel()
            try:
                await pump_task
            except (asyncio.CancelledError, Exception):
                pass
            await processor.cleanup()
            logger.info("WebSocket /asr closed")
        return ws

    async def deepgram_websocket(self, request: web.Request) -> web.WebSocketResponse:
        return await handle_deepgram_websocket(request, self.engine, self.config)

    async def create_transcription(self, request: web.Request) -> web.Response:
        if not _token_ok(self.config, _bearer(request)):
            raise web.HTTPUnauthorized(reason="invalid or missing API token")

        form = await request.post()
        file_field = form.get("file")
        if file_field is None:
            raise web.HTTPBadRequest(reason="missing file field")
        audio_bytes = file_field.file.read()
        if not audio_bytes:
            raise web.HTTPBadRequest(reason="Empty audio file")

        language = form.get("language") or None
        response_format = form.get("response_format", "json")

        pcm = await self._to_pcm(audio_bytes, getattr(file_field, "filename", "audio"))
        duration = len(pcm) / (16000 * 2)

        try:
            processor = AudioProcessor(transcription_engine=self.engine, language=language)
        except EngineAtCapacity as e:
            raise web.HTTPServiceUnavailable(reason=str(e))
        processor.is_pcm_input = True
        results_gen = await processor.create_tasks()

        final_result = None

        async def collect():
            nonlocal final_result
            async for result in results_gen:
                final_result = result

        collect_task = asyncio.create_task(collect())
        chunk = 16000 * 2
        for i in range(0, len(pcm), chunk):
            await processor.process_audio(pcm[i : i + chunk])
        await processor.process_audio(b"")

        configured = float(self.config.rest_timeout or 0)
        timeout_sec = configured if configured > 0 else max(120.0, duration * 2.5)
        timed_out = False
        try:
            await asyncio.wait_for(collect_task, timeout=timeout_sec)
        except asyncio.TimeoutError:
            timed_out = True
        finally:
            await processor.cleanup()

        if timed_out:
            raise web.HTTPRequestTimeout(
                reason=f"Transcription did not finish within {timeout_sec:.0f}s"
            )
        if final_result is None:
            return web.json_response({"text": ""})

        result = format_openai_response(final_result, response_format, language, duration)
        if isinstance(result, str):
            return web.Response(text=result, content_type="text/plain")
        return web.json_response(result)

    async def _to_pcm(self, audio_bytes: bytes, filename: str) -> bytes:
        """WAV natively; other containers via optional ffmpeg."""
        import io
        import wave

        import numpy as np

        from ..audio.io import ffmpeg_available, float32_to_s16le, resample

        try:
            with wave.open(io.BytesIO(audio_bytes), "rb") as w:
                sr, n_ch, width = w.getframerate(), w.getnchannels(), w.getsampwidth()
                raw = w.readframes(w.getnframes())
            if width == 2:
                audio = np.frombuffer(raw, "<i2").astype("float32") / 32768.0
                if n_ch > 1:
                    audio = audio.reshape(-1, n_ch).mean(axis=1)
                return float32_to_s16le(resample(audio, sr))
        except (wave.Error, EOFError, ValueError):
            pass  # not a (valid) WAV; try ffmpeg below
        if not ffmpeg_available():
            raise web.HTTPBadRequest(
                reason="unsupported audio container (ffmpeg not installed; send WAV)"
            )
        proc = await asyncio.create_subprocess_exec(
            "ffmpeg", "-i", "pipe:0", "-f", "s16le", "-acodec", "pcm_s16le",
            "-ar", "16000", "-ac", "1", "-loglevel", "error", "pipe:1",
            stdin=asyncio.subprocess.PIPE,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE,
        )
        stdout, stderr = await proc.communicate(input=audio_bytes)
        if proc.returncode != 0:
            raise web.HTTPBadRequest(reason=f"Audio conversion failed: {stderr.decode().strip()}")
        return stdout

    # ---- runner ---------------------------------------------------------------

    def run(self) -> None:
        ssl_context = None
        if self.config.ssl_certfile and self.config.ssl_keyfile:
            import ssl

            ssl_context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ssl_context.load_cert_chain(self.config.ssl_certfile, self.config.ssl_keyfile)
        web.run_app(
            self.app,
            host=self.config.host,
            port=self.config.port,
            ssl_context=ssl_context,
            print=lambda *a: logger.info(
                "Serving on %s://%s:%d",
                "https" if ssl_context else "http",
                self.config.host,
                self.config.port,
            ),
        )


def create_app(config: Optional[WLKConfig] = None, engine=None) -> web.Application:
    return WLKServer(config or WLKConfig(), engine=engine).app


def main(config: Optional[WLKConfig] = None) -> None:
    from ..cli_args import parse_args

    if config is None:
        config = parse_args()
    logging.basicConfig(level=getattr(logging, config.log_level.upper(), logging.INFO))
    WLKServer(config).run()


if __name__ == "__main__":
    main()
