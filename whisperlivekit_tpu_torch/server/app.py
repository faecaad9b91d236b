"""HTTP/WebSocket server on aiohttp (port of whisperlivekit_tpu/server/app.py).

Serves `/` (web UI), `/health`, WS `/asr` (token auth via ?token= or Bearer,
per-session language/mode, config message, results pump, ready_to_stop) and
GET `/v1/models` through the port's engine. WS `/v1/listen` (Deepgram) and
POST `/v1/audio/transcriptions` (OpenAI REST) answer 501 until
server/deepgram_compat.py and audio/io.py are ported (the latter imports JAX).

Run: ``python -m whisperlivekit_tpu_torch.server.app --model-size random:base
--lan en --pcm-input --no-vac`` (the JAX package's CLI flags).
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


def _not_ported(what: str) -> web.Response:
    return web.json_response({"error": f"{what} is not ported yet"}, status=501)


class WLKServer:
    def __init__(self, config: WLKConfig, engine: Optional[TranscriptionEngine] = None):
        self.config = config
        self.engine = engine
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
            self.engine = TranscriptionEngine(self.config)
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

    async def deepgram_websocket(self, request: web.Request) -> web.Response:
        return _not_ported("WS /v1/listen (server/deepgram_compat.py)")

    async def create_transcription(self, request: web.Request) -> web.Response:
        return _not_ported("POST /v1/audio/transcriptions (needs audio/io.py)")

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
