"""Async FFmpeg subprocess manager (WebM/Opus → s16le 16 kHz mono PCM).

State-machine parity with reference ffmpeg_manager.py:32-202: explicit
STOPPED/STARTING/RUNNING/RESTARTING/FAILED states, write/read with timeouts,
stderr drain, restart, and an error callback surfaced to the session as a
FrontData error. The binary is optional — PCM input (`--pcm-input`) and WAV
files never need it.
"""

from __future__ import annotations

import asyncio
import logging
import shutil
from enum import Enum
from typing import Callable, Optional

logger = logging.getLogger(__name__)


class FFmpegState(str, Enum):
    STOPPED = "stopped"
    STARTING = "starting"
    RUNNING = "running"
    RESTARTING = "restarting"
    FAILED = "failed"


class FFmpegManager:
    def __init__(self, sample_rate: int = 16000, channels: int = 1):
        self.sample_rate = sample_rate
        self.channels = channels
        self.process: Optional[asyncio.subprocess.Process] = None
        self._state = FFmpegState.STOPPED
        self._state_lock = asyncio.Lock()
        self._stderr_task: Optional[asyncio.Task] = None
        self.on_error_callback: Optional[Callable] = None
        self.write_timeout = 5.0
        self.read_timeout = 5.0

    async def get_state(self) -> FFmpegState:
        async with self._state_lock:
            return self._state

    async def _set_state(self, state: FFmpegState) -> None:
        async with self._state_lock:
            self._state = state

    @property
    def available(self) -> bool:
        return shutil.which("ffmpeg") is not None

    async def start(self) -> bool:
        if not self.available:
            logger.error("ffmpeg binary not found on PATH")
            await self._set_state(FFmpegState.FAILED)
            await self._report_error("ffmpeg_not_installed")
            return False
        await self._set_state(FFmpegState.STARTING)
        try:
            self.process = await asyncio.create_subprocess_exec(
                "ffmpeg",
                "-hide_banner",
                "-loglevel", "error",
                "-i", "pipe:0",
                "-f", "s16le",
                "-ar", str(self.sample_rate),
                "-ac", str(self.channels),
                "pipe:1",
                stdin=asyncio.subprocess.PIPE,
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.PIPE,
            )
            self._stderr_task = asyncio.create_task(self._drain_stderr())
            await self._set_state(FFmpegState.RUNNING)
            return True
        except Exception as e:
            logger.exception("failed to start ffmpeg: %s", e)
            await self._set_state(FFmpegState.FAILED)
            await self._report_error("start_failed")
            return False

    async def _drain_stderr(self) -> None:
        try:
            while self.process and self.process.stderr:
                line = await self.process.stderr.readline()
                if not line:
                    break
                logger.debug("ffmpeg: %s", line.decode(errors="replace").rstrip())
        except asyncio.CancelledError:
            pass

    async def _report_error(self, error_type: str) -> None:
        if self.on_error_callback:
            try:
                res = self.on_error_callback(error_type)
                if asyncio.iscoroutine(res):
                    await res
            except Exception:
                logger.exception("error callback failed")

    async def write_data(self, data: bytes) -> bool:
        if await self.get_state() != FFmpegState.RUNNING or not self.process:
            return False
        try:
            self.process.stdin.write(data)
            await asyncio.wait_for(self.process.stdin.drain(), timeout=self.write_timeout)
            return True
        except (asyncio.TimeoutError, ConnectionResetError, BrokenPipeError) as e:
            logger.warning("ffmpeg write failed: %s", e)
            await self._set_state(FFmpegState.FAILED)
            await self._report_error("write_failed")
            return False

    async def read_data(self, max_bytes: int) -> Optional[bytes]:
        """Returns b'' on EOF, None on timeout/no data."""
        if not self.process or not self.process.stdout:
            return b""
        try:
            chunk = await asyncio.wait_for(
                self.process.stdout.read(max_bytes), timeout=self.read_timeout
            )
            return chunk
        except asyncio.TimeoutError:
            return None

    async def close_stdin(self) -> None:
        if self.process and self.process.stdin:
            try:
                self.process.stdin.close()
                await self.process.stdin.wait_closed()
            except Exception:
                pass

    async def restart(self) -> bool:
        await self._set_state(FFmpegState.RESTARTING)
        await self.stop()
        return await self.start()

    async def stop(self) -> None:
        if self._stderr_task:
            self._stderr_task.cancel()
            self._stderr_task = None
        if self.process:
            try:
                await self.close_stdin()
                try:
                    await asyncio.wait_for(self.process.wait(), timeout=3.0)
                except asyncio.TimeoutError:
                    self.process.kill()
                    await self.process.wait()
            except ProcessLookupError:
                pass
            self.process = None
        await self._set_state(FFmpegState.STOPPED)
