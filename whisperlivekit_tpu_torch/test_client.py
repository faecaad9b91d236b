"""`wlk-test`: standalone WebSocket client — stream a file, print the result.

Reference parity: test_client.py:39-395 — feeds audio at a given speed to a
running server's /asr, reconstructs full/diff state, exposes
``transcribe_audio()`` as a library API.
A host copy of whisperlivekit_tpu/test_client.py; its WAV reader is the
port's ``harness.harness.load_audio_pcm``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class TranscriptionResult:
    lines: List[Dict[str, Any]] = field(default_factory=list)
    buffer_transcription: str = ""
    messages: List[Dict[str, Any]] = field(default_factory=list)
    finished: bool = False

    @property
    def text(self) -> str:
        parts = [
            ln["text"].strip()
            for ln in self.lines
            if ln.get("text") and ln.get("speaker") != -2
        ]
        if self.buffer_transcription:
            parts.append(self.buffer_transcription.strip())
        return " ".join(p for p in parts if p)


def reconstruct_state(result: TranscriptionResult, msg: Dict[str, Any]) -> None:
    """Apply one server message (full or diff protocol) to the running state."""
    mtype = msg.get("type")
    if mtype == "ready_to_stop":
        result.finished = True
        return
    if mtype == "config":
        return
    if mtype == "snapshot":
        result.lines = list(msg.get("lines", []))
    elif mtype == "diff":
        pruned = msg.get("lines_pruned", 0)
        if pruned:
            result.lines = result.lines[pruned:]
        new_lines = msg.get("new_lines", [])
        if new_lines:
            n_total = msg.get("n_lines", len(result.lines) + len(new_lines))
            keep = n_total - len(new_lines)
            result.lines = result.lines[:keep] + new_lines
    else:  # full mode
        result.lines = list(msg.get("lines", []))
    result.buffer_transcription = msg.get("buffer_transcription", "")


async def transcribe_audio(
    path: str,
    url: str = "ws://localhost:8000/asr",
    speed: float = 1.0,
    language: Optional[str] = None,
    mode: str = "full",
    chunk_duration: float = 0.5,
    show_progress: bool = False,
) -> TranscriptionResult:
    import websockets

    from .harness.harness import load_audio_pcm

    params = [f"mode={mode}"]
    if language:
        params.append(f"language={language}")
    full_url = url + ("&" if "?" in url else "?") + "&".join(params)

    pcm = load_audio_pcm(path)
    result = TranscriptionResult()

    # ping_timeout=None: the server may stall its loop during first-time XLA
    # compilation; don't let keepalive kill the session.
    async with websockets.connect(full_url, max_size=None, ping_timeout=None) as ws:

        async def receiver():
            async for raw in ws:
                msg = json.loads(raw)
                result.messages.append(msg)
                reconstruct_state(result, msg)
                if show_progress:
                    sys.stderr.write("\r\x1b[K" + result.text[-100:])
                    sys.stderr.flush()
                if result.finished:
                    return

        recv_task = asyncio.create_task(receiver())

        chunk_bytes = int(chunk_duration * 16000 * 2)
        for i in range(0, len(pcm), chunk_bytes):
            await ws.send(pcm[i : i + chunk_bytes])
            if speed > 0:
                await asyncio.sleep(chunk_duration / speed)
        await ws.send(b"")

        try:
            await asyncio.wait_for(recv_task, timeout=300)
        except asyncio.TimeoutError:
            recv_task.cancel()
    return result


def main() -> int:
    p = argparse.ArgumentParser(prog="wlk-test", description="stream a file to a wlk server")
    p.add_argument("file")
    p.add_argument("--url", default="ws://localhost:8000/asr")
    p.add_argument("--speed", type=float, default=1.0)
    p.add_argument("--language")
    p.add_argument("--mode", choices=("full", "diff"), default="full")
    p.add_argument("--json", action="store_true", help="print full JSON state")
    args = p.parse_args()

    result = asyncio.run(
        transcribe_audio(
            args.file,
            url=args.url,
            speed=args.speed,
            language=args.language,
            mode=args.mode,
            show_progress=True,
        )
    )
    print()
    if args.json:
        print(json.dumps({"text": result.text, "lines": result.lines}, ensure_ascii=False))
    else:
        print(result.text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
