"""Per-session language override on a shared LocalAgreement backend.

Reference parity: session_asr_proxy.py:10-41 — sessions may request a
different language than the server default; the proxy swaps
``original_language`` under a lock around each transcribe() call so
concurrent sessions on the shared backend never see each other's language.

A copy of whisperlivekit_tpu/streaming/session_proxy.py.
"""

from __future__ import annotations

import threading
from typing import Optional


class SessionASRProxy:
    def __init__(self, asr, language: Optional[str]):
        self._asr = asr
        self._language = None if language == "auto" else language
        self._lock = getattr(asr, "_session_lock", None)
        if self._lock is None:
            self._lock = threading.Lock()
            asr._session_lock = self._lock

    def transcribe(self, audio, init_prompt: str = ""):
        with self._lock:
            prev = self._asr.original_language
            self._asr.original_language = self._language
            try:
                return self._asr.transcribe(audio, init_prompt=init_prompt)
            finally:
                self._asr.original_language = prev

    def __getattr__(self, name):
        return getattr(self._asr, name)
