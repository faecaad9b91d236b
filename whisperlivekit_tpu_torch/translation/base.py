"""Translation model loading + session contract base.

The reference loads the external `nllw` package for in-process NLLB
(reference core.py:261-289) or connects to an AlignAtt MT sidecar.
Here: the sidecar client is native (host WebSocket code); the in-process
NLLB backend loads HF NLLB weights when present.

(The port's copy of whisperlivekit_tpu/translation/base.py, with two
changes in ``_SharedTranslationModel``: NLLB loads once per engine, on its
first NLLB session, and every later session shares it (the JAX package
loads it again for each session, 1.2 GB of weights at 600M); and the echo
fallback serves only when the weights are absent (``FileNotFoundError``):
any other failure, a CUDA error, a checkpoint that does not convert or
``tokenizers`` missing beside present weights, raises.)
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional, Tuple

from ..timed import ASRToken, TimedText, Translation

logger = logging.getLogger(__name__)


class OnlineTranslationBase:
    """Per-session translation contract."""

    wants_hypothesis_tail = False

    def insert_tokens(self, items: List[ASRToken]) -> None:
        raise NotImplementedError

    def process(self) -> Tuple[Optional[Translation], TimedText]:
        raise NotImplementedError

    def validate_buffer_and_reset(self) -> Tuple[Optional[Translation], TimedText]:
        raise NotImplementedError

    def insert_silence(self, duration: float) -> None:
        raise NotImplementedError


class EchoTranslation(OnlineTranslationBase):
    """Degenerate pass-through used when no translation weights exist: emits
    the source text as the 'translation' at segment boundaries, so the full
    translation plumbing (queues, alignment attachment, wire fields) can run
    and be tested without NLLB weights."""

    def __init__(self, src: str, tgt: str):
        self.src, self.tgt = src, tgt
        self._pending: List[ASRToken] = []

    def insert_tokens(self, items) -> None:
        if isinstance(items, list):
            self._pending.extend(items)
        else:
            self._pending.append(items)

    def _emit(self) -> Tuple[Optional[Translation], TimedText]:
        if not self._pending:
            return None, TimedText()
        text = "".join(t.text or "" for t in self._pending if isinstance(t, ASRToken))
        tr = Translation(
            start=self._pending[0].start, end=self._pending[-1].end, text=text
        )
        self._pending = []
        return tr, TimedText()

    def process(self):
        # emit at punctuation boundaries, else keep buffering
        if any(t.has_punctuation() for t in self._pending if isinstance(t, ASRToken)):
            return self._emit()
        return None, TimedText(text="".join(t.text or "" for t in self._pending))

    def validate_buffer_and_reset(self):
        return self._emit()

    def insert_silence(self, duration: float) -> None:
        pass


class _SharedTranslationModel:
    def __init__(self, config, device=None):
        self.config = config
        self.device = device
        self.backend = getattr(config, "translation_backend", "nllb")
        self.nllb = None  # the loaded NLLBModel, shared by every session
        self._load_lock = threading.Lock()

    def new_session(self, src: str, tgt: str) -> OnlineTranslationBase:
        if self.backend == "alignatt":
            from .alignatt_client import AlignAttTranslationClient

            return AlignAttTranslationClient(self.config, src, tgt)
        from .nllb import NLLBOnlineTranslation, load_nllb

        with self._load_lock:
            if self.nllb is None:
                try:
                    self.nllb = load_nllb(self.config, device=self.device)
                except FileNotFoundError as e:
                    logger.warning("NLLB unavailable (%s); using echo translation", e)
                    return EchoTranslation(src, tgt)
        return NLLBOnlineTranslation(self.nllb, src, tgt)


def load_translation_model(config, device=None) -> _SharedTranslationModel:
    """The engine's shared translation model; NLLB loads on its first
    session, onto ``device`` (None: the card, which raises without CUDA)."""
    return _SharedTranslationModel(config, device)
