"""Whisper under the AlignAtt policy: the port's ``AlignAttEngine`` and
``BatchScheduler`` (``lib/system.py``), random weights in OpenAI's layout
(``lib/weights.py``), the stand-in vocabulary (``lib/audio.py``) and the
replay by ``reference/whisper_ref.py`` (``lib/judge.py``)."""

from __future__ import annotations

from lib.audio import write_vocab as assets  # noqa: F401
from lib.judge import judge  # noqa: F401
from lib.system import System  # noqa: F401
from lib.weights import draw  # noqa: F401


def context(system, cfg: dict) -> dict:
    return {"max_steps": int(cfg["serving"]["max_steps"]), "eot": int(cfg["eos_token_id"]),
            "tail_frames": int(system.engine.cfg.enc_tail_frames)}
