"""Simultaneous translation backends (port of whisperlivekit_tpu/translation).

Session contract (reference translation_alignatt.py:129-181,
audio_processor.py:675-708): ``insert_tokens(items)``, ``process() ->
(Translation|None, TimedText)``, ``validate_buffer_and_reset()``,
``insert_silence(duration)``.

Backends:
- NLLB in-process (``nllb.py`` over ``nllb_model.py``, on the card),
  loaded once per engine from a local HF checkpoint;
- the AlignAtt MT sidecar over WebSocket (``translation_backend=alignatt``),
  host code, ``alignatt_client.py``;
- ``EchoTranslation`` when the NLLB weights are absent.
"""

from .base import load_translation_model  # noqa: F401
