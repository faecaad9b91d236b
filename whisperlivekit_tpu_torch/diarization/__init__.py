"""Speaker diarization backends (port of whisperlivekit_tpu/diarization).

The session-facing contract (``insert_audio_chunk``, ``async diarize() ->
List[SpeakerSegment]``, ``insert_silence``, ``close``, reference
audio_processor.py:641-673) with four backends: streaming Sortformer
(``sortformer.py`` over ``sortformer_model.py``, on the card), and the host
copies of the energy, embedding and diart backends.
"""

from .energy import EnergyDiarization, load_diarization_model  # noqa: F401
