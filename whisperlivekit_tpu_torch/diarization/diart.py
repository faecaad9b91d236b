"""Diart diarization backend (pyannote segmentation + embedding pipelines).

Role of reference diarization/diart_backend.py:21-284 — the second
diarization option. Restructured for this host plane: instead of an Rx
``Observer`` + paced audio-source thread, the diart ``SpeakerDiarization``
pipeline is stepped block-by-block inside the session's own async ``diarize``
call (diart pipelines accept chunk sequences directly), so there are no
threads to watch and the sample clock is exact.

Results are CUMULATIVE (the pipeline re-labels history as it learns
speakers); the session pipeline's replace semantics handle that —
DiarizeWorker replaces ``state.new_diarization`` for buffer-less backends
(session/processor.py DiarizeWorker.on_pcm).

(The port's copy of whisperlivekit_tpu/diarization/diart.py.)
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np

from ..timed import SpeakerSegment

logger = logging.getLogger(__name__)

SAMPLE_RATE = 16000


def _speaker_index(label) -> int:
    """pyannote labels are 'speaker0'/'SPEAKER_00' style; map to an int."""
    digits = "".join(ch for ch in str(label) if ch.isdigit())
    return int(digits) if digits else 0


class DiartDiarization:
    """Shared holder + per-session stepper (diart keeps per-pipeline state,
    so each session gets its own pipeline instance via ``new_session``)."""

    def __init__(self, config=None, pipeline_factory=None):
        self._config = config
        self._factory = pipeline_factory or _build_diart_pipeline_factory(config)

    def new_session(self) -> "DiartDiarizationOnline":
        return DiartDiarizationOnline(self._factory())


def _build_diart_pipeline_factory(config):
    try:
        from diart import SpeakerDiarization, SpeakerDiarizationConfig
        from diart.models import EmbeddingModel, SegmentationModel
    except ImportError as e:
        raise ImportError(
            "the 'diart' package (with pyannote models) is required for "
            "--diarization-backend diart; use the default sortformer or "
            "embedding backends otherwise"
        ) from e

    seg_name = getattr(config, "segmentation_model", "pyannote/segmentation-3.0")
    emb_name = getattr(config, "embedding_model", "pyannote/embedding")

    def factory():
        cfg = SpeakerDiarizationConfig(
            segmentation=SegmentationModel.from_pretrained(seg_name),
            embedding=EmbeddingModel.from_pretrained(emb_name),
        )
        return SpeakerDiarization(cfg)

    return factory


class DiartDiarizationOnline:
    """Session backend: the standard diarization duck type (cumulative
    snapshot variant — no ``buffer_audio`` attribute, so the worker replaces
    previous segments with each ``diarize`` result)."""

    def __init__(self, pipeline, block_duration: float = 0.5):
        self.pipeline = pipeline
        self.block_size = int(block_duration * SAMPLE_RATE)
        self._pcm = np.zeros(0, np.float32)
        self.global_time_offset = 0.0
        self.segments: List[SpeakerSegment] = []

    def insert_audio_chunk(self, pcm: np.ndarray) -> None:
        self._pcm = np.concatenate([self._pcm, np.asarray(pcm, np.float32)])

    def insert_silence(self, duration: Optional[float]) -> None:
        if duration:
            self.global_time_offset += duration

    async def diarize(self) -> List[SpeakerSegment]:
        """Step the pipeline over every complete block; return the cumulative
        segment view (replace semantics downstream)."""
        blocks = []
        while len(self._pcm) >= self.block_size:
            blocks.append(self._pcm[: self.block_size].reshape(1, -1))
            self._pcm = self._pcm[self.block_size :]
        if not blocks:
            return list(self.segments)
        for annotation in self._run_blocks(blocks):
            self._merge_annotation(annotation)
        return list(self.segments)

    def _run_blocks(self, blocks):
        outputs = self.pipeline(blocks)
        for out in outputs:
            # diart yields (Annotation, SlidingWindowFeature) pairs
            yield out[0] if isinstance(out, tuple) else out

    def _merge_annotation(self, annotation) -> None:
        if annotation is None:
            return
        new: List[SpeakerSegment] = []
        for segment, _, label in annotation.itertracks(yield_label=True):
            new.append(
                SpeakerSegment(
                    speaker=_speaker_index(label),
                    start=round(segment.start + self.global_time_offset, 2),
                    end=round(segment.end + self.global_time_offset, 2),
                )
            )
        if not new:
            return
        # the pipeline re-emits relabeled history: replace overlapping spans
        horizon = min(s.start for s in new)
        self.segments = [s for s in self.segments if s.end <= horizon] + new
        self.segments.sort(key=lambda s: s.start)

    def close(self) -> None:
        self._pcm = np.zeros(0, np.float32)
