"""Word-level timestamps from cross-attention DTW (port of
whisperlivekit_tpu/decoding/timing.py).

Behavioral parity with reference whisper/timing.py:136-388 (find_alignment →
merge_punctuations → add_word_timestamps), with the attention extraction done
by one teacher-forced decode that accumulates only the registered alignment
heads (``wm.decode(..., align=...)``'s [K, B, S, T] probabilities), instead of
forward hooks on every layer. The normalisation and the median filter run on
the model's device; the DTW runs on the host in f64 (ops/dtw.py).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..audio.mel import HOP_LENGTH, SAMPLE_RATE, TOKENS_PER_SECOND
from ..models.whisper import model as wm
from ..models.whisper.dims import ModelDimensions
from ..models.whisper.tokenizer import Tokenizer
from ..ops.dtw import dtw
from ..ops.median import median_filter


@dataclass
class WordTiming:
    word: str
    tokens: List[int]
    start: float
    end: float
    probability: float


def find_alignment(
    model: wm.Whisper,
    dims: ModelDimensions,
    align: wm.AlignSpec,
    tokenizer: Tokenizer,
    text_tokens: List[int],
    mel: torch.Tensor,  # [n_mels, 3000]
    num_frames: int,
    *,
    medfilt_width: int = 7,
    enc: torch.Tensor | None = None,
) -> List[WordTiming]:
    if len(text_tokens) == 0:
        return []

    tokens = [
        *tokenizer.sot_sequence,
        tokenizer.no_timestamps,
        *text_tokens,
        tokenizer.eot,
    ]
    if len(tokens) > dims.n_text_ctx:
        return []

    dev = model.device
    if enc is None:
        enc = wm.encode(model, torch.as_tensor(mel, device=dev)[None], dims)
    xkv = wm.cross_kv(model, enc, dims)
    cache = wm.init_cache(dims, 1, dtype=model.dtype, device=dev)
    toks = torch.tensor([tokens], dtype=torch.long, device=dev)
    logits, align_probs, _ = wm.decode(
        model, toks, torch.zeros((1,), dtype=torch.long, device=dev), xkv, cache, dims, align=align
    )

    sampled_logits = logits[0].cpu().numpy()[len(tokenizer.sot_sequence) :, : tokenizer.eot]
    token_probs = _softmax(sampled_logits)
    text_token_probs = token_probs[np.arange(len(text_tokens)), text_tokens].tolist()

    # [K, S, T] post-softmax probabilities of the alignment heads.
    weights = align_probs[:, 0, :, : num_frames // 2]
    mean = weights.mean(dim=-2, keepdim=True)
    std = weights.std(dim=-2, keepdim=True, correction=0)  # biased, as jnp.std
    weights = (weights - mean) / std
    weights = median_filter(weights, medfilt_width)
    matrix = weights.mean(dim=0).cpu().numpy()
    matrix = matrix[len(tokenizer.sot_sequence) : -1]

    text_indices, time_indices = dtw(-matrix.astype(np.float64))

    words, word_tokens = tokenizer.split_to_word_tokens(text_tokens + [tokenizer.eot])
    if len(word_tokens) <= 1:
        return []
    word_boundaries = np.pad(np.cumsum([len(t) for t in word_tokens[:-1]]), (1, 0))

    jumps = np.pad(np.diff(text_indices), (1, 0), constant_values=1).astype(bool)
    jump_times = time_indices[jumps] / TOKENS_PER_SECOND
    start_times = jump_times[word_boundaries[:-1]]
    end_times = jump_times[word_boundaries[1:]]
    word_probabilities = [
        float(np.mean(text_token_probs[i:j]))
        for i, j in zip(word_boundaries[:-1], word_boundaries[1:])
    ]

    return [
        WordTiming(word, toks, float(start), float(end), prob)
        for word, toks, start, end, prob in zip(
            words, word_tokens, start_times, end_times, word_probabilities
        )
    ]


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def merge_punctuations(alignment: List[WordTiming], prepended: str, appended: str) -> None:
    """Fold leading/trailing punctuation into neighbor words (reference
    whisper/timing.py merge_punctuations)."""
    i, j = len(alignment) - 2, len(alignment) - 1
    while i >= 0:
        prev, nxt = alignment[i], alignment[j]
        if prev.word.startswith(" ") and prev.word.strip() in prepended:
            nxt.word = prev.word + nxt.word
            nxt.tokens = prev.tokens + nxt.tokens
            prev.word = ""
            prev.tokens = []
        else:
            j = i
        i -= 1

    i, j = 0, 1
    while j < len(alignment):
        prev, nxt = alignment[i], alignment[j]
        if not prev.word.endswith(" ") and nxt.word in appended:
            prev.word = prev.word + nxt.word
            prev.tokens = prev.tokens + nxt.tokens
            nxt.word = ""
            nxt.tokens = []
        else:
            i = j
        j += 1


def add_word_timestamps(
    *,
    segments: List[dict],
    model: wm.Whisper,
    dims: ModelDimensions,
    align: wm.AlignSpec,
    tokenizer: Tokenizer,
    mel: torch.Tensor,
    num_frames: int,
    prepend_punctuations: str = "\"'“¿([{-",
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
    last_speech_timestamp: float = 0.0,
    **kwargs,
) -> float:
    """Attach word dicts to segments; returns updated last_speech_timestamp."""
    if len(segments) == 0:
        return last_speech_timestamp

    text_tokens_per_segment = [
        [t for t in segment["tokens"] if t < tokenizer.eot] for segment in segments
    ]
    text_tokens = list(itertools.chain.from_iterable(text_tokens_per_segment))
    alignment = find_alignment(
        model, dims, align, tokenizer, text_tokens, mel, num_frames, **kwargs
    )
    word_durations = np.array([t.end - t.start for t in alignment])
    word_durations = word_durations[word_durations.nonzero()]
    median_duration = float(np.median(word_durations)) if len(word_durations) > 0 else 0.0
    median_duration = min(0.7, median_duration)
    max_duration = median_duration * 2

    if len(word_durations) > 0:
        sentence_end_marks = ".。!！?？"
        for i in range(1, len(alignment)):
            if alignment[i].end - alignment[i].start > max_duration:
                if alignment[i].word in sentence_end_marks:
                    alignment[i].end = alignment[i].start + max_duration
                elif alignment[i - 1].word in sentence_end_marks:
                    alignment[i].start = alignment[i].end - max_duration

    merge_punctuations(alignment, prepend_punctuations, append_punctuations)

    time_offset = segments[0]["seek"] * HOP_LENGTH / SAMPLE_RATE
    word_index = 0

    for segment, seg_text_tokens in zip(segments, text_tokens_per_segment):
        saved_tokens = 0
        words = []
        while word_index < len(alignment) and saved_tokens < len(seg_text_tokens):
            timing = alignment[word_index]
            if timing.word:
                words.append(
                    dict(
                        word=timing.word,
                        start=round(time_offset + timing.start, 2),
                        end=round(time_offset + timing.end, 2),
                        probability=timing.probability,
                    )
                )
            saved_tokens += len(timing.tokens)
            word_index += 1

        if len(words) > 0:
            # pause-boundary truncation heuristics (reference parity)
            if words[0]["end"] - last_speech_timestamp > median_duration * 4 and (
                words[0]["end"] - words[0]["start"] > max_duration
                or (len(words) > 1 and words[1]["end"] - words[0]["start"] > max_duration * 2)
            ):
                if len(words) > 1 and words[1]["end"] - words[1]["start"] > max_duration:
                    boundary = max(words[1]["end"] / 2, words[1]["end"] - max_duration)
                    words[0]["end"] = words[1]["start"] = boundary
                words[0]["start"] = max(0, words[0]["end"] - max_duration)

            if segment["start"] < words[0]["end"] and segment["start"] - 0.5 > words[0]["start"]:
                words[0]["start"] = max(
                    0, min(words[0]["end"] - median_duration, segment["start"])
                )
            else:
                segment["start"] = words[0]["start"]

            if segment["end"] > words[-1]["start"] and segment["end"] + 0.5 < words[-1]["end"]:
                words[-1]["end"] = max(words[-1]["start"] + median_duration, segment["end"])
            else:
                segment["end"] = words[-1]["end"]

            last_speech_timestamp = segment["end"]

        segment["words"] = words
    return last_speech_timestamp
