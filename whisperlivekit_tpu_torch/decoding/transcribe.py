"""Offline windowed transcription (reference whisper/transcribe.py:21-606;
port of whisperlivekit_tpu/decoding/transcribe.py).

The 30 s seek loop, temperature fallback ladder, quality gating
(compression ratio / avg logprob / no-speech), timestamp-pair segmentation,
prompt conditioning, clip windows, hallucination-silence skipping, and
optional DTW word timestamps — driving the encode/decode of models/whisper
on the model's device via the WhisperDecoder task. The mel is the plain
audio/mel.py front end over the whole file, on the model's device.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..audio.mel import (
    FRAMES_PER_SECOND,
    HOP_LENGTH,
    N_FRAMES,
    N_SAMPLES,
    SAMPLE_RATE,
    log_mel_spectrogram,
    pad_or_trim,
)
from ..models.whisper import model as wm
from ..models.whisper.dims import default_alignment_heads
from .options import DecodingOptions, DecodingResult
from .task import WhisperDecoder

logger = logging.getLogger(__name__)


def transcribe(
    decoder: WhisperDecoder,
    audio: np.ndarray,
    *,
    verbose: Optional[bool] = None,
    temperature: Union[float, Sequence[float]] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
    compression_ratio_threshold: Optional[float] = 2.4,
    logprob_threshold: Optional[float] = -1.0,
    no_speech_threshold: Optional[float] = 0.6,
    condition_on_previous_text: bool = True,
    initial_prompt: Optional[str] = None,
    carry_initial_prompt: bool = False,
    word_timestamps: bool = False,
    prepend_punctuations: str = "\"'“¿([{-",
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
    clip_timestamps: Union[str, Sequence[float]] = "0",
    hallucination_silence_threshold: Optional[float] = None,
    model_name: Optional[str] = None,
    **decode_options,
) -> dict:
    dims = decoder.dims
    mel_full = log_mel_spectrogram(
        torch.as_tensor(np.asarray(audio, np.float32), device=decoder.model.device),
        n_mels=dims.n_mels, padding=N_SAMPLES,
    )
    content_frames = mel_full.shape[-1] - N_FRAMES
    content_duration = float(content_frames * HOP_LENGTH / SAMPLE_RATE)

    language = decode_options.get("language")
    if language is None:
        if not dims.multilingual:
            language = "en"
        else:
            enc = decoder.encode(pad_or_trim(mel_full[..., :N_FRAMES], N_FRAMES))
            codes, probs = decoder.detect_language(
                enc, decoder.tokenizer_for("en", decode_options.get("task", "transcribe"))
            )
            language = codes[0]
            if verbose:
                print(f"Detected language: {language}")
    decode_options["language"] = language
    task = decode_options.get("task", "transcribe")
    tokenizer = decoder.tokenizer_for(language, task)

    align = None
    if word_timestamps:
        align = wm.AlignSpec.from_pairs(
            default_alignment_heads(dims, model_name), device=decoder.model.device
        )

    if isinstance(temperature, (int, float)):
        temperatures = [float(temperature)]
    else:
        temperatures = list(temperature)

    def decode_with_fallback(segment: torch.Tensor) -> DecodingResult:
        result = None
        for t in temperatures:
            kwargs = dict(decode_options)
            if t > 0:
                kwargs.pop("beam_size", None)
                kwargs.pop("patience", None)
            else:
                kwargs.pop("best_of", None)
            opt_fields = {
                k: v
                for k, v in kwargs.items()
                if k in DecodingOptions.__dataclass_fields__
            }
            options = DecodingOptions(**opt_fields, temperature=t)
            result = decoder.decode(segment[None], options)[0]

            needs_fallback = False
            if (
                compression_ratio_threshold is not None
                and result.compression_ratio > compression_ratio_threshold
            ):
                needs_fallback = True
            if logprob_threshold is not None and result.avg_logprob < logprob_threshold:
                needs_fallback = True
            if (
                no_speech_threshold is not None
                and result.no_speech_prob > no_speech_threshold
                and logprob_threshold is not None
                and result.avg_logprob < logprob_threshold
            ):
                needs_fallback = False  # silence: don't bother retrying
            if not needs_fallback:
                break
        return result

    # clip windows (reference transcribe.py:151-157,255-266)
    if isinstance(clip_timestamps, str):
        clip_list = [float(ts) for ts in (clip_timestamps.split(",") if clip_timestamps else [])]
    else:
        clip_list = list(clip_timestamps)
    seek_points = [round(ts * FRAMES_PER_SECOND) for ts in clip_list]
    if len(seek_points) == 0:
        seek_points.append(0)
    if len(seek_points) % 2 == 1:
        seek_points.append(content_frames)
    seek_clips = list(zip(seek_points[::2], seek_points[1::2]))
    clip_idx = 0

    seek = seek_clips[0][0]
    input_stride = 2  # mel frames per encoder output frame
    time_precision = input_stride * HOP_LENGTH / SAMPLE_RATE  # 0.02 s
    punctuation_chars = prepend_punctuations + append_punctuations

    all_tokens: List[int] = []
    all_segments: List[dict] = []
    prompt_reset_since = 0

    remaining_prompt_length = dims.n_text_ctx // 2 - 1
    if initial_prompt is not None:
        initial_prompt_tokens = tokenizer.encode(" " + initial_prompt.strip())
        all_tokens.extend(initial_prompt_tokens)
        remaining_prompt_length -= len(initial_prompt_tokens)
    else:
        initial_prompt_tokens = []

    def new_segment(*, start: float, end: float, tokens: List[int], result: DecodingResult):
        text_tokens = [t for t in tokens if t < tokenizer.eot]
        return {
            "seek": seek,
            "start": start,
            "end": end,
            "text": tokenizer.decode(text_tokens),
            "tokens": tokens,
            "temperature": result.temperature,
            "avg_logprob": result.avg_logprob,
            "compression_ratio": result.compression_ratio,
            "no_speech_prob": result.no_speech_prob,
        }

    # hallucination heuristics (reference transcribe.py:299-321)
    def word_anomaly_score(word: dict) -> float:
        probability = word.get("probability") or 0.0
        duration = word["end"] - word["start"]
        score = 0.0
        if probability < 0.15:
            score += 1.0
        if duration < 0.133:
            score += (0.133 - duration) * 15
        if duration > 2.0:
            score += duration - 2.0
        return score

    def is_segment_anomaly(segment: Optional[dict]) -> bool:
        if segment is None or not segment.get("words"):
            return False
        words = [w for w in segment["words"] if w["word"] not in punctuation_chars][:8]
        if not words:
            return False
        score = sum(word_anomaly_score(w) for w in words)
        return score >= 3 or score + 0.01 >= len(words)

    def next_words_segment(segments: List[dict]) -> Optional[dict]:
        return next((s for s in segments if s.get("words")), None)

    def get_end(segments: List[dict]) -> Optional[float]:
        return next(
            (w["end"] for s in reversed(segments) for w in reversed(s.get("words", []))),
            None,
        )

    last_speech_timestamp = 0.0
    while clip_idx < len(seek_clips):
        seek_clip_start, seek_clip_end = seek_clips[clip_idx]
        if seek < seek_clip_start:
            seek = seek_clip_start
        if seek >= min(seek_clip_end, content_frames):
            clip_idx += 1
            if clip_idx < len(seek_clips):
                seek = seek_clips[clip_idx][0]
            continue
        time_offset = float(seek * HOP_LENGTH / SAMPLE_RATE)
        window_end_time = float((seek + N_FRAMES) * HOP_LENGTH / SAMPLE_RATE)
        segment_size = min(N_FRAMES, content_frames - seek, seek_clip_end - seek)
        mel_segment = mel_full[..., seek : seek + segment_size]
        segment_duration = segment_size * HOP_LENGTH / SAMPLE_RATE
        mel_segment = pad_or_trim(mel_segment, N_FRAMES)

        if carry_initial_prompt:
            nignored = max(len(initial_prompt_tokens), prompt_reset_since)
            remaining = all_tokens[nignored:][-remaining_prompt_length:]
            decode_options["prompt"] = initial_prompt_tokens + remaining
        else:
            decode_options["prompt"] = all_tokens[prompt_reset_since:]

        result = decode_with_fallback(mel_segment)
        tokens = np.array(result.tokens)

        if no_speech_threshold is not None:
            should_skip = result.no_speech_prob > no_speech_threshold
            if logprob_threshold is not None and result.avg_logprob > logprob_threshold:
                should_skip = False
            if should_skip:
                seek += segment_size
                continue

        previous_seek = seek
        current_segments: List[dict] = []

        timestamp_tokens = tokens >= tokenizer.timestamp_begin
        single_timestamp_ending = (
            len(timestamp_tokens) >= 2
            and bool(timestamp_tokens[-2:].tolist() == [False, True])
        )

        consecutive = np.where(np.logical_and(timestamp_tokens[:-1], timestamp_tokens[1:]))[0]
        consecutive += 1
        if len(consecutive) > 0:
            slices = consecutive.tolist()
            if single_timestamp_ending:
                slices.append(len(tokens))
            last_slice = 0
            for current_slice in slices:
                sliced_tokens = tokens[last_slice:current_slice]
                start_pos = int(sliced_tokens[0]) - tokenizer.timestamp_begin
                end_pos = int(sliced_tokens[-1]) - tokenizer.timestamp_begin
                current_segments.append(
                    new_segment(
                        start=time_offset + start_pos * time_precision,
                        end=time_offset + end_pos * time_precision,
                        tokens=sliced_tokens.tolist(),
                        result=result,
                    )
                )
                last_slice = current_slice
            if single_timestamp_ending:
                seek += segment_size
            else:
                last_pos = int(tokens[last_slice - 1]) - tokenizer.timestamp_begin
                seek += last_pos * input_stride
        else:
            duration = segment_duration
            ts = tokens[timestamp_tokens]
            if len(ts) > 0 and int(ts[-1]) != tokenizer.timestamp_begin:
                duration = (int(ts[-1]) - tokenizer.timestamp_begin) * time_precision
            current_segments.append(
                new_segment(
                    start=time_offset,
                    end=time_offset + duration,
                    tokens=tokens.tolist(),
                    result=result,
                )
            )
            seek += segment_size

        if word_timestamps:
            from .timing import add_word_timestamps

            last_speech_timestamp = add_word_timestamps(
                segments=current_segments,
                model=decoder.model,
                dims=dims,
                align=align,
                tokenizer=tokenizer,
                mel=mel_segment,
                num_frames=segment_size,
                prepend_punctuations=prepend_punctuations,
                append_punctuations=append_punctuations,
                last_speech_timestamp=last_speech_timestamp,
            )
            if not single_timestamp_ending:
                last_word_end = get_end(current_segments)
                if last_word_end is not None and last_word_end > time_offset:
                    seek = round(last_word_end * FRAMES_PER_SECOND)

            # skip silence before possible hallucinations
            # (reference transcribe.py:401-456)
            if hallucination_silence_threshold is not None:
                threshold = hallucination_silence_threshold
                if not single_timestamp_ending:
                    last_word_end = get_end(current_segments)
                    if last_word_end is not None and last_word_end > time_offset:
                        remaining_duration = window_end_time - last_word_end
                        if remaining_duration > threshold:
                            seek = round(last_word_end * FRAMES_PER_SECOND)
                        else:
                            seek = previous_seek + segment_size

                first_segment = next_words_segment(current_segments)
                if first_segment is not None and is_segment_anomaly(first_segment):
                    gap = first_segment["start"] - time_offset
                    if gap > threshold:
                        seek = previous_seek + round(gap * FRAMES_PER_SECOND)
                        continue

                hal_last_end = last_speech_timestamp
                for si, segment in enumerate(current_segments):
                    if not segment.get("words"):
                        continue
                    if is_segment_anomaly(segment):
                        next_segment = next_words_segment(current_segments[si + 1 :])
                        if next_segment is not None:
                            hal_next_start = next_segment["words"][0]["start"]
                        else:
                            hal_next_start = time_offset + segment_duration
                        silence_before = (
                            segment["start"] - hal_last_end > threshold
                            or segment["start"] < threshold
                            or segment["start"] - time_offset < 2.0
                        )
                        silence_after = (
                            hal_next_start - segment["end"] > threshold
                            or is_segment_anomaly(next_segment)
                            or window_end_time - segment["end"] < 2.0
                        )
                        if silence_before and silence_after:
                            seek = round(
                                max(time_offset + 1, segment["start"]) * FRAMES_PER_SECOND
                            )
                            if content_duration - segment["end"] < threshold:
                                seek = content_frames
                            current_segments[si:] = []
                            break
                    hal_last_end = segment["end"]

            last_word_end = get_end(current_segments)
            if last_word_end is not None:
                last_speech_timestamp = last_word_end

        for segment in current_segments:
            if verbose:
                print(f"[{segment['start']:.2f} -> {segment['end']:.2f}] {segment['text']}")
            if segment["start"] == segment["end"] or segment["text"].strip() == "":
                segment["text"] = ""
                segment["tokens"] = []
                segment["words"] = []
            all_tokens.extend(segment["tokens"])

        all_segments.extend(
            [
                {"id": i, **seg}
                for i, seg in enumerate(current_segments, start=len(all_segments))
            ]
        )

        if not condition_on_previous_text or result.temperature > 0.5:
            prompt_reset_since = len(all_tokens)

    return {
        "text": tokenizer.decode(all_tokens[len(initial_prompt_tokens) :]),
        "segments": all_segments,
        "language": language,
        "duration": content_duration,
    }
