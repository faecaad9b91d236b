"""Transcript writers: txt / srt / vtt / tsv / json (reference whisper/utils.py:85-318).

A host copy of whisperlivekit_tpu/decoding/writers.py.
"""

from __future__ import annotations

import json
from typing import IO, Callable


def format_timestamp(seconds: float, always_include_hours: bool = False, decimal_marker: str = ".") -> str:
    assert seconds >= 0
    ms = round(seconds * 1000.0)
    hours, ms = divmod(ms, 3_600_000)
    minutes, ms = divmod(ms, 60_000)
    secs, ms = divmod(ms, 1_000)
    hours_marker = f"{hours:02d}:" if always_include_hours or hours > 0 else ""
    return f"{hours_marker}{minutes:02d}:{secs:02d}{decimal_marker}{ms:03d}"


def write_txt(result: dict, file: IO[str]) -> None:
    for segment in result["segments"]:
        print(segment["text"].strip(), file=file, flush=True)


def write_srt(result: dict, file: IO[str]) -> None:
    for i, segment in enumerate(result["segments"], start=1):
        print(
            f"{i}\n"
            f"{format_timestamp(segment['start'], True, ',')} --> "
            f"{format_timestamp(segment['end'], True, ',')}\n"
            f"{segment['text'].strip().replace('-->', '->')}\n",
            file=file,
            flush=True,
        )


def write_vtt(result: dict, file: IO[str]) -> None:
    print("WEBVTT\n", file=file)
    for segment in result["segments"]:
        print(
            f"{format_timestamp(segment['start'])} --> {format_timestamp(segment['end'])}\n"
            f"{segment['text'].strip().replace('-->', '->')}\n",
            file=file,
            flush=True,
        )


def write_tsv(result: dict, file: IO[str]) -> None:
    print("start", "end", "text", sep="\t", file=file)
    for segment in result["segments"]:
        print(
            round(1000 * segment["start"]),
            round(1000 * segment["end"]),
            segment["text"].strip().replace("\t", " "),
            sep="\t",
            file=file,
            flush=True,
        )


def write_json(result: dict, file: IO[str]) -> None:
    json.dump(result, file, ensure_ascii=False)


WRITERS: dict[str, Callable[[dict, IO[str]], None]] = {
    "txt": write_txt,
    "text": write_txt,
    "srt": write_srt,
    "vtt": write_vtt,
    "tsv": write_tsv,
    "json": write_json,
}


def get_writer(output_format: str) -> Callable[[dict, IO[str]], None]:
    if output_format not in WRITERS:
        raise ValueError(f"unknown output format {output_format!r}; options: {sorted(WRITERS)}")
    return WRITERS[output_format]
