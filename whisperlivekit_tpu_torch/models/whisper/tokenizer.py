"""Whisper BPE tokenizer on tiktoken, with streaming word-splitting.

Behavioral parity target: reference whisper/tokenizer.py:132-400 — same
special-token layout (sot + 100 language tokens + task tokens + 1501
timestamp tokens), same suppression sets, and the same word-splitting rules
used for word-level timestamps (unicode split for space-less scripts,
space split elsewhere).

BPE rank files (``gpt2.tiktoken`` / ``multilingual.tiktoken``) are public
OpenAI data and are *not* vendored; they are resolved from, in order:
``$WLK_TPU_ASSET_DIR``, the package ``assets/`` dir, the JAX package's
``assets/`` dir (read as a plain path, not imported), an installed
``openai-whisper`` package, or a reference checkout pointed at by
``$WLK_REFERENCE_DIR``. ``scripts/fetch_assets.py`` downloads them when
network access exists.

(The port's copy of whisperlivekit_tpu/models/whisper/tokenizer.py.)
"""

from __future__ import annotations

import base64
import os
import string
from dataclasses import dataclass, field
from functools import cached_property, lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import tiktoken

from .languages import LANGUAGES, TO_LANGUAGE_CODE, normalize_language

_ASSET_NAMES = {"gpt2": "gpt2.tiktoken", "multilingual": "multilingual.tiktoken"}

# Scripts written without spaces between words: word boundaries must be
# recovered from unicode codepoints rather than whitespace.
_UNICODE_SPLIT_LANGUAGES = {"zh", "ja", "th", "lo", "my", "yue"}


def _candidate_asset_dirs() -> List[Path]:
    dirs: List[Path] = []
    env = os.environ.get("WLK_TPU_ASSET_DIR")
    if env:
        dirs.append(Path(env))
    here = Path(__file__).resolve().parent
    dirs.append(here / "assets")
    # the JAX package's assets, a file read beside this package (no import)
    dirs.append(here.parents[2] / "whisperlivekit_tpu" / "models" / "whisper" / "assets")
    try:  # installed openai-whisper package, if any
        import whisper  # type: ignore

        dirs.append(Path(whisper.__file__).parent / "assets")
    except Exception:
        pass
    ref = os.environ.get("WLK_REFERENCE_DIR")
    if ref:
        dirs.append(Path(ref) / "whisperlivekit" / "whisper" / "assets")
    return dirs


def find_vocab_file(name: str) -> Path:
    fname = _ASSET_NAMES[name]
    for d in _candidate_asset_dirs():
        p = d / fname
        if p.is_file():
            return p
    raise FileNotFoundError(
        f"tokenizer vocab {fname} not found; set WLK_TPU_ASSET_DIR or run "
        "scripts/fetch_assets.py to download public assets"
    )


@lru_cache(maxsize=None)
def get_encoding(name: str = "gpt2", num_languages: int = 99) -> tiktoken.Encoding:
    vocab_path = find_vocab_file(name)
    ranks: Dict[bytes, int] = {}
    with open(vocab_path) as f:
        for line in f:
            if not line.strip():
                continue
            token, rank = line.split()
            ranks[base64.b64decode(token)] = int(rank)
    n_vocab = len(ranks)

    specials = [
        "<|endoftext|>",
        "<|startoftranscript|>",
        *[f"<|{lang}|>" for lang in list(LANGUAGES)[:num_languages]],
        "<|translate|>",
        "<|transcribe|>",
        "<|startoflm|>",
        "<|startofprev|>",
        "<|nospeech|>",
        "<|notimestamps|>",
        *[f"<|{i * 0.02:.2f}|>" for i in range(1501)],
    ]
    special_tokens = {tok: n_vocab + i for i, tok in enumerate(specials)}

    return tiktoken.Encoding(
        name=vocab_path.name,
        explicit_n_vocab=n_vocab + len(specials),
        pat_str=r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""",
        mergeable_ranks=ranks,
        special_tokens=special_tokens,
    )


@dataclass
class Tokenizer:
    """Access to Whisper special tokens + text codec for one (language, task)."""

    encoding: tiktoken.Encoding
    num_languages: int = 99
    language: Optional[str] = None
    task: Optional[str] = None
    sot_sequence: Tuple[int, ...] = ()
    special_tokens: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self) -> None:
        for special in self.encoding.special_tokens_set:
            self.special_tokens[special] = self.encoding.encode_single_token(special)
        sot = self.special_tokens["<|startoftranscript|>"]
        seq = [sot]
        if self.language is not None:
            seq.append(self.to_language_token(self.language))
        if self.task is not None:
            seq.append(self.special_tokens[f"<|{self.task}|>"])
        self.sot_sequence = tuple(seq)

    # ---- codec -----------------------------------------------------------

    def encode(self, text: str, **kwargs) -> List[int]:
        return self.encoding.encode(text, **kwargs)

    def decode(self, token_ids: List[int], **kwargs) -> str:
        ids = [t for t in token_ids if t < self.timestamp_begin]
        return self.encoding.decode(ids, **kwargs)

    def decode_with_timestamps(self, token_ids: List[int], **kwargs) -> str:
        parts: List[str] = []
        chunk: List[int] = []
        for t in token_ids:
            if t >= self.timestamp_begin:
                if chunk:
                    parts.append(self.encoding.decode(chunk, **kwargs))
                    chunk = []
                parts.append(f"<|{(t - self.timestamp_begin) * 0.02:.2f}|>")
            else:
                chunk.append(t)
        if chunk:
            parts.append(self.encoding.decode(chunk, **kwargs))
        return "".join(parts)

    def decode_bytes(self, token_ids: List[int]) -> bytes:
        """Raw byte decode — needed by the streaming UTF-8 carry-over logic."""
        ids = [t for t in token_ids if t < self.timestamp_begin]
        return self.encoding.decode_bytes(ids)

    # ---- special tokens ----------------------------------------------------

    @cached_property
    def eot(self) -> int:
        return self.special_tokens["<|endoftext|>"]

    @cached_property
    def sot(self) -> int:
        return self.special_tokens["<|startoftranscript|>"]

    @cached_property
    def transcribe(self) -> int:
        return self.special_tokens["<|transcribe|>"]

    @cached_property
    def translate(self) -> int:
        return self.special_tokens["<|translate|>"]

    @cached_property
    def sot_lm(self) -> int:
        return self.special_tokens["<|startoflm|>"]

    @cached_property
    def sot_prev(self) -> int:
        return self.special_tokens["<|startofprev|>"]

    @cached_property
    def no_speech(self) -> int:
        return self.special_tokens["<|nospeech|>"]

    @cached_property
    def no_timestamps(self) -> int:
        return self.special_tokens["<|notimestamps|>"]

    @cached_property
    def timestamp_begin(self) -> int:
        return self.special_tokens["<|0.00|>"]

    @cached_property
    def sot_sequence_including_notimestamps(self) -> Tuple[int, ...]:
        return tuple(self.sot_sequence) + (self.no_timestamps,)

    def to_language_token(self, language: str) -> int:
        tok = self.special_tokens.get(f"<|{language}|>")
        if tok is None:
            raise KeyError(f"language {language!r} not in vocabulary")
        return tok

    @cached_property
    def all_language_tokens(self) -> Tuple[int, ...]:
        return tuple(
            tid
            for tok, tid in self.special_tokens.items()
            if tok.strip("<|>") in LANGUAGES
        )[: self.num_languages]

    @cached_property
    def all_language_codes(self) -> Tuple[str, ...]:
        return tuple(self._token_to_code(t) for t in self.all_language_tokens)

    def _token_to_code(self, token_id: int) -> str:
        for tok, tid in self.special_tokens.items():
            if tid == token_id:
                return tok.strip("<|>")
        raise KeyError(token_id)

    @cached_property
    def language_token(self) -> int:
        if self.language is None:
            raise ValueError("tokenizer has no language specified")
        return self.to_language_token(self.language)

    # ---- suppression sets ----------------------------------------------------

    @cached_property
    def non_speech_tokens(self) -> Tuple[int, ...]:
        """Tokens for speaker tags / sound annotations, suppressed during
        decoding so the model only emits spoken words (parity with reference
        whisper/tokenizer.py:236-268)."""
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
        symbols += "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split()
        miscellaneous = set("♩♪♫♬♭♮♯")

        result = {self.encoding.encode(" -")[0], self.encoding.encode(" '")[0]}
        for symbol in symbols + list(miscellaneous):
            for tokens in (self.encoding.encode(symbol), self.encoding.encode(" " + symbol)):
                if len(tokens) == 1 or symbol in miscellaneous:
                    result.add(tokens[0])
        return tuple(sorted(result))

    # ---- word splitting ----------------------------------------------------

    def split_to_word_tokens(self, tokens: List[int]) -> Tuple[List[str], List[List[int]]]:
        if self.language in _UNICODE_SPLIT_LANGUAGES:
            return self.split_tokens_on_unicode(tokens)
        return self.split_tokens_on_spaces(tokens)

    def split_tokens_on_unicode(self, tokens: List[int]) -> Tuple[List[str], List[List[int]]]:
        decoded_full = self.decode_with_timestamps(tokens)
        replacement = "�"

        words: List[str] = []
        word_tokens: List[List[int]] = []
        current: List[int] = []
        unicode_offset = 0

        for token in tokens:
            current.append(token)
            decoded = self.decode_with_timestamps(current)
            if (
                replacement not in decoded
                or decoded_full[unicode_offset + decoded.index(replacement)] == replacement
            ):
                words.append(decoded)
                word_tokens.append(current)
                current = []
                unicode_offset += len(decoded)
        if current:  # trailing incomplete utf-8 sequence
            words.append(self.decode_with_timestamps(current))
            word_tokens.append(current)
        return words, word_tokens

    def split_tokens_on_spaces(self, tokens: List[int]) -> Tuple[List[str], List[List[int]]]:
        subwords, subword_tokens = self.split_tokens_on_unicode(tokens)
        words: List[str] = []
        word_tokens: List[List[int]] = []
        for subword, sub_toks in zip(subwords, subword_tokens):
            special = sub_toks[0] >= self.eot
            with_space = subword.startswith(" ")
            punctuation = subword.strip() in string.punctuation
            if special or with_space or punctuation or not words:
                words.append(subword)
                word_tokens.append(list(sub_toks))
            else:
                words[-1] += subword
                word_tokens[-1].extend(sub_toks)
        return words, word_tokens


@lru_cache(maxsize=None)
def get_tokenizer(
    multilingual: bool,
    *,
    num_languages: int = 99,
    language: Optional[str] = None,
    task: Optional[str] = None,
) -> Tokenizer:
    if language is not None:
        language = normalize_language(language)
    if multilingual:
        encoding_name = "multilingual"
        language = language or "en"
        task = task or "transcribe"
    else:
        encoding_name = "gpt2"
        language = None
        task = None
    encoding = get_encoding(name=encoding_name, num_languages=num_languages)
    return Tokenizer(
        encoding=encoding, num_languages=num_languages, language=language, task=task
    )


__all__ = [
    "LANGUAGES",
    "TO_LANGUAGE_CODE",
    "Tokenizer",
    "get_encoding",
    "get_tokenizer",
    "normalize_language",
]
