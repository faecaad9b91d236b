"""Evaluation text normalizers (WER methodology compatibility).

Behavioral parity targets: the reference's vendored OpenAI normalizers
(reference whisper/normalizers/basic.py and english.py:1-560). Published
Whisper WERs are computed after EnglishTextNormalizer; numbers produced
without it are not comparable (round-1 VERDICT item 5). Parity is pinned by
tests/test_normalizers.py against the reference implementation as oracle.

The implementation is restructured: number-word tables are generated from
compact word lists, and the spoken-number transducer is a class with one
handler method per token category instead of a single generator.

A host copy of whisperlivekit_tpu/harness/normalizers.py (``english.json`` is
searched in the same order; ``regex`` stays optional); tests/test_torch_harness.py
holds it to the original.
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
from fractions import Fraction
from pathlib import Path
from typing import Iterator, List, Optional, Union

# ---------------------------------------------------------------------------
# Unicode cleanup
# ---------------------------------------------------------------------------

#: Non-ASCII letters that NFKD does not decompose to ASCII + marks.
_LETTER_FALLBACKS = {
    "œ": "oe", "Œ": "OE", "ø": "o", "Ø": "O", "æ": "ae", "Æ": "AE",
    "ß": "ss", "ẞ": "SS", "đ": "d", "Đ": "D", "ð": "d", "Ð": "D",
    "þ": "th", "Þ": "th", "ł": "l", "Ł": "L",
}


def remove_symbols_and_diacritics(s: str, keep: str = "") -> str:
    """Symbols/punctuation → space; combining marks dropped; special letters
    transliterated (NFKD form)."""
    out = []
    for c in unicodedata.normalize("NFKD", s):
        if c in keep:
            out.append(c)
        elif c in _LETTER_FALLBACKS:
            out.append(_LETTER_FALLBACKS[c])
        else:
            cat = unicodedata.category(c)
            if cat == "Mn":
                continue
            out.append(" " if cat[0] in "MSP" else c)
    return "".join(out)


def remove_symbols(s: str) -> str:
    """Symbols/punctuation → space, diacritics kept (NFKC form)."""
    return "".join(
        " " if unicodedata.category(c)[0] in "MSP" else c
        for c in unicodedata.normalize("NFKC", s)
    )


class BasicTextNormalizer:
    def __init__(self, remove_diacritics: bool = False, split_letters: bool = False):
        self.clean = remove_symbols_and_diacritics if remove_diacritics else remove_symbols
        self.split_letters = split_letters

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)
        s = re.sub(r"\(([^)]+?)\)", "", s)
        s = self.clean(s).lower()
        if self.split_letters:
            try:
                import regex

                s = " ".join(regex.findall(r"\X", s, regex.U))
            except ImportError:  # grapheme split needs the 'regex' package
                s = " ".join(s)
        s = re.sub(r"\s+", " ", s)
        return s


# ---------------------------------------------------------------------------
# Spoken-number transducer
# ---------------------------------------------------------------------------

_ONES_WORDS = (
    "one two three four five six seven eight nine ten eleven twelve thirteen "
    "fourteen fifteen sixteen seventeen eighteen nineteen"
).split()
_TENS_WORDS = "twenty thirty forty fifty sixty seventy eighty ninety".split()
_MULT_WORDS = (
    "hundred thousand million billion trillion quadrillion quintillion "
    "sextillion septillion octillion nonillion decillion"
).split()
_IRREGULAR_ORDINALS = {
    "one": ("first", "st"), "two": ("second", "nd"), "three": ("third", "rd"),
    "five": ("fifth", "th"), "twelve": ("twelfth", "th"),
}
_NUMERIC = re.compile(r"^\d+(\.\d+)?$")


def _ones_tables():
    ones = {w: i for i, w in enumerate(_ONES_WORDS, start=1)}
    plural = {("sixes" if w == "six" else w + "s"): (v, "s") for w, v in ones.items()}
    ordinal = {"zeroth": (0, "th")}
    for w, v in ones.items():
        if w in _IRREGULAR_ORDINALS:
            name, suf = _IRREGULAR_ORDINALS[w]
            ordinal[name] = (v, suf)
        else:
            ordinal[w + ("h" if w.endswith("t") else "th")] = (v, "th")
    return ones, {**plural, **ordinal}


def _tens_tables():
    tens = {w: 10 * (i + 2) for i, w in enumerate(_TENS_WORDS)}
    suffixed = {w.replace("y", "ies"): (v, "s") for w, v in tens.items()}
    suffixed.update({w.replace("y", "ieth"): (v, "th") for w, v in tens.items()})
    return tens, suffixed


def _mult_tables():
    mult = {w: 10 ** (2 if i == 0 else 3 * i) for i, w in enumerate(_MULT_WORDS)}
    suffixed = {w + "s": (v, "s") for w, v in mult.items()}
    suffixed.update({w + "th": (v, "th") for w, v in mult.items()})
    return mult, suffixed


class _NumberParse:
    """One pass over the word stream: accumulates a pending numeric value
    (int while arithmetic composition holds, str once digits concatenate)
    plus an optional currency/sign prefix, and emits finished chunks."""

    def __init__(self, vocab: "EnglishNumberNormalizer"):
        self.v = vocab
        self.prefix: Optional[str] = None
        self.value: Optional[Union[str, int]] = None

    # -- emission ----------------------------------------------------------

    def emit(self, result: Union[str, int]) -> str:
        text = str(result)
        if self.prefix is not None:
            text = self.prefix + text
        self.prefix = None
        self.value = None
        return text

    def flush(self) -> Iterator[str]:
        if self.value is not None:
            yield self.emit(self.value)

    # -- per-category handlers (each yields finished outputs) ---------------

    def on_numeric(self, prev, cur, nxt) -> Iterator[str]:
        has_prefix = cur[0] in self.v.prefixes
        bare = cur[1:] if has_prefix else cur
        if self.value is not None:
            if isinstance(self.value, str) and self.value.endswith("."):
                # decimal / ip-address style concatenation
                self.value = str(self.value) + str(cur)
                return
            yield self.emit(self.value)
        if has_prefix:
            self.prefix = cur[0]
        f = Fraction(bare)
        self.value = f.numerator if f.denominator == 1 else bare

    def on_zero(self, prev, cur, nxt) -> None:
        self.value = str(self.value or "") + "0"

    def on_ones(self, prev, cur, nxt) -> None:
        ones = self.v.ones[cur]
        value = self.value
        if value is None:
            self.value = ones
        elif isinstance(value, str) or prev in self.v.ones:
            if prev in self.v.tens and ones < 10:  # twenty one -> 21
                self.value = value[:-1] + str(ones)
            else:
                self.value = str(value) + str(ones)
        elif ones < 10:
            self.value = value + ones if value % 10 == 0 else str(value) + str(ones)
        else:  # eleven..nineteen
            self.value = value + ones if value % 100 == 0 else str(value) + str(ones)

    def on_ones_suffixed(self, prev, cur, nxt) -> Iterator[str]:
        ones, suffix = self.v.ones_suffixed[cur]
        value = self.value
        if value is None:
            yield self.emit(str(ones) + suffix)
        elif isinstance(value, str) or prev in self.v.ones:
            if prev in self.v.tens and ones < 10:
                yield self.emit(value[:-1] + str(ones) + suffix)
            else:
                yield self.emit(str(value) + str(ones) + suffix)
        elif ones < 10:
            if value % 10 == 0:
                yield self.emit(str(value + ones) + suffix)
            else:
                yield self.emit(str(value) + str(ones) + suffix)
        else:
            if value % 100 == 0:
                yield self.emit(str(value + ones) + suffix)
            else:
                yield self.emit(str(value) + str(ones) + suffix)
        self.value = None

    def on_tens(self, prev, cur, nxt) -> None:
        tens = self.v.tens[cur]
        value = self.value
        if value is None:
            self.value = tens
        elif isinstance(value, str):
            self.value = str(value) + str(tens)
        else:
            self.value = value + tens if value % 100 == 0 else str(value) + str(tens)

    def on_tens_suffixed(self, prev, cur, nxt) -> Iterator[str]:
        tens, suffix = self.v.tens_suffixed[cur]
        value = self.value
        if value is None:
            yield self.emit(str(tens) + suffix)
        elif isinstance(value, str):
            yield self.emit(str(value) + str(tens) + suffix)
        elif value % 100 == 0:
            yield self.emit(str(value + tens) + suffix)
        else:
            yield self.emit(str(value) + str(tens) + suffix)

    def on_multiplier(self, prev, cur, nxt) -> Iterator[str]:
        multiplier = self.v.multipliers[cur]
        value = self.value
        if value is None:
            self.value = multiplier
        elif isinstance(value, str) or value == 0:
            f = self._fraction(value)
            p = f * multiplier if f is not None else None
            if p is not None and p.denominator == 1:
                self.value = p.numerator
            else:
                yield self.emit(value)
                self.value = multiplier
        else:
            before = value // 1000 * 1000
            residual = value % 1000
            self.value = before + residual * multiplier

    def on_multiplier_suffixed(self, prev, cur, nxt) -> Iterator[str]:
        multiplier, suffix = self.v.multipliers_suffixed[cur]
        value = self.value
        if value is None:
            yield self.emit(str(multiplier) + suffix)
        elif isinstance(value, str):
            f = self._fraction(value)
            p = f * multiplier if f is not None else None
            if p is not None and p.denominator == 1:
                yield self.emit(str(p.numerator) + suffix)
            else:
                yield self.emit(value)
                yield self.emit(str(multiplier) + suffix)
        else:
            before = value // 1000 * 1000
            residual = value % 1000
            yield self.emit(str(before + residual * multiplier) + suffix)
        self.value = None

    def on_preceding_prefixer(self, prev, cur, nxt) -> Iterator[str]:
        if self.value is not None:
            yield self.emit(self.value)
        if nxt in self.v.words or self._numeric(nxt):
            self.prefix = self.v.preceding_prefixers[cur]
        else:
            yield self.emit(cur)

    def on_following_prefixer(self, prev, cur, nxt) -> Iterator[str]:
        if self.value is not None:
            self.prefix = self.v.following_prefixers[cur]
            yield self.emit(self.value)
        else:
            yield self.emit(cur)

    def on_suffixer(self, prev, cur, nxt):
        """Returns (outputs, skip_next)."""
        outputs, skip = [], False
        if self.value is not None:
            suffix = self.v.suffixers[cur]
            if isinstance(suffix, dict):
                if nxt in suffix:
                    outputs.append(self.emit(str(self.value) + suffix[nxt]))
                    skip = True
                else:
                    outputs.append(self.emit(self.value))
                    outputs.append(self.emit(cur))
            else:
                outputs.append(self.emit(str(self.value) + suffix))
        else:
            outputs.append(self.emit(cur))
        return outputs, skip

    def on_special(self, prev, cur, nxt):
        """Returns (outputs, skip_next)."""
        outputs, skip = [], False
        if nxt not in self.v.words and not self._numeric(nxt):
            if self.value is not None:
                outputs.append(self.emit(self.value))
            outputs.append(self.emit(cur))
        elif cur == "and":
            if prev not in self.v.multipliers:  # "hundred and one" keeps composing
                if self.value is not None:
                    outputs.append(self.emit(self.value))
                outputs.append(self.emit(cur))
        elif cur in ("double", "triple"):
            if nxt in self.v.ones or nxt in self.v.zeros:
                repeats = 2 if cur == "double" else 3
                digit = self.v.ones.get(nxt, 0)
                self.value = str(self.value or "") + str(digit) * repeats
                skip = True
            else:
                if self.value is not None:
                    outputs.append(self.emit(self.value))
                outputs.append(self.emit(cur))
        elif cur == "point":
            if nxt in self.v.decimals or self._numeric(nxt):
                self.value = str(self.value or "") + "."
        return outputs, skip

    # -- helpers ------------------------------------------------------------

    @staticmethod
    def _numeric(word: Optional[str]) -> bool:
        return word is not None and bool(_NUMERIC.match(word))

    @staticmethod
    def _fraction(s) -> Optional[Fraction]:
        try:
            return Fraction(s)
        except ValueError:
            return None


class EnglishNumberNormalizer:
    """Spell-out → arabic numerals, preserving suffixes (1960s, 274th) and
    currency composition ($20 million → 20000000 dollars → $20000000)."""

    def __init__(self) -> None:
        self.zeros = {"o", "oh", "zero"}
        self.ones, self.ones_suffixed = _ones_tables()
        self.tens, self.tens_suffixed = _tens_tables()
        self.multipliers, self.multipliers_suffixed = _mult_tables()
        self.decimals = {*self.ones, *self.tens, *self.zeros}
        self.preceding_prefixers = {
            "minus": "-", "negative": "-", "plus": "+", "positive": "+",
        }
        self.following_prefixers = {
            "pound": "£", "pounds": "£", "euro": "€", "euros": "€",
            "dollar": "$", "dollars": "$", "cent": "¢", "cents": "¢",
        }
        self.prefixes = set(self.preceding_prefixers.values()) | set(
            self.following_prefixers.values()
        )
        self.suffixers = {"per": {"cent": "%"}, "percent": "%"}
        self.specials = {"and", "double", "triple", "point"}
        self.words = set().union(
            self.zeros, self.ones, self.ones_suffixed, self.tens,
            self.tens_suffixed, self.multipliers, self.multipliers_suffixed,
            self.preceding_prefixers, self.following_prefixers,
            self.suffixers, self.specials,
        )

    def process_words(self, words: List[str]) -> Iterator[str]:
        if not words:
            return
        parse = _NumberParse(self)
        padded = [None] + list(words) + [None]
        skip = False
        for i in range(1, len(padded) - 1):
            if skip:
                skip = False
                continue
            prev, cur, nxt = padded[i - 1], padded[i], padded[i + 1]
            bare = cur[1:] if cur[0] in self.prefixes else cur
            if _NUMERIC.match(bare):
                yield from parse.on_numeric(prev, cur, nxt)
            elif cur not in self.words:
                yield from parse.flush()
                yield parse.emit(cur)
            elif cur in self.zeros:
                parse.on_zero(prev, cur, nxt)
            elif cur in self.ones:
                parse.on_ones(prev, cur, nxt)
            elif cur in self.ones_suffixed:
                yield from parse.on_ones_suffixed(prev, cur, nxt)
            elif cur in self.tens:
                parse.on_tens(prev, cur, nxt)
            elif cur in self.tens_suffixed:
                yield from parse.on_tens_suffixed(prev, cur, nxt)
            elif cur in self.multipliers:
                yield from parse.on_multiplier(prev, cur, nxt)
            elif cur in self.multipliers_suffixed:
                yield from parse.on_multiplier_suffixed(prev, cur, nxt)
            elif cur in self.preceding_prefixers:
                yield from parse.on_preceding_prefixer(prev, cur, nxt)
            elif cur in self.following_prefixers:
                yield from parse.on_following_prefixer(prev, cur, nxt)
            elif cur in self.suffixers:
                outputs, skip = parse.on_suffixer(prev, cur, nxt)
                yield from outputs
            elif cur in self.specials:
                outputs, skip = parse.on_special(prev, cur, nxt)
                yield from outputs
        yield from parse.flush()

    def preprocess(self, s: str) -> str:
        # "<number> and a half" → "<number> point five" (when composable)
        pieces: List[str] = []
        segments = re.split(r"\band\s+a\s+half\b", s)
        for i, segment in enumerate(segments):
            if not segment.strip():
                continue
            pieces.append(segment)
            if i != len(segments) - 1:
                last_word = segment.rsplit(maxsplit=2)[-1]
                if last_word in self.decimals or last_word in self.multipliers:
                    pieces.append("point five")
                else:
                    pieces.append("and a half")
        s = " ".join(pieces)
        s = re.sub(r"([a-z])([0-9])", r"\1 \2", s)  # space at letter/number edge
        s = re.sub(r"([0-9])([a-z])", r"\1 \2", s)
        s = re.sub(r"([0-9])\s+(st|nd|rd|th|s)\b", r"\1\2", s)  # reattach suffixes
        return s

    def postprocess(self, s: str) -> str:
        def combine_cents(m: re.Match) -> str:
            try:
                return f"{m.group(1)}{m.group(2)}.{int(m.group(3)):02d}"
            except ValueError:
                return m.string

        def extract_cents(m: re.Match) -> str:
            try:
                return f"¢{int(m.group(1))}"
            except ValueError:
                return m.string

        # "$2 and ¢7" → "$2.07"; "$0.09" → "¢9"
        s = re.sub(r"([€£$])([0-9]+) (?:and )?¢([0-9]{1,2})\b", combine_cents, s)
        s = re.sub(r"[€£$]0.([0-9]{1,2})\b", extract_cents, s)
        s = re.sub(r"\b1(s?)\b", r"one\1", s)  # keep "one(s)" literal
        return s

    def __call__(self, s: str) -> str:
        s = self.preprocess(s)
        s = " ".join(w for w in self.process_words(s.split()) if w is not None)
        return self.postprocess(s)


# ---------------------------------------------------------------------------
# Spelling + full English normalizer
# ---------------------------------------------------------------------------


def _find_spelling_asset() -> Optional[Path]:
    """english.json (tysto.com UK→US list, same asset the reference vendors);
    resolved like the tokenizer vocabs: env dir, package assets, openai
    whisper install, reference checkout."""
    names = []
    env = os.environ.get("WLK_TPU_ASSET_DIR")
    if env:
        names.append(Path(env) / "english.json")
    names.append(Path(__file__).parent / "assets" / "english.json")
    try:
        import whisper  # type: ignore

        names.append(Path(whisper.__file__).parent / "normalizers" / "english.json")
    except Exception:
        pass
    ref = os.environ.get("WLK_REFERENCE_DIR")
    if ref:
        names.append(Path(ref) / "whisperlivekit" / "whisper" / "normalizers" / "english.json")
    for p in names:
        if p.is_file():
            return p
    return None


class EnglishSpellingNormalizer:
    def __init__(self) -> None:
        path = _find_spelling_asset()
        self.mapping = json.load(open(path)) if path else {}

    def __call__(self, s: str) -> str:
        return " ".join(self.mapping.get(w, w) for w in s.split())


# hesitations dropped outright; contraction/title expansions applied in order
_IGNORE = r"\b(hmm|mm|mhm|mmm|uh|um)\b"
_REPLACERS = {
    r"\bwon't\b": "will not",
    r"\bcan't\b": "can not",
    r"\blet's\b": "let us",
    r"\bain't\b": "aint",
    r"\by'all\b": "you all",
    r"\bwanna\b": "want to",
    r"\bgotta\b": "got to",
    r"\bgonna\b": "going to",
    r"\bi'ma\b": "i am going to",
    r"\bimma\b": "i am going to",
    r"\bwoulda\b": "would have",
    r"\bcoulda\b": "could have",
    r"\bshoulda\b": "should have",
    r"\bma'am\b": "madam",
    r"\bmr\b": "mister ",
    r"\bmrs\b": "missus ",
    r"\bst\b": "saint ",
    r"\bdr\b": "doctor ",
    r"\bprof\b": "professor ",
    r"\bcapt\b": "captain ",
    r"\bgov\b": "governor ",
    r"\bald\b": "alderman ",
    r"\bgen\b": "general ",
    r"\bsen\b": "senator ",
    r"\brep\b": "representative ",
    r"\bpres\b": "president ",
    r"\brev\b": "reverend ",
    r"\bhon\b": "honorable ",
    r"\basst\b": "assistant ",
    r"\bassoc\b": "associate ",
    r"\blt\b": "lieutenant ",
    r"\bcol\b": "colonel ",
    r"\bjr\b": "junior ",
    r"\bsr\b": "senior ",
    r"\besq\b": "esquire ",
    r"'d been\b": " had been",
    r"'s been\b": " has been",
    r"'d gone\b": " had gone",
    r"'s gone\b": " has gone",
    r"'d done\b": " had done",
    r"'s got\b": " has got",
    r"n't\b": " not",
    r"'re\b": " are",
    r"'s\b": " is",
    r"'d\b": " would",
    r"'ll\b": " will",
    r"'t\b": " not",
    r"'ve\b": " have",
    r"'m\b": " am",
}


class EnglishTextNormalizer:
    def __init__(self) -> None:
        self.standardize_numbers = EnglishNumberNormalizer()
        self.standardize_spellings = EnglishSpellingNormalizer()

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)   # bracketed asides
        s = re.sub(r"\(([^)]+?)\)", "", s)        # parentheticals
        s = re.sub(_IGNORE, "", s)
        s = re.sub(r"\s+'", "'", s)               # space before apostrophe
        for pattern, replacement in _REPLACERS.items():
            s = re.sub(pattern, replacement, s)
        s = re.sub(r"(\d),(\d)", r"\1\2", s)      # 1,000 → 1000
        s = re.sub(r"\.([^0-9]|$)", r" \1", s)    # periods except decimals
        s = remove_symbols_and_diacritics(s, keep=".%$¢€£")
        s = self.standardize_numbers(s)
        s = self.standardize_spellings(s)
        s = re.sub(r"[.$¢€£]([^0-9])", r" \1", s)  # orphaned numeric symbols
        s = re.sub(r"([^0-9])%", r"\1 ", s)
        s = re.sub(r"\s+", " ", s)
        return s
