"""Stand-in Whisper BPE vocabulary for runs without the real rank files.

``multilingual.tiktoken`` is public OpenAI data that the repository does not
vendor. Random-weight runs only need a vocabulary with Whisper's size and
special-token layout, so this writes a rank file of 50257 distinct byte
strings (the 256 single bytes at their byte values, then printable 2-byte
and 3-byte strings). Loaded by ``models.whisper.tokenizer.get_tokenizer(True,
...)`` (either package's copy of that module), it gives Whisper's exact
special ids: eot 50257, sot 50258, no_speech 50362,
timestamp_begin 50364, and ``encode(" ") == [32]``.

Usage::

    from whisperlivekit_tpu_torch.harness.vocab import install_standin_vocab
    install_standin_vocab(tmp_dir)   # writes the file, sets WLK_TPU_ASSET_DIR
"""

from __future__ import annotations

import base64
import itertools
import os
import string
from pathlib import Path

N_RANKS = 50257  # GPT-2/Whisper mergeable ranks; specials start here
FILE_NAME = "multilingual.tiktoken"
_CHARS = " " + string.ascii_lowercase + string.ascii_uppercase + string.digits + string.punctuation


def standin_tokens():
    """The N_RANKS byte strings, in rank order."""
    out = [bytes([b]) for b in range(256)]
    seen = set(out)
    for n in (2, 3):
        for combo in itertools.product(_CHARS, repeat=n):
            tok = "".join(combo).encode()
            if tok not in seen:
                seen.add(tok)
                out.append(tok)
                if len(out) == N_RANKS:
                    return out
    raise AssertionError("alphabet too small for the stand-in vocabulary")


def write_standin_vocab(directory) -> Path:
    """Write ``multilingual.tiktoken`` into ``directory``; returns its path."""
    path = Path(directory) / FILE_NAME
    path.parent.mkdir(parents=True, exist_ok=True)
    lines = [
        f"{base64.b64encode(tok).decode()} {rank}\n"
        for rank, tok in enumerate(standin_tokens())
    ]
    path.write_text("".join(lines))
    return path


def install_standin_vocab(directory) -> Path:
    """Write the stand-in vocabulary and point the tokenizer loader at it
    (``WLK_TPU_ASSET_DIR``). Call before the first ``get_tokenizer``."""
    path = write_standin_vocab(directory)
    os.environ["WLK_TPU_ASSET_DIR"] = str(path.parent)
    return path
