"""Whisper model-family metadata: dimensions, catalogs, alignment heads.

All tables here are public OpenAI Whisper release data (sizes, vocab counts,
HF repo ids, and the cross-attention heads published for word-level timing —
the reference stores the same head sets as base85/gzip blobs,
reference whisper/__init__.py:40-72; we store them as plain indices).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class ModelDimensions:
    n_mels: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_vocab: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int

    @property
    def head_dim(self) -> int:
        return self.n_text_state // self.n_text_head

    @property
    def multilingual(self) -> bool:
        return self.n_vocab >= 51865

    @property
    def num_languages(self) -> int:
        return self.n_vocab - 51765 - int(self.multilingual)


def _dims(state, heads, a_layers, t_layers, n_mels=80, n_vocab=51865) -> ModelDimensions:
    return ModelDimensions(
        n_mels=n_mels,
        n_audio_ctx=1500,
        n_audio_state=state,
        n_audio_head=heads,
        n_audio_layer=a_layers,
        n_vocab=n_vocab,
        n_text_ctx=448,
        n_text_state=state,
        n_text_head=heads,
        n_text_layer=t_layers,
    )


#: Official model catalog (public release dimensions).
MODEL_DIMS: Dict[str, ModelDimensions] = {
    "tiny.en": _dims(384, 6, 4, 4, n_vocab=51864),
    "tiny": _dims(384, 6, 4, 4),
    "base.en": _dims(512, 8, 6, 6, n_vocab=51864),
    "base": _dims(512, 8, 6, 6),
    "small.en": _dims(768, 12, 12, 12, n_vocab=51864),
    "small": _dims(768, 12, 12, 12),
    "medium.en": _dims(1024, 16, 24, 24, n_vocab=51864),
    "medium": _dims(1024, 16, 24, 24),
    "large-v1": _dims(1280, 20, 32, 32),
    "large-v2": _dims(1280, 20, 32, 32),
    "large-v3": _dims(1280, 20, 32, 32, n_mels=128, n_vocab=51866),
    "large": _dims(1280, 20, 32, 32, n_mels=128, n_vocab=51866),
    "large-v3-turbo": _dims(1280, 20, 32, 4, n_mels=128, n_vocab=51866),
    "turbo": _dims(1280, 20, 32, 4, n_mels=128, n_vocab=51866),
    # CI/dev-only: full-length audio context with a miniature transformer so
    # the whole pipeline compiles & runs fast on CPU. Not a real checkpoint.
    "dev-tiny": _dims(64, 4, 2, 2),
}

#: HuggingFace repos serving each size (for the weight loader / `wlk pull`).
HF_REPOS: Dict[str, str] = {
    name: f"openai/whisper-{name.replace('-v3-turbo', '-v3-turbo')}"
    for name in MODEL_DIMS
    if name not in ("large", "turbo")
}
HF_REPOS["large"] = "openai/whisper-large-v3"
HF_REPOS["turbo"] = "openai/whisper-large-v3-turbo"

#: Cross-attention alignment heads per released checkpoint, as flat indices
#: into the (n_text_layer * n_text_head) grid. Used by AlignAtt emission
#: gating and word-level timing.
ALIGNMENT_HEADS: Dict[str, List[int]] = {
    "tiny.en": [6, 12, 17, 18, 19, 20, 21, 22],
    "tiny": [14, 18, 20, 21, 22, 23],
    "base.en": [27, 39, 41, 45, 47],
    "base": [25, 34, 35, 39, 41, 42, 44, 46],
    "small.en": [78, 84, 87, 92, 98, 101, 103, 108, 112, 116, 118, 120, 121,
                 122, 123, 126, 131, 134, 136],
    "small": [63, 69, 96, 100, 103, 104, 108, 115, 117, 125],
    "medium.en": [180, 225, 236, 238, 244, 256, 260, 265, 284, 286, 295, 298,
                  303, 320, 323, 329, 334, 348],
    "medium": [223, 244, 255, 257, 320, 372],
    "large-v1": [199, 222, 224, 237, 447, 451, 457, 462, 475],
    "large-v2": [212, 277, 331, 332, 333, 355, 356, 364, 371, 379, 391, 422,
                 423, 443, 449, 452, 465, 467, 473, 505, 521, 532, 555],
    "large-v3": [140, 217, 258, 272, 321, 354, 391, 424, 481, 506],
    "large": [140, 217, 258, 272, 321, 354, 391, 424, 481, 506],
    "large-v3-turbo": [44, 51, 63, 66, 71, 74],
    "turbo": [44, 51, 63, 66, 71, 74],
}


def alignment_head_pairs(name_or_indices, n_head: int) -> List[Tuple[int, int]]:
    """Resolve alignment heads to (layer, head) pairs."""
    idx = ALIGNMENT_HEADS[name_or_indices] if isinstance(name_or_indices, str) else name_or_indices
    return [(i // n_head, i % n_head) for i in idx]


def default_alignment_heads(dims: ModelDimensions, name: Optional[str] = None) -> List[Tuple[int, int]]:
    """Published heads when the size is known; otherwise the upper half of
    layers, all heads (the OpenAI fallback for custom checkpoints)."""
    if name and name in ALIGNMENT_HEADS:
        return alignment_head_pairs(name, dims.n_text_head)
    pairs = []
    for layer in range(dims.n_text_layer // 2, dims.n_text_layer):
        pairs.extend((layer, h) for h in range(dims.n_text_head))
    return pairs
