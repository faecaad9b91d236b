"""Language identification for the streaming path (port of the part of
whisperlivekit_tpu/decoding/task.py that language auto-detect needs).

``WhisperDecoder.detect_language`` is one decoder step from ``[sot]`` over
the full-window encoding, with a softmax over the language tokens only
(reference whisper/decoding.py detect_language). Offline transcription
(``decode``: the greedy loop, the logit filters and the timestamp rules) is
ROADMAP queue 1 item 7.2 and raises until it is ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.whisper import model as wm
from ..models.whisper.dims import ModelDimensions
from ..models.whisper.tokenizer import Tokenizer, get_tokenizer


class WhisperDecoder:
    """Holds the model; the DecodingTask equivalent."""

    def __init__(self, model: wm.Whisper, dims: ModelDimensions):
        self.model = model
        self.dims = dims

    def tokenizer_for(self, language: Optional[str], task: str) -> Tokenizer:
        return get_tokenizer(
            self.dims.multilingual,
            num_languages=self.dims.num_languages,
            language=language,
            task=task,
        )

    # ---- language id -------------------------------------------------------

    def detect_language(self, enc: torch.Tensor, tokenizer: Tokenizer):
        """Single forward from [sot]; returns (codes, prob dicts) per lane."""
        B = enc.shape[0]
        dev = enc.device
        xkv = wm.cross_kv(self.model, enc, self.dims)
        cache = wm.init_cache(self.dims, B, dtype=self.model.dtype, device=dev)
        tokens = torch.full((B, 1), tokenizer.sot, dtype=torch.long, device=dev)
        logits, _, _ = wm.decode(
            self.model, tokens, torch.zeros((B,), dtype=torch.long, device=dev), xkv, cache, self.dims
        )
        logits = logits[:, 0].float().cpu()
        lang_tokens = list(tokenizer.all_language_tokens)
        mask = torch.full((logits.shape[-1],), float("-inf"))
        mask[lang_tokens] = 0.0
        probs = torch.softmax(logits + mask, dim=-1).numpy()
        codes = []
        prob_maps = []
        for b in range(B):
            best = int(probs[b].argmax())
            codes.append(tokenizer._token_to_code(best))
            prob_maps.append(
                {code: float(probs[b, t]) for code, t in zip(tokenizer.all_language_codes, lang_tokens)}
            )
        return codes, prob_maps

    def decode(self, *args, **kwargs):
        raise NotImplementedError(
            "offline decoding (decode, the greedy loop and the logit filters) is "
            "ROADMAP queue 1 item 7.2, not ported yet"
        )
