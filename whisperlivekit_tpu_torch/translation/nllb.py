"""NLLB loader + online simultaneous-translation session (port of
whisperlivekit_tpu/translation/nllb.py).

Replaces the reference's external `nllw` in-process backend (reference
core.py:261-289, translation.py:18-47). Weights load from an HF NLLB
checkpoint directory (the M2M100 state dict, read without the
``safetensors`` package, into ``nllb_model.NLLB`` with no transposes); the
session implements the translation contract consumed by the pipeline
(insert_tokens / process / validate_buffer_and_reset / insert_silence,
reference audio_processor.py:675-708): source tokens buffer up, every
process() re-translates the open segment as the draft, and punctuation
closes segments into committed Translations.
"""

from __future__ import annotations

import json
import logging
import re
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..timed import ASRToken, TimedText, Translation
from . import nllb_model as nm

logger = logging.getLogger(__name__)

# FLORES-200 language codes for the languages whisper emits, used to form
# NLLB language tokens (public NLLB data; extend as needed).
FLORES = {
    "en": "eng_Latn", "fr": "fra_Latn", "de": "deu_Latn", "es": "spa_Latn",
    "it": "ita_Latn", "pt": "por_Latn", "nl": "nld_Latn", "pl": "pol_Latn",
    "ru": "rus_Cyrl", "uk": "ukr_Cyrl", "zh": "zho_Hans", "ja": "jpn_Jpan",
    "ko": "kor_Hang", "ar": "arb_Arab", "tr": "tur_Latn", "hi": "hin_Deva",
    "vi": "vie_Latn", "id": "ind_Latn", "th": "tha_Thai", "sv": "swe_Latn",
    "da": "dan_Latn", "no": "nob_Latn", "fi": "fin_Latn", "cs": "ces_Latn",
    "ro": "ron_Latn", "hu": "hun_Latn", "el": "ell_Grek", "he": "heb_Hebr",
    "bg": "bul_Cyrl", "ca": "cat_Latn", "fa": "pes_Arab", "ur": "urd_Arab",
}


def _nllb_language_code(lang: str) -> str:
    """whisper code or FLORES code → FLORES code (reference core.py
    `_nllw_language_code` role)."""
    if "_" in lang:
        return lang
    code = FLORES.get(lang.lower())
    if code is None:
        raise ValueError(f"no FLORES mapping for language {lang!r}")
    return code


# ---------------------------------------------------------------------------
# Weight conversion (HF M2M100 state dict → nllb_model.NLLB)
# ---------------------------------------------------------------------------


def convert_hf_state_dict(sd: Dict, dims: nm.NLLBDims, dtype=torch.float32, device="cpu") -> nm.NLLB:
    """HF M2M100 tensors (torch or numpy; Linear [out, in], as the module
    stores them) → ``NLLB`` on ``device``: each tensor widened to f32, then
    rounded once to ``dtype``. A missing key raises ``KeyError``; keys the
    model does not use (``lm_head``, the tied ``embed_tokens``) are ignored,
    as in the JAX converter."""
    model = nm.NLLB(dims)

    def put(param: torch.Tensor, name: str) -> None:
        t = torch.as_tensor(np.asarray(sd[name]) if not isinstance(sd[name], torch.Tensor) else sd[name])
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(param.shape)}")
        param.data = t.to(device=device, dtype=torch.float32).to(dtype)

    def lin(mod, prefix):
        put(mod.weight, f"{prefix}.weight")
        put(mod.bias, f"{prefix}.bias")

    def ln(mod, prefix):
        put(mod.scale, f"{prefix}.weight")
        put(mod.bias, f"{prefix}.bias")

    def attn(mod, prefix):
        for proj, name in zip("qkvo", ("q_proj", "k_proj", "v_proj", "out_proj")):
            lin(getattr(mod, proj), f"{prefix}.{name}")

    put(model.emb, "model.shared.weight" if "model.shared.weight" in sd else "shared.weight")
    for stack, side in ((model.encoder, "encoder"), (model.decoder, "decoder")):
        for i, blk in enumerate(stack.blocks):
            prefix = f"model.{side}.layers.{i}"
            ln(blk.attn_ln, f"{prefix}.self_attn_layer_norm")
            attn(blk.attn, f"{prefix}.self_attn")
            ln(blk.ffn_ln, f"{prefix}.final_layer_norm")
            lin(blk.fc1, f"{prefix}.fc1")
            lin(blk.fc2, f"{prefix}.fc2")
            if blk.cross is not None:
                ln(blk.cross_ln, f"{prefix}.encoder_attn_layer_norm")
                attn(blk.cross, f"{prefix}.encoder_attn")
        ln(stack.ln, f"model.{side}.layer_norm")
    return model.to(device=device).eval().requires_grad_(False)


def dims_from_hf_config(cfg: dict) -> nm.NLLBDims:
    return nm.NLLBDims(
        vocab_size=cfg["vocab_size"],
        d_model=cfg["d_model"],
        encoder_layers=cfg["encoder_layers"],
        decoder_layers=cfg["decoder_layers"],
        heads=cfg["encoder_attention_heads"],
        ffn_dim=cfg["encoder_ffn_dim"],
        max_positions=cfg.get("max_position_embeddings", 1024),
        pad_token_id=cfg.get("pad_token_id", 1),
    )


class NLLBModel:
    """Loaded model + tokenizer + greedy translate.

    One ``translate`` at a time per model (``lock``): the greedy loop is
    eager, and sessions translating at once from worker threads convoy on
    the interpreter lock (three 32-step calls at once took 1.8-2.6x the
    wall unlocked that they took locked on an H100, ``chip_smoke.py``'s
    ``diar_tr`` phase). The JAX package, one compiled loop a call, has no
    lock."""

    def __init__(self, params, dims: nm.NLLBDims, tokenizer):
        self.params = params  # an nllb_model.NLLB on its device
        self.dims = dims
        self.tokenizer = tokenizer  # HF fast tokenizer
        self.eos = 2
        self.max_src = 256
        self.lock = threading.Lock()

    def translate(self, text: str, src: str, tgt: str, max_len: int = 128) -> str:
        if not text.strip():
            return ""
        src_code, tgt_code = _nllb_language_code(src), _nllb_language_code(tgt)
        ids = self.tokenizer.encode(text).ids if hasattr(self.tokenizer, "encode") else None
        if ids is None:
            return ""
        src_lang_id = self._lang_id(src_code)
        tgt_lang_id = self._lang_id(tgt_code)
        tokens = [src_lang_id] + ids[: self.max_src - 2] + [self.eos]
        S = 1 << max(4, (len(tokens) - 1).bit_length())  # pad bucket
        src_tokens = np.full((1, S), self.dims.pad_token_id, np.int64)
        src_tokens[0, : len(tokens)] = tokens
        src_mask = np.zeros((1, S), bool)
        src_mask[0, : len(tokens)] = True

        dev = self.params.device
        with self.lock:
            out = nm.greedy_translate(
                self.params,
                torch.from_numpy(src_tokens).to(dev),
                torch.from_numpy(src_mask).to(dev),
                torch.tensor([tgt_lang_id], device=dev),
                self.eos,
                self.dims,
                max_len,
            )
            out = out[0].tolist()
        out = [t for t in out[1:] if t != self.eos]  # drop forced lang token + eos
        return self.tokenizer.decode(out)

    def _lang_id(self, flores_code: str) -> int:
        tok = self.tokenizer.token_to_id(flores_code)
        if tok is None:
            raise ValueError(f"tokenizer lacks language token {flores_code}")
        return tok


def load_nllb(config, device=None) -> NLLBModel:
    """Load from the HF cache's snapshot of the ``nllb_size`` checkpoint
    onto ``device`` (None: the card, which raises without CUDA), in bf16.
    No snapshot raises ``FileNotFoundError`` before any device is touched."""
    from ..engine.core import default_device
    from ..models.whisper.load import _read_safetensors_dir

    size = getattr(config, "nllb_size", "600M")
    repo = nm.HF_NLLB_REPOS.get(size)
    path = None
    hub = Path.home() / ".cache" / "huggingface" / "hub"
    if repo:
        snaps = hub / f"models--{repo.replace('/', '--')}" / "snapshots"
        if snaps.exists():
            found = sorted(snaps.iterdir())
            path = found[-1] if found else None
    if path is None:
        raise FileNotFoundError(
            f"no local NLLB-{size} weights; run `wlk pull nllb` with network access"
        )
    device = torch.device(device) if device is not None else default_device()
    cfg = json.loads((path / "config.json").read_text())
    dims = dims_from_hf_config(cfg)
    sd = _read_safetensors_dir(path)
    params = convert_hf_state_dict(sd, dims, dtype=torch.bfloat16, device=device)
    from tokenizers import Tokenizer as HFTokenizer

    tokenizer = HFTokenizer.from_file(str(path / "tokenizer.json"))
    return NLLBModel(params, dims, tokenizer)


# ---------------------------------------------------------------------------
# Online session (pipeline contract)
# ---------------------------------------------------------------------------


_SENTENCE_END = re.compile(r"[.!?。！？]")


class NLLBOnlineTranslation:
    wants_hypothesis_tail = False

    def __init__(self, model: NLLBModel, src: str, tgt: str):
        self.model = model
        self.src, self.tgt = src, tgt
        self._pending: List[ASRToken] = []

    def insert_tokens(self, items) -> None:
        items = items if isinstance(items, list) else [items]
        for it in items:
            if isinstance(it, ASRToken):
                self._pending.append(it)

    def insert_silence(self, duration: float) -> None:
        pass

    def _source_text(self) -> str:
        return "".join(t.text or "" for t in self._pending)

    def _emit(self) -> Tuple[Optional[Translation], TimedText]:
        if not self._pending:
            return None, TimedText()
        text = self.model.translate(self._source_text(), self.src, self.tgt)
        tr = Translation(start=self._pending[0].start, end=self._pending[-1].end, text=text)
        self._pending = []
        return tr, TimedText()

    def process(self) -> Tuple[Optional[Translation], TimedText]:
        if any(t.has_punctuation() for t in self._pending):
            return self._emit()
        draft = self.model.translate(self._source_text(), self.src, self.tgt, max_len=64)
        return None, TimedText(text=draft)

    def validate_buffer_and_reset(self) -> Tuple[Optional[Translation], TimedText]:
        return self._emit()
