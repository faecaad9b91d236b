"""TranscriptionEngine: the shared, load-once model state + per-session
factories (port of whisperlivekit_tpu/engine/core.py, SimulStreaming only).

Thread-safe double-checked-lock singleton (its own, separate from the JAX
package's) holding the Whisper module on its device, the VAD model and the
batch scheduler, with ``online_factory`` creating cheap per-session
processors. Weights: checkpoints (OpenAI .pt, HF safetensors, LoRA, the
port's native directory) through ``models/whisper/load.py``;
``random:<size>`` builds the catalog dimensions with random weights from a
seeded ``torch.Generator`` (the numbers differ from the JAX package's
``PRNGKey(0)`` weights; parity tests bridge JAX weights through
``params_from_jax_numpy`` or load one checkpoint in both packages).

What is not ported yet raises NotImplementedError naming the module: the
LocalAgreement, windowed, cloud, Qwen3 and Voxtral backends, the batched
JAX VAD, diarization and translation.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Optional

import torch

from ..config import WLKConfig
from ..models.whisper.dims import MODEL_DIMS, ModelDimensions
from ..models.whisper.load import load_model
from ..models.whisper.tokenizer import get_tokenizer
from ..models.whisper import model as wm

logger = logging.getLogger(__name__)

#: seed of the random weights behind ``random:<size>``
RANDOM_WEIGHTS_SEED = 0


class EngineAtCapacity(RuntimeError):
    """New session exceeds the engine's admission capacity (``max_sessions``)."""


def _dtype_from_str(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}[name]


def default_device() -> torch.device:
    """The card. Without CUDA this raises rather than serve on the CPU
    unasked: tests and CPU tools pass ``device="cpu"`` explicitly."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port serves on the GPU; pass device=\"cpu\" "
            "to run on the CPU (tests, CPU tools)"
        )
    return torch.device("cuda")


def load_whisper_params(config: WLKConfig, device=None):
    """Resolve + load whisper weights per config. Returns (model, dims, name).
    ``device=None`` means the card (``default_device``, which raises without
    CUDA)."""
    device = torch.device(device) if device is not None else default_device()
    dtype = _dtype_from_str(config.param_dtype)
    size = config.model_size
    path = config.model_path or config.model_dir

    if (path and str(path).startswith("random")) or size.startswith("random"):
        spec = size.split(":", 1)[-1] if ":" in size else ("base" if size.startswith("random") else size)
        if path and ":" in str(path):
            spec = str(path).split(":", 1)[1]
        dims = MODEL_DIMS.get(spec, MODEL_DIMS["base"])
        logger.warning("Initializing RANDOM weights (%s dims, seed %d)", spec, RANDOM_WEIGHTS_SEED)
        gen = torch.Generator().manual_seed(RANDOM_WEIGHTS_SEED)
        model, name = wm.init_params(dims, gen, dtype=dtype, device=device), spec
    else:
        model, dims, name = load_model(path or size, dtype=dtype, lora_path=config.lora_path,
                                       cache_dir=config.model_cache_dir, device=device)
    if getattr(config, "decoder_dtype", "bf16") == "f8":
        logger.info("Quantizing decoder block weights to f8_e4m3 (weight-only)")
        wm.quantize_decoder_f8(model)
    return model, dims, name


class SimulStreamingASR:
    """Backend holder for the AlignAtt policy (reference simul_whisper/backend.py:289-566)."""

    sep = ""

    def __init__(self, config: WLKConfig, model, dims: ModelDimensions, model_name):
        from ..streaming.alignatt import AlignAttConfig, AlignAttEngine

        self.config = config
        self.dims = dims
        language = config.lan if config.lan != "auto" else "auto"
        tok_lang = language if language != "auto" else "en"
        task = "translate" if config.direct_english_translation else "transcribe"
        self.tokenizer = get_tokenizer(
            dims.multilingual,
            num_languages=dims.num_languages,
            language=tok_lang if dims.multilingual else None,
            task=task if dims.multilingual else None,
        )
        align_pairs = None
        if config.custom_alignment_heads:
            idx = [int(x) for x in str(config.custom_alignment_heads).split(",") if x.strip()]
            align_pairs = [(i // dims.n_text_head, i % dims.n_text_head) for i in idx]
        self.cfg = AlignAttConfig(
            segment_length=config.min_chunk_size,
            frame_threshold=config.frame_threshold,
            audio_max_len=config.audio_max_len,
            audio_min_len=config.audio_min_len,
            language=language,
            task=task,
            decoder_type=config.decoder_type or ("beam" if config.beams > 1 else "greedy"),
            beam_size=config.beams,
            init_prompt=config.init_prompt,
            static_init_prompt=config.static_init_prompt,
            max_context_tokens=config.max_context_tokens,
            never_fire=config.never_fire,
            cif_ckpt_path=config.cif_ckpt_path,
            xkv_f8=getattr(config, "xkv_f8", False),
            xkv_cache={"on": True, "off": False}.get(
                getattr(config, "xkv_cache", "auto"), "auto"
            ),
            xkv_cache_dtype=getattr(config, "xkv_cache_dtype", "bf16"),
            anchor_cohorts=int(getattr(config, "xkv_anchor_cohorts", 1) or 1),
            max_steps=int(getattr(config, "max_decode_steps", 32) or 32),
            serving_prefix_cap=int(getattr(config, "serving_prefix_cap", 0) or 0),
            serving_commit_budget=int(getattr(config, "serving_commit_budget", 16)),
        )
        self.engine = AlignAttEngine(
            model, dims, self.tokenizer, self.cfg, model_name=model_name,
            align_pairs=align_pairs,
        )


class TranscriptionEngine:
    """Thread-safe singleton (reference core.py:37-79)."""

    _instance: Optional["TranscriptionEngine"] = None
    _lock = threading.Lock()

    def __new__(cls, *args, **kwargs):
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    inst = super().__new__(cls)
                    inst._initialized = False
                    cls._instance = inst
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._instance = None

    def __init__(self, config: Optional[WLKConfig] = None, device=None, **kwargs):
        if self._initialized:
            return
        with self._lock:
            if self._initialized:
                return
            if config is None:
                config = WLKConfig.from_kwargs(**kwargs)
            self._do_init(config, device)
            self._initialized = True

    def _do_init(self, config: WLKConfig, device=None) -> None:
        self.config = config
        self.args = config  # reference exposes config as .args (core.py:97)
        self.device = torch.device(device) if device is not None else default_device()
        self.asr: Any = None
        self.vac_model = None
        self.vad_scheduler = None
        self.diarization_model = None
        self.translation_model = None
        self._active_sessions = 0
        self._session_lock = threading.Lock()
        self.scheduler = None

        if config.transcription:
            if config.backend not in ("auto", "jax", "torch") and config.backend:
                raise NotImplementedError(
                    f"backend {config.backend!r} (streaming/qwen3_*, models/voxtral*, "
                    "streaming/cloud_backend.py) is not ported yet"
                )
            if config.backend_policy in ("localagreement", "windowed"):
                raise NotImplementedError(
                    f"backend_policy {config.backend_policy!r} needs "
                    "streaming/local_agreement.py / windowed.py, not ported yet"
                )
            model, dims, name = load_whisper_params(config, self.device)
            self.asr = SimulStreamingASR(config, model, dims, name)
            if config.scheduler:
                from .scheduler import BatchScheduler

                self.scheduler = BatchScheduler(
                    self.asr.engine,
                    max_lanes=config.max_batch_sessions,
                    incremental_encode=getattr(config, "incremental_encode", True),
                )
            logger.info(
                "Loaded whisper %s (%d-layer enc / %d-layer dec, %s) on %s",
                name, dims.n_audio_layer, dims.n_text_layer, config.param_dtype, self.device,
            )

        if config.vac:
            if config.vad_backend == "jax-batched":
                raise NotImplementedError("vad_backend='jax-batched' (audio/vad_batched.py) is not ported yet")
            from ..audio.vad import load_vad_model

            self.vac_model = load_vad_model()
        if config.diarization:
            raise NotImplementedError("diarization (diarization/) is not ported yet")
        if config.target_language:
            raise NotImplementedError("translation (translation/) is not ported yet")
        if config.warmup_file:
            self.warmup(config.warmup_file)

    # ---- admission ---------------------------------------------------------

    def session_capacity(self) -> Optional[int]:
        """``config.max_sessions`` when > 0, else unbounded (None): the
        scheduler's lane rotation absorbs overload on the base form."""
        cap = int(getattr(getattr(self, "config", None), "max_sessions", 0) or 0)
        return cap if cap > 0 else None

    def acquire_session(self) -> None:
        cap = self.session_capacity()
        with self._session_lock:
            if cap is not None and self._active_sessions >= cap:
                raise EngineAtCapacity(
                    f"engine at capacity ({self._active_sessions}/{cap} sessions)"
                )
            self._active_sessions += 1

    def release_session(self) -> None:
        with self._session_lock:
            if self._active_sessions > 0:
                self._active_sessions -= 1

    @property
    def active_sessions(self) -> int:
        return getattr(self, "_active_sessions", 0)

    def warmup_synthetic(self) -> None:
        """Run one tick over synthetic audio before the first session
        (fail-loud, reference warmup.py:51-61): builds the kernels and
        exercises the whole tick path."""
        import numpy as np

        if self.asr is None:
            return
        proc = online_factory(self.config, self.asr, scheduler=self.scheduler)
        proc.warmup(np.zeros(16000, np.float32))
        proc.close()  # release the pooled lanes the warmup session held
        logger.info("Engine warmup complete")

    def warmup(self, path: str) -> None:
        """One real inference at startup on the file's first 5 s; raises if
        broken (reference warmup.py:51-61 fail-loud guard)."""
        from ..audio.io import load_audio

        audio = load_audio(path)[: 16000 * 5]
        online_factory(self.config, self.asr).warmup(audio)
        logger.info("Warmup inference OK")


# ---------------------------------------------------------------------------
# Per-session factories (reference core.py:292-361)
# ---------------------------------------------------------------------------


def online_factory(config: WLKConfig, asr, language: Optional[str] = None, scheduler=None):
    from ..streaming.simul_processor import SimulStreamingOnlineProcessor

    if not isinstance(asr, SimulStreamingASR):
        raise NotImplementedError(f"no online processor for {type(asr).__name__} in this port")
    tokenizer = None
    if language and language not in ("auto", config.lan):
        tokenizer = get_tokenizer(
            asr.dims.multilingual,
            num_languages=asr.dims.num_languages,
            language=language,
            task=asr.cfg.task,
        )
    return SimulStreamingOnlineProcessor(asr.engine, tokenizer=tokenizer, scheduler=scheduler)


def online_diarization_factory(config: WLKConfig, diarization_model):
    if diarization_model is None:
        return None
    raise NotImplementedError("diarization (diarization/) is not ported yet")


def online_translation_factory(config: WLKConfig, translation_model):
    if translation_model is None:
        return None
    raise NotImplementedError("translation (translation/) is not ported yet")


def session_translation_factory(config: WLKConfig, translation_model, target_language: str):
    if translation_model is None:
        return None
    raise NotImplementedError("translation (translation/) is not ported yet")
