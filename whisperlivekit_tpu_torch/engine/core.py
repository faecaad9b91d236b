"""TranscriptionEngine: the shared, load-once model state + per-session
factories (port of whisperlivekit_tpu/engine/core.py: the SimulStreaming,
LocalAgreement and windowed policies).

Thread-safe double-checked-lock singleton (its own, separate from the JAX
package's) holding the Whisper module on its device, the VAD model and the
batch scheduler, with ``online_factory`` creating cheap per-session
processors. Weights: checkpoints (OpenAI .pt, HF safetensors, LoRA, the
port's native directory) through ``models/whisper/load.py``;
``random:<size>`` builds the catalog dimensions with random weights from a
seeded ``torch.Generator`` (the numbers differ from the JAX package's
``PRNGKey(0)`` weights; parity tests bridge JAX weights through
``params_from_jax_numpy`` or load one checkpoint in both packages).

The other transcription backends route as in the JAX engine: ``qwen3``
(Qwen3-ASR causal, ``streaming/qwen3_causal.py``, pooled through
``streaming/qwen3_batch.py``'s ``CausalBatchService`` when
``scheduler``), ``voxtral`` under ``backend_policy`` causal/realtime
(``streaming/voxtral_realtime.py``, the same machinery) or otherwise the
windowed policy over ``models/voxtral_backend.py``, and ``openai-api``
(``streaming/cloud_backend.py`` under LocalAgreement). Their weights load
on the engine's device in ``param_dtype`` (the JAX engine loads Qwen3 and
Voxtral realtime in f32 whatever it says).

Diarization (``diarization/``: Sortformer on the engine's device, the
energy, embedding and diart backends) and translation (``translation/``:
NLLB on the engine's device, loaded once on its first session; the AlignAtt
sidecar client; echo when the NLLB weights are absent) build their shared
models here, as the JAX engine does.

``vad_backend="jax-batched"`` (the JAX package's name) builds the batched
Silero VAD (``audio/vad_batched.py``) with its state pool on the engine's
device; only a missing ``silero_vad.jit`` falls back to the host VAD.
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
        # drawn on the device: a CPU generator takes ~12 s at large-v3
        gen = torch.Generator(device).manual_seed(RANDOM_WEIGHTS_SEED)
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


class LocalAgreementASR:
    """Backend holder for the LocalAgreement and windowed policies — wraps
    the batch decoder (``decoding/task.py``) in ``TorchWhisperASR``."""

    sep = " "

    def __init__(self, config: WLKConfig, model, dims: ModelDimensions, model_name):
        from ..decoding.task import WhisperDecoder
        from ..streaming.local_agreement import TorchWhisperASR

        self.config = config
        self.dims = dims
        self.decoder = WhisperDecoder(model, dims)
        self.asr = TorchWhisperASR(
            self.decoder,
            language=config.lan,
            model_name=model_name,
            buffer_trimming=config.buffer_trimming,
            buffer_trimming_sec=config.buffer_trimming_sec,
            confidence_validation=config.confidence_validation,
            beam_size=config.beams if config.beams > 1 else None,
        )


class CloudASRHolder(LocalAgreementASR):
    """Backend holder for the OpenAI-compatible cloud API (reference
    local_agreement/backends.py:222-287): LocalAgreement policy over a
    remote /v1/audio/transcriptions — no local weights at all."""

    def __init__(self, config: WLKConfig):
        from ..streaming.cloud_backend import CloudWhisperASR

        self.config = config
        self.dims = None
        self.decoder = None
        self.asr = CloudWhisperASR(
            language=config.lan,
            model_name=(
                config.model_size if config.model_size and not str(
                    config.model_size).startswith("random:") else "whisper-1"
            ),
            base_url=getattr(config, "openai_base_url", None),
        )
        if config.direct_english_translation:
            self.asr.direct_english_translation = True


class VoxtralHolder:
    """Backend holder for the Voxtral audio-LLM (windowed streaming)."""

    sep = ""

    def __init__(self, asr):
        self.asr = asr


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

        backend = config.backend or ""
        dtype = _dtype_from_str(config.param_dtype)
        if config.transcription and backend == "openai-api":
            self.asr = CloudASRHolder(config)
            logger.info("Loaded OpenAI-compatible cloud backend (LocalAgreement)")
        elif config.transcription and backend.startswith("qwen3"):
            if getattr(config, "qwen3_audio_backend", "causal") == "windowed":
                logger.warning(
                    "qwen3 windowed re-encode mode is served by the causal "
                    "tower on this build (the windowed policy exists for "
                    "whisper backends via --backend-policy windowed); "
                    "continuing with causal"
                )
            from ..streaming.qwen3_causal import load_qwen3_causal

            self.asr = load_qwen3_causal(config, device=self.device, dtype=dtype)
            if config.scheduler:
                from ..streaming.qwen3_batch import CausalBatchService

                # pooled KV is ~118 MB/lane at 0.6b scale; cap the lane count
                self.scheduler = CausalBatchService(
                    self.asr, capacity=min(config.max_batch_sessions, 32)
                )
            logger.info("Loaded Qwen3-ASR causal backend (append-only tower) on %s", self.device)
        elif config.transcription and backend.startswith("voxtral"):
            if config.backend_policy in ("causal", "realtime"):
                from ..streaming.voxtral_realtime import load_voxtral_realtime

                self.asr = load_voxtral_realtime(config, device=self.device, dtype=dtype)
                if config.scheduler:
                    from ..streaming.qwen3_batch import CausalBatchService

                    self.scheduler = CausalBatchService(
                        self.asr, capacity=min(config.max_batch_sessions, 16)
                    )  # 4B-scale tower: larger per-lane KV
                logger.info("Loaded Voxtral realtime backend (causal streaming) on %s", self.device)
            else:
                from ..models.voxtral_backend import VoxtralASR, load_voxtral

                params, vdims, tok = load_voxtral(config.model_path, dtype=dtype, device=self.device)
                self.asr = VoxtralHolder(
                    VoxtralASR(
                        params, vdims, tok,
                        buffer_trimming=config.buffer_trimming,
                        buffer_trimming_sec=config.buffer_trimming_sec,
                    )
                )
                logger.info("Loaded Voxtral backend (windowed streaming policy) on %s", self.device)
        elif config.transcription:
            model, dims, name = load_whisper_params(config, self.device)
            if config.backend_policy in ("localagreement", "windowed"):
                self.asr = LocalAgreementASR(config, model, dims, name)
            else:
                self.asr = SimulStreamingASR(config, model, dims, name)
                if config.scheduler:
                    from .scheduler import BatchScheduler

                    self.scheduler = BatchScheduler(
                        self.asr.engine,
                        max_lanes=config.max_batch_sessions,
                        incremental_encode=getattr(config, "incremental_encode", True),
                        profile_dir=config.profile_dir,
                    )
            logger.info(
                "Loaded whisper %s (%d-layer enc / %d-layer dec, %s) on %s policy=%s",
                name, dims.n_audio_layer, dims.n_text_layer, config.param_dtype, self.device,
                config.backend_policy,
            )

        if config.vac:
            if config.vad_backend == "jax-batched":
                from ..audio.vad_batched import BatchedVADScheduler

                # only absent weights fall back (JAX falls back on any error)
                try:
                    self.vad_scheduler = BatchedVADScheduler(
                        max_lanes=4 * config.max_batch_sessions, device=self.device
                    )
                    logger.info("batched Silero VAD scheduler on %s", self.device)
                except FileNotFoundError as e:
                    logger.warning("jax-batched VAD unavailable (%s); host VAD", e)
            if self.vad_scheduler is None:
                from ..audio.vad import load_vad_model

                self.vac_model = load_vad_model()
        if config.diarization:
            from ..diarization import load_diarization_model

            self.diarization_model = load_diarization_model(config, device=self.device)
        if config.target_language:
            from ..translation import load_translation_model

            self.translation_model = load_translation_model(config, device=self.device)
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
        audio = np.zeros(16000, np.float32)
        if getattr(proc, "process_iter_async", None) is not None and getattr(
            proc, "service", None
        ) is not None:
            # pooled causal path: run the batched ops when we own the loop;
            # inside a running loop (server startup) warm the local-cache
            # path instead — still fail-loud, and the pooled ops first run
            # on the first session
            import asyncio

            async def _pooled():
                proc.insert_audio_chunk(audio, 1.0)
                await proc.process_iter_async(is_last=True)

            try:
                asyncio.get_running_loop()
            except RuntimeError:
                asyncio.run(_pooled())
            else:
                _warm(online_factory(self.config, self.asr), audio)
        else:
            _warm(proc, audio)
        if hasattr(proc, "close"):
            proc.close()  # release the pooled lanes the warmup session held
        logger.info("Engine warmup complete")

    def warmup(self, path: str) -> None:
        """One real inference at startup on the file's first 5 s; raises if
        broken (reference warmup.py:51-61 fail-loud guard)."""
        from ..audio.io import load_audio

        audio = load_audio(path)[: 16000 * 5]
        _warm(online_factory(self.config, self.asr), audio)
        logger.info("Warmup inference OK")


def _warm(proc, audio) -> None:
    """One inference over ``audio``: the AlignAtt processor's own warmup, or
    one re-transcription tick of a LocalAgreement / windowed processor."""
    if hasattr(proc, "warmup"):
        proc.warmup(audio)
    else:
        proc.insert_audio_chunk(audio, len(audio) / 16000)
        proc.process_iter()


# ---------------------------------------------------------------------------
# Per-session factories (reference core.py:292-361)
# ---------------------------------------------------------------------------


def online_factory(config: WLKConfig, asr, language: Optional[str] = None, scheduler=None):
    from ..streaming.qwen3_causal import Qwen3CausalASR, Qwen3CausalProcessor
    from ..streaming.voxtral_realtime import VoxtralRealtimeASR, VoxtralRealtimeProcessor

    causal_service = None
    if scheduler is not None and hasattr(scheduler, "pools"):
        causal_service = scheduler  # CausalBatchService
    if isinstance(asr, VoxtralRealtimeASR):  # subclass: check before the base
        return VoxtralRealtimeProcessor(asr, service=causal_service)
    if isinstance(asr, Qwen3CausalASR):
        return Qwen3CausalProcessor(asr, service=causal_service)
    if isinstance(asr, VoxtralHolder):
        from ..streaming.windowed import WindowedStreamingProcessor

        return WindowedStreamingProcessor(asr.asr)
    if isinstance(asr, LocalAgreementASR):
        from ..streaming.local_agreement import OnlineASRProcessor
        from ..streaming.windowed import WindowedStreamingProcessor

        backend = asr.asr
        if language and language != config.lan:
            from ..streaming.session_proxy import SessionASRProxy

            backend = SessionASRProxy(backend, language)
        if config.backend_policy == "windowed":
            return WindowedStreamingProcessor(
                backend,
                hold_back_words=getattr(config, "holdback_words", 6),
                chunk_sec=getattr(config, "qwen3_chunk_sec", 0.0),
                right_context_ms=getattr(config, "qwen3_right_context_ms", 0),
                context=getattr(config, "qwen3_context", ""),
            )
        return OnlineASRProcessor(backend)

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
    return diarization_model.new_session()


def online_translation_factory(config: WLKConfig, translation_model):
    if translation_model is None:
        return None
    return translation_model.new_session(
        src=config.lan if config.lan != "auto" else "en",
        tgt=config.target_language,
    )


def session_translation_factory(config: WLKConfig, translation_model, target_language: str):
    if translation_model is None:
        return None
    return translation_model.new_session(
        src=config.lan if config.lan != "auto" else "en",
        tgt=target_language,
    )
