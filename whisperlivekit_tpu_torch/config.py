"""Typed configuration — the single source of truth for the whole framework.

Equivalent surface to the reference's ``WhisperLiveKitConfig``
(reference config.py:18-179): one dataclass consumed by the engine, the CLI
argparse mirror, and the programmatic kwargs path. Field names are kept
compatible where the concept survives the TPU redesign, so users migrating
from the reference find their flags. TPU-specific knobs live in the
"TPU engine" section.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, fields
from typing import Optional

logger = logging.getLogger(__name__)


def parse_cors_origins(origins) -> list:
    """Parse comma-separated CORS origins (reference config.py:10-15)."""
    if origins is None:
        return []
    if isinstance(origins, (list, tuple)):
        return [str(o).strip() for o in origins if str(o).strip()]
    return [o.strip() for o in str(origins).split(",") if o.strip()]


@dataclass
class WLKConfig:
    """All configuration with defaults matching the reference behavior."""

    # ---- Server / global -------------------------------------------------
    host: str = "localhost"
    port: int = 8000
    api_token: Optional[str] = None          # None = no auth; WLK_API_TOKEN env applies
    translate_on_complete: bool = False
    diarization: bool = False
    punctuation_split: bool = False
    target_language: str = ""
    translation_backend: str = "nllb"        # "nllb" in-process | "alignatt" sidecar
    alignatt_url: str = "ws://localhost:8765"
    alignatt_preset: Optional[str] = None
    alignatt_latency: str = "balanced"       # quality | balanced | low
    alignatt_context: str = ""
    vac: bool = True                         # voice-activity-controlled segmentation
    vac_chunk_size: float = 0.04             # seconds per VAD tick
    vad_backend: str = "auto"                # auto (host silero/energy) | jax-batched (batched Silero on the engine's device)
    log_level: str = "DEBUG"
    ssl_certfile: Optional[str] = None
    ssl_keyfile: Optional[str] = None
    forwarded_allow_ips: Optional[str] = None
    cors_origins: str = ""
    transcription: bool = True
    vad: bool = True
    pcm_input: bool = False                  # raw s16le/f32 PCM in, skip decode step
    diarization_backend: str = "sortformer"  # sortformer | energy
    sortformer_model_path: Optional[str] = None
    backend_policy: str = "simulstreaming"   # simulstreaming | localagreement
    backend: str = "auto"                    # auto resolves to "jax" here

    # ---- Transcription common --------------------------------------------
    warmup_file: Optional[str] = None
    min_chunk_size: float = 0.1
    retention_seconds: Optional[float] = None  # None = auto (inf full / 300 diff)
    rest_timeout: float = 0.0                  # 0 = auto max(120, 2.5x audio)
    model_size: str = "base"
    model_cache_dir: Optional[str] = None
    model_dir: Optional[str] = None
    model_path: Optional[str] = None
    encoder_model_path: Optional[str] = None
    decoder_model_path: Optional[str] = None
    lora_path: Optional[str] = None
    lan: str = "auto"
    direct_english_translation: bool = False

    # ---- LocalAgreement policy --------------------------------------------
    buffer_trimming: str = "segment"         # segment | sentence
    confidence_validation: bool = False
    buffer_trimming_sec: float = 15.0

    # ---- SimulStreaming / AlignAtt policy ----------------------------------
    frame_threshold: int = 25                # encoder frames of attention headroom
    beams: int = 1
    decoder_type: Optional[str] = None       # greedy | beam (None = auto from beams)
    audio_max_len: float = 30.0              # audio window (s); also jit pad target
    audio_min_len: float = 0.0
    cif_ckpt_path: Optional[str] = None
    never_fire: bool = False
    init_prompt: Optional[str] = None
    static_init_prompt: Optional[str] = None
    max_context_tokens: Optional[int] = None
    custom_alignment_heads: Optional[str] = None

    # ---- Diarization -------------------------------------------------------
    segmentation_model: str = "pyannote/segmentation-3.0"
    embedding_model: str = "pyannote/embedding"

    # ---- Qwen3 streaming (reference config.py:104-149; honored subset —
    # vLLM/Metal/CUDA device knobs are N/A on the TPU engine and warn+drop
    # through the reference-name aliases below) ------------------------------
    qwen3_audio_backend: str = "causal"      # causal | windowed
    qwen3_block_frames: int = 0              # causal tower block (enc frames; 0 = from chunk_sec)
    qwen3_chunk_sec: float = 2.0             # causal block / windowed re-transcribe granularity
    qwen3_hold_back_words: int = 2           # frontier words held from commit
    qwen3_right_context_ms: int = 640        # windowed: frontier time not yet committed
    qwen3_max_new_tokens: int = 48           # hypothesis budget per tick
    qwen3_window_sec: float = 15.0           # bounded audio window before reset
    qwen3_segment_max_steps: int = 200       # hypothesis steps forcing a segment flush
    qwen3_segment_keep_tail_steps: int = 0   # hypothesis tail carried across a forced flush
    qwen3_stable_iterations: Optional[int] = None  # None = auto (1 causal, 2 windowed)
    qwen3_context: str = ""                  # static text context prepended to the prompt
    qwen3_prompt_context_words: int = 0      # committed words re-primed after segment reset
    qwen3_tower_checkpoint: Optional[str] = None
    holdback_words: int = 6                  # windowed-policy hold-back (reference name)
    trim_sentence_buffer: bool = False       # LA: trim at sentences, not segments

    # ---- Translation -------------------------------------------------------
    nllb_backend: str = "jax"                # this framework runs NLLB in JAX
    nllb_size: str = "600M"

    # ---- TPU engine (net-new vs reference) ---------------------------------
    compute_dtype: str = "bfloat16"          # matmul dtype on the MXU
    param_dtype: str = "bfloat16"
    decode_block_tokens: int = 8             # decode steps fused per device call
    max_decode_tokens: int = 224             # hard cap per streaming inference
    max_batch_sessions: int = 96             # scheduler lane-group width cap
                                             # (auto-bounded per model scale)
    scheduler: bool = True                   # multi-session batch scheduler on/off
    # Incremental encoding trades exactness for ~3-6x encoder throughput:
    # cached frames saw only tail-local attention + a tail-local mel floor,
    # so inc-mode transcripts can differ slightly from full re-encode
    # (docs/perf/README.md). --no-incremental-encode restores exact ticks.
    incremental_encode: bool = True
    xkv_f8: bool = False                     # f8 cross-KV storage (large-model throughput)
    xkv_cache: str = "auto"                  # group cross-KV cache: auto|on|off
    xkv_cache_dtype: str = "bf16"            # pool storage: bf16 (exact) | f8 (capacity)
    xkv_anchor_cohorts: int = 1              # stagger group re-anchors (p95 tail)
    serving_prefix_cap: int = 0              # pooled-serving decode-prefix bound
                                             # (context trimmed first). 0 = auto
                                             # (96 when the cross-KV pool serves).
                                             # Sizes the self-KV pool width, so
                                             # capacity trades ~linearly against
                                             # text-context length — the measured
                                             # curve is docs/perf/
                                             # probe_skv_width.json; the reference
                                             # lets context reach ~428 tokens
                                             # (align_att_base.py:100-113) at
                                             # per-session-decode cost.
    serving_commit_budget: int = 16          # extra self-KV pool rows past the
                                             # prefix cap: mid-epoch commits grow
                                             # the prefix into this slack instead
                                             # of trimming the head every ~block,
                                             # so trims (which shift every row's
                                             # position and force the padded
                                             # full-width refresh program for the
                                             # whole lane group) align with the
                                             # eviction anchors that pay a full
                                             # prefill anyway. Costs pool width
                                             # (~1.4 ms/row on the B=32 f8 tick,
                                             # probe_skv_width.json) — measured
                                             # e2e n=24: inc group ticks averaged
                                             # 2.5x the model cost because ~3
                                             # lanes/tick had trimmed. 0 = legacy
                                             # trim-at-cap behavior.
    max_decode_steps: int = 8                # per-tick decode budget (static device
                                             # loop bound). Exhaustion keeps tokens
                                             # and the next tick continues; final
                                             # flushes drain in a loop
                                             # (simul_processor._FINAL_DRAIN_TICKS).
                                             # 8 covers real-time speech flux
                                             # (~3-5 tokens/s) and bounds a
                                             # hallucination-looping lane's tax on
                                             # its 24-lane group; raise for
                                             # burst-heavy offline use.
    max_sessions: int = 0                    # admission cap; 0 = auto (pooled-slot
                                             # capacity when the cross-KV pool is
                                             # the serving path, else unlimited).
                                             # Beyond it /asr rejects with "busy"
                                             # instead of degrading everyone onto
                                             # the full re-encode fallback path.
    decoder_dtype: str = "bf16"              # decoder linear weight storage: bf16
                                             # (exact) | f8 (weight-only e4m3,
                                             # halves per-step HBM weight read)
    openai_base_url: Optional[str] = None    # backend=openai-api endpoint override
    mesh_shape: Optional[str] = None         # e.g. "data:4,model:2"; None = 1 chip
    donate_kv_cache: bool = True
    profile_dir: Optional[str] = None        # jax.profiler trace output

    def __post_init__(self) -> None:
        if self.model_size and self.model_size.endswith(".en"):
            self.lan = "en"
        if self.backend_policy == "1":
            self.backend_policy = "simulstreaming"
        elif self.backend_policy == "2":
            self.backend_policy = "localagreement"
        if self.trim_sentence_buffer:
            self.buffer_trimming = "sentence"

    # ---- factories ---------------------------------------------------------

    @classmethod
    def from_namespace(cls, ns) -> "WLKConfig":
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in vars(ns).items() if k in known})

    @classmethod
    def from_kwargs(cls, **kwargs) -> "WLKConfig":
        """Programmatic path; reference flag names alias onto ours, unknown
        keys warn and are dropped, and the reference's ``no_*`` negation
        convention is honored (reference core.py:82-93)."""
        normalized = {}
        for k, v in kwargs.items():
            k = _REFERENCE_ALIASES.get(k, k)
            if k.startswith("no_") and isinstance(v, bool):
                normalized.setdefault(k[3:], not v)
            else:
                normalized[k] = v
        known = {f.name for f in fields(cls)}
        unknown = set(normalized) - known
        if unknown:
            logger.warning("Unknown config keys ignored: %s", sorted(unknown))
        return cls(**{k: v for k, v in normalized.items() if k in known})


#: Reference flag names → this framework's fields (migration compatibility;
#: reference parse_args.py / config.py:104-149). vLLM/Metal/device knobs have
#: no TPU counterpart and fall through to the warn-and-drop path.
_REFERENCE_ALIASES = {
    "qwen3_streaming_audio_backend": "qwen3_audio_backend",
    "qwen3_streaming_block_frames": "qwen3_block_frames",
    "qwen3_streaming_chunk_sec": "qwen3_chunk_sec",
    "qwen3_streaming_hold_back_words": "qwen3_hold_back_words",
    "qwen3_streaming_right_context_ms": "qwen3_right_context_ms",
    "qwen3_streaming_max_new_tokens": "qwen3_max_new_tokens",
    "qwen3_streaming_left_context_sec": "qwen3_window_sec",
    "qwen3_streaming_segment_max_steps": "qwen3_segment_max_steps",
    "qwen3_streaming_segment_keep_tail_steps": "qwen3_segment_keep_tail_steps",
    "qwen3_streaming_stable_iterations": "qwen3_stable_iterations",
    "qwen3_streaming_context": "qwen3_context",
    "qwen3_streaming_prompt_context_words": "qwen3_prompt_context_words",
    "qwen3_streaming_tower_checkpoint": "qwen3_tower_checkpoint",
    "qwen3_vllm_tower_checkpoint": "qwen3_tower_checkpoint",
    "qwen3_vllm_block_frames": "qwen3_block_frames",
    "qwen3_vllm_segment_max_steps": "qwen3_segment_max_steps",
    "qwen3_vllm_prompt_context_words": "qwen3_prompt_context_words",
    "qwen3_vllm_left_context_sec": "qwen3_window_sec",
    "disable_punctuation_split": "no_punctuation_split",
}

# Backwards-compatible alias for users porting from the reference.
WhisperLiveKitConfig = WLKConfig
