"""CLI argument parsing mirror of WLKConfig (reference parse_args.py:5-834).

Every config field is exposed as a dashed flag; booleans that default True
get a ``--no-*`` negation (reference convention).
"""

from __future__ import annotations

import argparse
from dataclasses import MISSING, fields
from typing import Optional

from .config import WLKConfig

_GROUPS = {
    "Server": {
        "host", "port", "api_token", "ssl_certfile", "ssl_keyfile",
        "forwarded_allow_ips", "cors_origins", "log_level",
    },
    "Pipeline": {
        "transcription", "vad", "vac", "vac_chunk_size", "pcm_input",
        "diarization", "diarization_backend", "sortformer_model_path",
        "punctuation_split", "retention_seconds", "rest_timeout",
    },
    "Model": {
        "model_size", "model_cache_dir", "model_dir", "model_path",
        "encoder_model_path", "decoder_model_path", "lora_path", "lan",
        "warmup_file", "backend", "backend_policy", "min_chunk_size",
        "direct_english_translation",
    },
    "SimulStreaming": {
        "frame_threshold", "beams", "decoder_type", "audio_max_len",
        "audio_min_len", "cif_ckpt_path", "never_fire", "init_prompt",
        "static_init_prompt", "max_context_tokens", "custom_alignment_heads",
    },
    "LocalAgreement": {
        "buffer_trimming", "buffer_trimming_sec", "confidence_validation",
    },
    "Translation": {
        "target_language", "translation_backend", "translate_on_complete",
        "nllb_backend", "nllb_size", "alignatt_url", "alignatt_preset",
        "alignatt_latency", "alignatt_context",
    },
    "Diarization models": {"segmentation_model", "embedding_model"},
    "TPU engine": {
        "compute_dtype", "param_dtype", "decode_block_tokens",
        "max_decode_tokens", "max_batch_sessions", "scheduler", "mesh_shape",
        "donate_kv_cache", "profile_dir", "incremental_encode",
    },
}


def build_parser(prog: str = "wlk") -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog=prog,
        description="TPU-native real-time streaming speech-to-text server",
    )
    field_to_group = {f: g for g, fs in _GROUPS.items() for f in fs}
    groups = {g: parser.add_argument_group(g) for g in _GROUPS}

    for f in fields(WLKConfig):
        flag = "--" + f.name.replace("_", "-")
        grp = groups.get(field_to_group.get(f.name, "Model"), parser)
        default = f.default if f.default is not MISSING else None
        if f.type in ("bool", bool) or isinstance(default, bool):
            if default:  # default-True booleans get --no-*
                grp.add_argument(
                    "--no-" + f.name.replace("_", "-"),
                    dest=f.name,
                    action="store_false",
                    default=True,
                    help=f"disable {f.name}",
                )
            else:
                grp.add_argument(flag, dest=f.name, action="store_true", default=False)
        elif isinstance(default, int) and not isinstance(default, bool):
            grp.add_argument(flag, dest=f.name, type=int, default=default)
        elif isinstance(default, float):
            grp.add_argument(flag, dest=f.name, type=float, default=default)
        else:
            grp.add_argument(flag, dest=f.name, type=str, default=default)

    # compat aliases from the reference CLI
    parser.add_argument(
        "--language", dest="lan", type=str, default=argparse.SUPPRESS, help=argparse.SUPPRESS
    )
    parser.add_argument(
        "--model", dest="model_size", type=str, default=argparse.SUPPRESS, help=argparse.SUPPRESS
    )
    return parser


def parse_args(argv: Optional[list] = None, prog: str = "wlk") -> WLKConfig:
    ns = build_parser(prog).parse_args(argv)
    return WLKConfig.from_namespace(ns)
