"""Model FLOPs and expert-weight bytes of Uni-MoE-2.0-Omni's causal path,
from the published shapes (a ``grin_qwen2_vl`` configuration, the tower's
sizes under ``audio_config``) and the program's counters
(``stats()["trace"]["counters"]``), never from which kernels ran.

FLOPs count each multiply-add as two: the tower's convolutions, blocks and
projector for every appended row (``causal.append_rows``, one block
each); for every row through an expert layer (``moe.rows``, one per layer)
the attention projections, the router and the shared experts; the routed
experts for each (row, expert) pair the router chose (``moe.pairs``); the
output head for every logits row (``causal.logits_rows``). Attention's own
products (QK^T and PV) are left out: the counters carry no positions, and
at these lengths they are about 1-2 % of an op. Rows count as computed,
padding included.
"""

from __future__ import annotations

from typing import Dict


def tower_flops(cfg: dict) -> float:
    """One appended block: both convolutions, the blocks' projections and
    FFN over its frames, and the projector."""
    a = cfg["audio_config"]
    m, d, ff, fr = a["num_mel_bins"], a["d_model"], a["encoder_ffn_dim"], a["block_frames"]
    conv = 2.0 * m * d * 3 * (2 * fr) + 2.0 * d * d * 3 * fr
    blocks = a["encoder_layers"] * 2.0 * fr * (4 * d * d + 2 * d * ff)
    return conv + blocks + 2.0 * fr * d * cfg["hidden_size"]


def row_layer_flops(cfg: dict) -> float:
    """One row through one text layer, less its routed experts."""
    D, H, KV = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg.get("head_dim") or D // H
    attn = 2.0 * D * (H + 2 * KV) * dh + 2.0 * H * dh * D
    router = 2.0 * D * (cfg["mlp_dynamic_expert_num"] + cfg["mlp_dynamic_null_expert_num"])
    shared = cfg["mlp_fixed_expert_num"] * 3 * 2.0 * D * cfg["shared_intermediate_size"]
    return attn + router + shared


def pair_flops(cfg: dict) -> float:
    """One row through one routed expert (a SwiGLU: gate, up, down)."""
    return 3 * 2.0 * cfg["hidden_size"] * cfg["dynamic_intermediate_size"]


def head_flops(cfg: dict) -> float:
    return 2.0 * cfg["hidden_size"] * cfg["vocab_size"]


def window_flops(cfg: dict, counters: Dict[str, int]) -> float:
    return (counters.get("causal.append_rows", 0) * tower_flops(cfg)
            + counters.get("moe.rows", 0) * row_layer_flops(cfg)
            + counters.get("moe.pairs", 0) * pair_flops(cfg)
            + counters.get("causal.logits_rows", 0) * head_flops(cfg))


def expert_bytes(cfg: dict, itemsize: int = 2):
    """(one routed expert's weight bytes, all shared experts' bytes)."""
    D = cfg["hidden_size"]
    routed = 3 * D * cfg["dynamic_intermediate_size"] * itemsize
    shared = cfg["mlp_fixed_expert_num"] * 3 * D * cfg["shared_intermediate_size"] * itemsize
    return routed, shared
