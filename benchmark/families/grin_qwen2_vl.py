"""Uni-MoE-2.0-Omni (``model_type`` ``grin_qwen2_vl``) on the port's causal
audio-LLM path: ``Qwen3CausalASR`` with its ``CausalBatchService`` and one
``Qwen3CausalProcessor`` a session, as ``engine/core.py`` builds them for
``--backend qwen3`` with the scheduler on, the model's dims read from the
published config's keys (``qwen3_asr.dims_from_grin_qwen2_vl``): a
Whisper-large tower, a linear projector and 28 Qwen2 layers whose FFN is
the dynamic mixture of experts.

What differs from ``families/qwen3_causal.py``, whose recorder, op counter,
context and judge's rules this family reuses:

- ``draw`` draws tensor by tensor (an expert stack expert by expert) in
  float32 on the device and keeps each in the serving dtype: at published
  widths the model is 26.8 B parameters, 53.6 GB in bf16, and one draw of
  them all in float32 would not fit. Each tensor (or expert) has generators
  of its own, seeded from (``weights.base_seed``, its index) and (``--seed``,
  its index); the second's draw is added at ``weights.perturbation`` of the
  tensor's scale. The router is drawn at ``weights.router_scale`` times a
  linear layer's scale, so that top-p acts on a share of the tokens.
- ``System`` holds the drawn tensors themselves (the converter keeps a
  tensor already on the device in the dtype), not copies.
- ``scheduler.stats()`` carries ``trace``, the tracer's aggregates (its
  spans and counters: ``causal.*``, ``moe.*``), which ``reset_stats()``
  zeroes at the window's start; the per-layer readers ``*.causal`` read them.
- ``judge`` replays with ``reference/unimoe_ref.py``.

The state dict's layout (``llama.convert_hf_state_dict``): the tower and
projector as Qwen3-ASR's; per text layer ``self_attn.{q,k,v}_proj.{weight,
bias}``, ``self_attn.o_proj.weight``, ``mlp.gate.weight`` (the router, routed
outputs first, then the null one) and the stacks ``mlp.experts.{gate,up,
down}_proj`` [E, ff, hidden] and ``mlp.shared_experts.{gate,up,down}_proj``
[S, ff_shared, hidden] (down as the matrix a row multiplies).
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from lib.judge import pick, verdict
from reference import unimoe_ref as U


def _sibling(name: str):
    """A family beside this one, loaded by path under the key ``run.family``
    gives it."""
    key = f"bench_family_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, Path(__file__).with_name(f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


QC = _sibling("qwen3_causal")
context = QC.context


def assets(cache_dir) -> None:
    """Nothing on disk: the holder's debug tokenizer maps ids to words."""
    return None


def shapes(cfg: dict) -> list:
    """(name, shape, kind) of every tensor; kind picks the scale."""
    a = cfg["audio_config"]
    d, m, ff = a["d_model"], a["num_mel_bins"], a["encoder_ffn_dim"]
    out = [("audio_tower.conv1.weight", (d, m, 3), "conv"), ("audio_tower.conv1.bias", (d,), "small"),
           ("audio_tower.conv2.weight", (d, d, 3), "conv"), ("audio_tower.conv2.bias", (d,), "small")]

    def lin(p: str, n_out: int, n_in: int, bias: bool, kind: str = "linear") -> None:
        out.append((f"{p}.weight", (n_out, n_in), kind))
        if bias:
            out.append((f"{p}.bias", (n_out,), "small"))

    for i in range(a["encoder_layers"]):
        p = f"audio_tower.layers.{i}"
        out += [(f"{p}.self_attn_layer_norm.weight", (d,), "gain"), (f"{p}.self_attn_layer_norm.bias", (d,), "small")]
        for proj in ("q", "k", "v", "out"):
            lin(f"{p}.self_attn.{proj}_proj", d, d, proj != "k")  # the key projection has no bias
        out += [(f"{p}.final_layer_norm.weight", (d,), "gain"), (f"{p}.final_layer_norm.bias", (d,), "small")]
        lin(f"{p}.fc1", ff, d, True)
        lin(f"{p}.fc2", d, ff, True)
    out += [("audio_tower.layer_norm.weight", (d,), "gain"), ("audio_tower.layer_norm.bias", (d,), "small")]
    D, V = cfg["hidden_size"], cfg["vocab_size"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg.get("head_dim") or D // H
    E, N0, S = cfg["mlp_dynamic_expert_num"], cfg["mlp_dynamic_null_expert_num"], cfg["mlp_fixed_expert_num"]
    lin("multi_modal_projector.linear", D, a["downsample"] * d, False)
    out.append(("model.embed_tokens.weight", (V, D), "embed"))
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}"
        out.append((f"{p}.input_layernorm.weight", (D,), "gain"))
        for proj, n_out in (("q", H * dh), ("k", KV * dh), ("v", KV * dh)):
            lin(f"{p}.self_attn.{proj}_proj", n_out, D, True)
        lin(f"{p}.self_attn.o_proj", D, H * dh, False)
        out.append((f"{p}.post_attention_layernorm.weight", (D,), "gain"))
        lin(f"{p}.mlp.gate", E + N0, D, False, "router")
        for stack, n, width in (("experts", E, cfg["dynamic_intermediate_size"]),
                                ("shared_experts", S, cfg["shared_intermediate_size"])):
            for proj in ("gate", "up", "down"):
                out.append((f"{p}.mlp.{stack}.{proj}_proj", (n, width, D), "expert_" + proj))
    out.append(("model.norm.weight", (D,), "gain"))
    lin("lm_head", V, D, False)
    return out


def _scale(kind: str, shape: tuple, spec: dict) -> float:
    if kind == "linear":
        return shape[1] ** -0.5
    if kind == "router":
        return float(spec.get("router_scale", 1.0)) * shape[1] ** -0.5
    if kind == "conv":
        return (3 * shape[1]) ** -0.5
    if kind == "expert_down":
        return shape[1] ** -0.5  # a row of width ff multiplies it
    if kind.startswith("expert_"):
        return shape[2] ** -0.5
    return 0.02  # embed, small, gain (around 1)


def _randn(shape, seed: int, i: int, j: int, device) -> torch.Tensor:
    state = np.random.SeedSequence([int(seed) % 2 ** 64, i, j]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device).manual_seed(int(state))
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def port_dims(cfg: dict):
    from whisperlivekit_tpu_torch.models import qwen3_asr as qm

    return qm.dims_from_grin_qwen2_vl(cfg, cfg["audio_config"])


@torch.no_grad()
def draw(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The state dict for ``seed``: the same seed gives the same tensors.
    The port's dims are built first, so a program that cannot run the
    configuration raises before anything is drawn."""
    port_dims(cfg)
    spec = cfg["weights"]
    pert = float(spec["perturbation"])
    sd = {}
    for i, (name, shape, kind) in enumerate(shapes(cfg)):
        scale = _scale(kind, shape, spec)
        stacked = kind.startswith("expert_")
        out = sd[name] = torch.empty(shape, dtype=dtype, device=device)
        for j, part in enumerate(out if stacked else [out]):
            x = _randn(part.shape, spec["base_seed"], i, j, device)
            x.add_(_randn(part.shape, seed, i, j, device), alpha=pert).mul_(scale)
            if kind == "gain":
                x += 1.0
            part.copy_(x)
            del x
    return sd


class _Ops(QC._Ops):
    """The sessions' failed ops, and the tracer's aggregates, from the
    window's start."""

    def reset_stats(self) -> None:
        from whisperlivekit_tpu_torch.engine.trace import TRACER

        super().reset_stats()
        TRACER.reset()

    def stats(self) -> dict:
        from whisperlivekit_tpu_torch.engine.trace import aggregates

        return dict(super().stats(), trace=aggregates())


class System:
    """The port's causal holder and op service for the configuration."""

    def __init__(self, cfg: dict, state_dict, device, control: Optional[str] = None):
        if control is not None:
            raise ValueError(f"the grin_qwen2_vl family has no control {control!r}")
        from whisperlivekit_tpu_torch.models import qwen3_asr as qm
        from whisperlivekit_tpu_torch.streaming.qwen3_batch import CausalBatchService
        from whisperlivekit_tpu_torch.streaming.qwen3_causal import Qwen3CausalASR

        serving = cfg["serving"]
        dims = port_dims(cfg)
        params = qm.convert_hf_state_dict(state_dict, dims, dtype=getattr(torch, serving["dtype"]), device=device)
        self.holder = Qwen3CausalASR(
            params, dims, prompt_ids=serving["prompt_ids"], hyp_start_ids=serving["hyp_start_ids"],
            eos_id=cfg["eos_token_id"], window_s=serving["window_s"], hold_back_words=serving["hold_back_words"],
            max_new=serving["max_new"])
        self.service = CausalBatchService(self.holder, capacity=int(serving["capacity"]))
        self.scheduler = _Ops()
        self.recorder = QC.Recorder(self.scheduler)
        self.lanes = int(serving["max_lanes"])

    def new_session(self):
        from whisperlivekit_tpu_torch.streaming.qwen3_causal import Qwen3CausalProcessor

        return Qwen3CausalProcessor(self.holder, service=self.service)

    def phase_stats(self) -> dict:
        return {}

    def anchor_reasons(self) -> dict:
        return {}

    def close(self) -> None:
        """Drop every reference to the program's state."""
        self.scheduler = None
        self.service = None
        self.holder = None


def judge(records: List, w0: float, w1: float, seed: int, cfg: dict, state_dict, audio_of,
          tail_frames: int, assets, device, tokens: int = 400, max_sessions: int = 8) -> dict:
    """``families/qwen3_causal.judge``'s rules with this model's reference:
    every token a decode of a tick returned in the window chose, for a
    sample of sessions; each decode is one forward of the reference over
    its segment."""
    serving = cfg["serving"]
    max_new, eos = int(serving["max_new"]), int(cfg["eos_token_id"])
    window = [r for r in records if w0 <= r.t_done <= w1]
    scored: Dict[int, int] = {}
    for r in window:
        scored[r.sid] = scored.get(r.sid, 0) + sum(len(QC._served(d, max_new, eos)) for d in r.decodes)
    chosen = pick(scored, seed, tokens, max_sessions)
    model = U.UniMoE(state_dict, U.dims(cfg), device)
    bs = model.d.block_samples
    gaps: List[float] = []
    replayed = 0
    for sid in chosen:
        for r in sorted((r for r in window if r.sid == sid), key=lambda r: r.t_prep):
            for d in r.decodes:
                audio = np.zeros(d.blocks * bs, np.float32)
                audio[: d.real] = audio_of(sid, d.first + d.real)[d.first:]
                blocks = torch.from_numpy(audio).to(device).view(d.blocks, bs)
                gaps += model.gaps(blocks, list(serving["prompt_ids"]) + d.carry, list(serving["hyp_start_ids"]),
                                   QC._served(d, max_new, eos))
            replayed += 1
    return verdict(gaps, chosen, replayed)
