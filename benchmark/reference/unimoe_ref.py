"""Plain float32 reference of Uni-MoE-2.0-Omni's audio-in, text-out path.

This file imports only torch, numpy and the causal reference beside it,
whose front end and block-causal tower it reuses (``causal_ref.py``: a
Whisper-shaped encoder over blocks of ``block_frames`` frames, each frame
seeing every frame up to the end of its own block, then ``downsample``
frames to one audio token through one linear projection). It knows nothing
of the program under test: it is handed the weights (a state dict in the
layout the benchmark draws), a segment's audio, the prompt ids and the
tokens the program served, and scores each served token by how far its
logit lies below the reference's best.

The text tower is Qwen2's (RMSNorm, RoPE with the half-split convention,
grouped-query attention with biases on q, k and v and none on o) whose FFN
is the dynamic mixture of experts, with h the RMSNorm of the residual:

    y = sum over shared experts s of SwiGLU_s(h)
      + sum over chosen routed experts e of p_e * SwiGLU_e(h)

where ``p = softmax(W_r h)`` over the routed and the null experts, in
float32, and the chosen set is built token by token: experts in order of
``p`` (ties to the lower index), each taken while the mass already taken
is under ``mlp_dynamic_top_p`` and fewer than ``mlp_dynamic_top_k`` are
taken; a null expert counts and adds nothing. ``SwiGLU(h) = (silu(h
G^T) * (h U^T)) D`` with the stacks' layout: gate and up [ff, d] each,
down [ff, d] (the row multiplies it). The whole sequence ``[prompt | audio
tokens | hypothesis start | hypothesis]`` runs in one causal forward, with
no cache and no batch. Matmuls run in float32 with TF32 off.

Weights stay in their own dtype (bf16 at full size, 52 GB); a tensor is
widened to float32 only while it is used, and a routed expert's three
matrices only while its tokens run (at published widths the largest at a
time is the 2.2 GB output head, or an expert's 0.8 GB), so the reference
fits on the card beside the state dict once the program has closed.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from . import causal_ref as C
from .whisper_ref import mel_filters, no_tf32, sinusoids


@dataclass(frozen=True)
class Dims(C.Dims):
    n_routed: int
    n_null: int
    n_shared: int
    top_p: float
    top_k: int


def dims(cfg: dict) -> Dims:
    """From a ``grin_qwen2_vl`` configuration: the published keys at the top
    level, the tower's sizes under ``audio_config``."""
    a = cfg["audio_config"]
    heads = cfg["num_attention_heads"]
    return Dims(n_mels=a["num_mel_bins"], d_audio=a["d_model"], audio_heads=a["encoder_attention_heads"],
                audio_layers=a["encoder_layers"], downsample=a["downsample"], block_frames=a["block_frames"],
                max_frames=a["max_frames"], hidden=cfg["hidden_size"], layers=cfg["num_hidden_layers"],
                heads=heads, kv_heads=cfg["num_key_value_heads"],
                head_dim=cfg.get("head_dim") or cfg["hidden_size"] // heads,
                rope_theta=float(cfg["rope_theta"]), rms_eps=float(cfg["rms_norm_eps"]),
                n_routed=cfg["mlp_dynamic_expert_num"], n_null=cfg["mlp_dynamic_null_expert_num"],
                n_shared=cfg["mlp_fixed_expert_num"], top_p=float(cfg["mlp_dynamic_top_p"]),
                top_k=int(cfg["mlp_dynamic_top_k"]))


class _Widened(Mapping):
    """The state dict's tensors, each widened to float32 on the device when
    it is read (and freed when the reader drops it)."""

    def __init__(self, sd: Dict[str, torch.Tensor], device):
        self.sd, self.device = sd, device

    def __getitem__(self, k):
        return self.sd[k].to(device=self.device, dtype=torch.float32)

    def __iter__(self):
        return iter(self.sd)

    def __len__(self):
        return len(self.sd)


def top_p_set(probs: List[float], top_p: float, top_k: int) -> List[int]:
    """The experts one token takes, from its router probabilities (float32
    values), summed in float32 in the order they are taken."""
    order = sorted(range(len(probs)), key=lambda e: (-probs[e], e))
    taken: List[int] = []
    mass = np.float32(0.0)
    for e in order:
        if len(taken) == top_k or mass >= np.float32(top_p):
            break
        taken.append(e)
        mass = np.float32(mass + np.float32(probs[e]))
    return taken


class UniMoE(C.CausalLM):
    def __init__(self, sd: Dict[str, torch.Tensor], dims: Dims, device):
        no_tf32()
        self.sd = sd
        self.w = _Widened(sd, device)
        self.d = dims
        self.device = torch.device(device)
        self.filters = torch.from_numpy(mel_filters(dims.n_mels)).to(device)
        self.pos = sinusoids(dims.max_frames, dims.d_audio).to(device)

    def embed(self, ids) -> torch.Tensor:
        rows = torch.tensor(list(ids), dtype=torch.long, device=self.device)
        return self.sd["model.embed_tokens.weight"][rows].to(device=self.device, dtype=torch.float32)

    def swiglu(self, h: torch.Tensor, stack: str, e: int) -> torch.Tensor:
        g, u, dn = (self.sd[f"{stack}.{m}_proj"][e].to(device=self.device, dtype=torch.float32)
                    for m in ("gate", "up", "down"))
        return (F.silu(h @ g.T) * (h @ u.T)) @ dn

    def moe(self, h: torch.Tensor, p: str) -> torch.Tensor:
        """The expert layer of layer prefix ``p`` on h [S, hidden]."""
        d = self.d
        probs = torch.softmax(h @ self.w[f"{p}.mlp.gate.weight"].T, dim=-1)
        chosen = [top_p_set(row, d.top_p, d.top_k) for row in probs.tolist()]
        y = torch.zeros_like(h)
        for s in range(d.n_shared):
            y = y + self.swiglu(h, f"{p}.mlp.shared_experts", s)
        for e in range(d.n_routed):
            rows = [n for n, c in enumerate(chosen) if e in c]
            if rows:
                idx = torch.tensor(rows, dtype=torch.long, device=self.device)
                y[idx] += probs[idx, e, None] * self.swiglu(h[idx], f"{p}.mlp.experts", e)
        return y

    def text_logits(self, embeds: torch.Tensor) -> torch.Tensor:
        """[S, hidden] input embeddings -> [S, vocab] logits, causal."""
        d = self.d
        S = embeds.shape[0]
        pos = torch.arange(S, device=self.device)
        mask = torch.zeros(S, S, device=self.device).masked_fill(pos[None, :] > pos[:, None], float("-inf"))
        H, KV, dh = d.heads, d.kv_heads, d.head_dim
        x = embeds
        for i in range(d.layers):
            p = f"model.layers.{i}"
            h = self._rms(x, self.w[f"{p}.input_layernorm.weight"])
            q = self._rope(self._lin(h, f"{p}.self_attn.q_proj").view(S, H, dh), pos)
            k = self._rope(self._lin(h, f"{p}.self_attn.k_proj").view(S, KV, dh), pos)
            v = self._lin(h, f"{p}.self_attn.v_proj").view(S, KV, dh)
            rep = H // KV  # query head h reads key head h // rep
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
            att = torch.softmax(q.transpose(0, 1) @ k.permute(1, 2, 0) * dh ** -0.5 + mask, dim=-1)
            x = x + self._lin((att @ v.transpose(0, 1)).transpose(0, 1).reshape(S, H * dh), f"{p}.self_attn.o_proj")
            x = x + self.moe(self._rms(x, self.w[f"{p}.post_attention_layernorm.weight"]), p)
        return F.linear(self._rms(x, self.w["model.norm.weight"]), self.w["lm_head.weight"])
