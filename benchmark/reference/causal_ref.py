"""Plain float32 reference of a causal audio LLM (Qwen3-ASR's layout).

This file imports only torch, numpy and the Whisper reference's front end
beside it. It knows nothing of the program under test: it is handed the
weights (an HF-layout state dict that the benchmark drew), a segment's
audio as the benchmark fed it, the prompt ids and the tokens the program
served, and it scores each served token by how far its logit lies below
the reference's best.

Model: each block of ``block_frames`` encoder frames (two mel frames
each) is framed on its own: log-mel of the block's samples alone (Whisper's,
floored 8 below the block's max), two GELU convolutions (kernel 3, padding
1, the second of stride 2), sinusoidal positions from the segment's first
frame. The tower's pre-LN blocks (exact GELU) attend block-causally: a
frame sees every frame up to the end of its own block. ``downsample``
frames make one audio token through one linear projection. The text tower
(Llama: RMSNorm, per-head q/k RMSNorm where the weights have them, RoPE
with the half-split convention, grouped-query attention, SiLU-gated MLP)
reads ``[prompt | audio tokens | hypothesis start | hypothesis]`` in one
causal forward with no cache and no batching. Matmuls run in float32 with
TF32 off.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from .whisper_ref import log_mel, mel_filters, no_tf32, sinusoids

SAMPLES_PER_FRAME = 320  # one encoder frame is 20 ms


@dataclass(frozen=True)
class Dims:
    n_mels: int
    d_audio: int
    audio_heads: int
    audio_layers: int
    downsample: int
    block_frames: int
    max_frames: int
    hidden: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    rope_theta: float
    rms_eps: float

    @property
    def block_samples(self) -> int:
        return self.block_frames * SAMPLES_PER_FRAME


def dims(cfg: dict) -> Dims:
    a, t = cfg["audio_config"], cfg["text_config"]
    return Dims(n_mels=a["num_mel_bins"], d_audio=a["d_model"], audio_heads=a["encoder_attention_heads"],
                audio_layers=a["encoder_layers"], downsample=a["downsample"], block_frames=a["block_frames"],
                max_frames=a["max_frames"], hidden=t["hidden_size"], layers=t["num_hidden_layers"],
                heads=t["num_attention_heads"], kv_heads=t["num_key_value_heads"], head_dim=t["head_dim"],
                rope_theta=float(t["rope_theta"]), rms_eps=float(t["rms_norm_eps"]))


class CausalLM:
    def __init__(self, sd: Dict[str, torch.Tensor], dims: Dims, device):
        no_tf32()
        self.w = {k: v.to(device=device, dtype=torch.float32) for k, v in sd.items()}
        self.d = dims
        self.device = torch.device(device)
        self.filters = torch.from_numpy(mel_filters(dims.n_mels)).to(device)
        self.pos = sinusoids(dims.max_frames, dims.d_audio).to(device)
        self.head = self.w.get("lm_head.weight", self.w["model.embed_tokens.weight"])

    # -- the audio tower --------------------------------------------------

    def _lin(self, x, prefix: str):
        return F.linear(x, self.w[prefix + ".weight"], self.w.get(prefix + ".bias"))

    def _ln(self, x, prefix: str):
        return F.layer_norm(x, x.shape[-1:], self.w[prefix + ".weight"], self.w[prefix + ".bias"], 1e-5)

    def audio_tokens(self, blocks: torch.Tensor) -> torch.Tensor:
        """[n, block_samples] audio of one segment -> [n * block_frames /
        downsample, hidden] audio-token embeddings."""
        d = self.d
        n, fr, D = blocks.shape[0], d.block_frames, d.d_audio
        if n * fr > d.max_frames:
            raise ValueError(f"{n} blocks exceed the tower's {d.max_frames} frames")
        mel = torch.stack([log_mel(b, self.filters) for b in blocks])       # [n, mels, 2 fr]
        x = F.gelu(F.conv1d(mel, self.w["audio_tower.conv1.weight"], self.w["audio_tower.conv1.bias"], padding=1))
        x = F.gelu(F.conv1d(x, self.w["audio_tower.conv2.weight"], self.w["audio_tower.conv2.bias"],
                            stride=2, padding=1))                          # [n, D, fr]
        x = x.transpose(1, 2).reshape(n * fr, D) + self.pos[: n * fr]
        block = torch.arange(n * fr, device=self.device) // fr
        mask = torch.zeros(n * fr, n * fr, device=self.device).masked_fill(
            block[None, :] > block[:, None], float("-inf"))
        H = d.audio_heads
        dh = D // H
        for i in range(d.audio_layers):
            p = f"audio_tower.layers.{i}"
            h = self._ln(x, f"{p}.self_attn_layer_norm")
            q, k, v = (self._lin(h, f"{p}.self_attn.{m}_proj").view(-1, H, dh).transpose(0, 1)
                       for m in ("q", "k", "v"))
            att = torch.softmax(q @ k.transpose(1, 2) * dh ** -0.5 + mask, dim=-1) @ v
            x = x + self._lin(att.transpose(0, 1).reshape(-1, D), f"{p}.self_attn.out_proj")
            h = self._ln(x, f"{p}.final_layer_norm")
            x = x + self._lin(F.gelu(self._lin(h, f"{p}.fc1")), f"{p}.fc2")
        x = self._ln(x, "audio_tower.layer_norm")
        return self._lin(x.reshape(-1, d.downsample * D), "multi_modal_projector.linear")

    # -- the text tower -----------------------------------------------------

    def _rms(self, x, w):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.d.rms_eps) * w

    def _rope(self, x, pos):
        """x [S, H, Dh] at positions [S], the half-split convention."""
        dh = x.shape[-1]
        inv = 1.0 / (self.d.rope_theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh))
        ang = pos.float()[:, None] * inv[None, :]
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

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
            q = self._lin(h, f"{p}.self_attn.q_proj").view(S, H, dh)
            k = self._lin(h, f"{p}.self_attn.k_proj").view(S, KV, dh)
            v = self._lin(h, f"{p}.self_attn.v_proj").view(S, KV, dh)
            if f"{p}.self_attn.q_norm.weight" in self.w:
                q = self._rms(q, self.w[f"{p}.self_attn.q_norm.weight"])
                k = self._rms(k, self.w[f"{p}.self_attn.k_norm.weight"])
            q, k = self._rope(q, pos), self._rope(k, pos)
            rep = H // KV  # query head h reads key head h // rep
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
            att = torch.softmax(q.transpose(0, 1) @ k.permute(1, 2, 0) * dh ** -0.5 + mask, dim=-1)
            x = x + self._lin((att @ v.transpose(0, 1)).transpose(0, 1).reshape(S, H * dh), f"{p}.self_attn.o_proj")
            h = self._rms(x, self.w[f"{p}.post_attention_layernorm.weight"])
            gate = F.silu(self._lin(h, f"{p}.mlp.gate_proj"))
            x = x + self._lin(gate * self._lin(h, f"{p}.mlp.up_proj"), f"{p}.mlp.down_proj")
        return F.linear(self._rms(x, self.w["model.norm.weight"]), self.head)

    def embed(self, ids: Sequence[int]) -> torch.Tensor:
        return self.w["model.embed_tokens.weight"][torch.tensor(list(ids), dtype=torch.long, device=self.device)]

    @torch.no_grad()
    def gaps(self, blocks: torch.Tensor, prompt: List[int], hyp_start: List[int], served: List[int]) -> List[float]:
        """For each served token (the hypothesis, then the end token where
        the hypothesis stopped before its cap): the reference's best logit
        less the served token's, at the position that chose it."""
        if not served:
            return []
        audio = self.audio_tokens(blocks)
        embeds = torch.cat([self.embed(prompt), audio, self.embed(hyp_start + served[:-1])])
        first = len(prompt) + audio.shape[0] + len(hyp_start) - 1
        lg = self.text_logits(embeds)[first:]
        tok = torch.tensor(served, dtype=torch.long, device=self.device)
        return (lg.max(-1).values - lg.gather(1, tok[:, None])[:, 0]).tolist()
