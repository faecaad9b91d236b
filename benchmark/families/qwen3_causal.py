"""The port's causal audio-LLM path: ``Qwen3CausalASR`` with its
``CausalBatchService`` and one ``Qwen3CausalProcessor`` a session, as
``engine/core.py`` builds them for ``--backend qwen3`` with the scheduler
on, here from random weights in the HF layout that the port's checkpoint
converter reads (``models/qwen3_asr.convert_hf_state_dict``).

A session's every op (prime, append, decode) goes to the shared service
through a tap that forwards it unchanged and records what a replay needs
without the program: the ids a segment was primed with, the sample span of
its blocks (the last partial block zero-padded) and each hypothesis
decoded. Each ``process_iter_async`` or ``finish_async`` call that decoded
is one ``CausalTick``: ``t_prep`` at the call, ``t_done`` at its return,
``new_tokens`` the last hypothesis. ``reference/causal_ref.py`` scores
every hypothesis decoded by a tick that returned in the window.

The configuration holds HF-style ``audio_config`` and ``text_config``
(with ``qk_norm``, which HF's config has no field for, and the tower's
``downsample``, ``block_frames`` and ``max_frames``), the ids the port's
holder takes (``serving.prompt_ids``, ``serving.hyp_start_ids``,
``eos_token_id``) and its policy knobs (``serving.window_s``,
``max_new``, ``hold_back_words``); ``serving.capacity`` sizes the lane
pool and ``serving.max_lanes`` is the sessions a closed loop's group holds.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from lib.judge import pick, verdict
from lib.system import TickRecord
from lib.weights import draw_shapes
from reference import causal_ref as R


@dataclass
class Decode:
    carry: List[int]  # ids primed after the prompt (the carried context)
    first: int        # the segment's first sample in the session's stream
    blocks: int       # blocks the segment held
    real: int         # of its samples, those fed (the rest zero-padded)
    hyp: List[int]    # the hypothesis decoded, up to its end token


@dataclass
class CausalTick(TickRecord):
    decodes: List[Decode] = field(default_factory=list)


def assets(cache_dir) -> None:
    """Nothing on disk: the holder's debug tokenizer maps ids to words."""
    return None


def shapes(cfg: dict) -> list:
    """(name, shape, kind) of every tensor, in the HF layout."""
    a, t = cfg["audio_config"], cfg["text_config"]
    d, m, ff = a["d_model"], a["num_mel_bins"], a["encoder_ffn_dim"]
    out = [("audio_tower.conv1.weight", (d, m, 3), "conv"), ("audio_tower.conv1.bias", (d,), "small"),
           ("audio_tower.conv2.weight", (d, d, 3), "conv"), ("audio_tower.conv2.bias", (d,), "small")]

    def norm(p: str, n: int, bias: bool = True) -> None:
        out.append((f"{p}.weight", (n,), "gain"))
        if bias:
            out.append((f"{p}.bias", (n,), "small"))

    def lin(p: str, n_out: int, n_in: int, bias: bool) -> None:
        out.append((f"{p}.weight", (n_out, n_in), "linear"))
        if bias:
            out.append((f"{p}.bias", (n_out,), "small"))

    for i in range(a["encoder_layers"]):
        p = f"audio_tower.layers.{i}"
        norm(f"{p}.self_attn_layer_norm", d)
        for proj in ("q", "k", "v", "out"):
            lin(f"{p}.self_attn.{proj}_proj", d, d, proj != "k")  # the key projection has no bias
        norm(f"{p}.final_layer_norm", d)
        lin(f"{p}.fc1", ff, d, True)
        lin(f"{p}.fc2", d, ff, True)
    norm("audio_tower.layer_norm", d)
    D, v, i_ff = t["hidden_size"], t["vocab_size"], t["intermediate_size"]
    H, KV, dh = t["num_attention_heads"], t["num_key_value_heads"], t["head_dim"]
    lin("multi_modal_projector.linear", D, a["downsample"] * d, False)
    out.append(("model.embed_tokens.weight", (v, D), "embed"))
    for i in range(t["num_hidden_layers"]):
        p = f"model.layers.{i}"
        norm(f"{p}.input_layernorm", D, False)
        for proj, n_out in (("q", H * dh), ("k", KV * dh), ("v", KV * dh)):
            lin(f"{p}.self_attn.{proj}_proj", n_out, D, False)
        lin(f"{p}.self_attn.o_proj", D, H * dh, False)
        if t["qk_norm"]:
            norm(f"{p}.self_attn.q_norm", dh, False)
            norm(f"{p}.self_attn.k_norm", dh, False)
        norm(f"{p}.post_attention_layernorm", D, False)
        lin(f"{p}.mlp.gate_proj", i_ff, D, False)
        lin(f"{p}.mlp.up_proj", i_ff, D, False)
        lin(f"{p}.mlp.down_proj", D, i_ff, False)
    norm("model.norm", D, False)
    if not t["tie_word_embeddings"]:
        lin("lm_head", v, D, False)
    return out


def draw(cfg: dict, seed: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The state dict for ``seed``, drawn as ``lib/weights.draw`` draws
    Whisper's (one random model fixed by ``weights.base_seed``, perturbed
    from ``seed``)."""
    return draw_shapes(shapes(cfg), cfg.get("weights", {}), seed, device, dtype)


def port_dims(cfg: dict):
    from whisperlivekit_tpu_torch.models import llama as lm
    from whisperlivekit_tpu_torch.models import qwen3_asr as qm

    a, t = cfg["audio_config"], cfg["text_config"]
    text = dataclasses.replace(lm.dims_from_hf_config(t), qk_norm=bool(t["qk_norm"]))
    return qm.Qwen3ASRDims(text=text, n_mels=a["num_mel_bins"], d_audio=a["d_model"],
                           audio_heads=a["encoder_attention_heads"], audio_layers=a["encoder_layers"],
                           audio_ff=a["encoder_ffn_dim"], downsample=a["downsample"],
                           block_frames=a["block_frames"], max_frames=a["max_frames"])


class _Ops:
    """The sessions' failed ops, counted from the window's start (a failed
    op also raises in its session's call)."""

    def __init__(self):
        self.failed = 0

    def reset_stats(self) -> None:
        self.failed = 0

    def stats(self) -> dict:
        return {"n_failed_ticks": self.failed}


class _Tap:
    """One session's view of the service: every op goes through unchanged;
    each decode is recorded into the tick in flight."""

    def __init__(self, service, ops: _Ops, fed: Callable[[], int]):
        self.service = service
        self.pools = service.pools
        self.ops = ops
        self.fed = fed
        self.bs = service.dims.block_samples
        self.blocks = 0          # blocks appended in the session
        self.first = 0           # the segment's first block
        self.carry: List[int] = []
        self.tick: Optional[CausalTick] = None

    async def _call(self, op, *args):
        try:
            return await op(*args)
        except Exception:
            self.ops.failed += 1
            raise

    async def prime(self, token, ctx_ids=None) -> None:
        await self._call(self.service.prime, token, ctx_ids)
        self.carry = list(ctx_ids or [])
        self.first = self.blocks

    async def append(self, token, block, start_frame: int, text_pos: int) -> None:
        await self._call(self.service.append, token, block, start_frame, text_pos)
        self.blocks += 1

    async def decode(self, token, text_pos: int) -> List[int]:
        ids = await self._call(self.service.decode, token, text_pos)
        lo = self.first * self.bs
        self.tick.decodes.append(Decode(carry=list(self.carry), first=lo, blocks=self.blocks - self.first,
                                        real=min(self.fed(), self.blocks * self.bs) - lo, hyp=list(ids)))
        return ids


class Recorder:
    def __init__(self, ops: _Ops):
        self.ops = ops
        self.records: List[CausalTick] = []
        self._last_fed: Dict[int, int] = {}

    def attach(self, proc, sid: int, fed: Callable[[], int], due: Callable[[int], Optional[float]] = None):
        tap = _Tap(proc.service, self.ops, fed)
        proc.service = tap
        for name in ("process_iter_async", "finish_async"):
            setattr(proc, name, self._timed(getattr(proc, name), tap, sid, fed, due))

    def _timed(self, call, tap: _Tap, sid: int, fed, due):
        async def timed(*args, **kw):
            n = fed()
            rec = CausalTick(sid=sid, t_prep=time.perf_counter(), fed=n, advanced=n - self._last_fed.get(sid, 0),
                             due=due(n) if due else None, mode="causal")
            tap.tick = rec
            out = await call(*args, **kw)
            rec.t_done = time.perf_counter()
            if rec.decodes:
                self._last_fed[sid] = n
                rec.new_tokens = list(rec.decodes[-1].hyp)
                self.records.append(rec)
            return out

        return timed


class System:
    """The port's causal holder and op service for one configuration."""

    def __init__(self, cfg: dict, state_dict, device, control: Optional[str] = None):
        if control is not None:
            raise ValueError(f"the causal family has no control {control!r}")
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
        self.recorder = Recorder(self.scheduler)
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


def context(system, cfg: dict) -> dict:
    """``max_steps``: a hypothesis's cap; ``tail_frames``: the frames one
    append encodes."""
    return {"max_steps": int(cfg["serving"]["max_new"]), "eot": int(cfg["eos_token_id"]),
            "tail_frames": int(cfg["audio_config"]["block_frames"])}


def _served(d: Decode, max_new: int, eos: int) -> List[int]:
    """The tokens a decode chose: its hypothesis, then the end token where
    it stopped before the cap."""
    return d.hyp + ([eos] if len(d.hyp) < max_new else [])


def judge(records: List[CausalTick], w0: float, w1: float, seed: int, cfg: dict, state_dict, audio_of,
          tail_frames: int, assets, device, tokens: int = 400, max_sessions: int = 8) -> dict:
    """Scores every token that a decode of a tick returned in the window
    chose, for a sample of sessions (``lib.judge.pick``); each decode is one
    forward of the reference over its segment. ``tail_frames`` and
    ``assets`` are not needed here."""
    serving = cfg["serving"]
    max_new, eos = int(serving["max_new"]), int(cfg["eos_token_id"])
    window = [r for r in records if w0 <= r.t_done <= w1]
    scored: Dict[int, int] = {}
    for r in window:
        scored[r.sid] = scored.get(r.sid, 0) + sum(len(_served(d, max_new, eos)) for d in r.decodes)
    chosen = pick(scored, seed, tokens, max_sessions)
    model = R.CausalLM(state_dict, R.dims(cfg), device)
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
                                   _served(d, max_new, eos))
            replayed += 1
    return verdict(gaps, chosen, replayed)
