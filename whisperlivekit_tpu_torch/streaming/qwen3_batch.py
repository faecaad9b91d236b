"""Session-level batching for causal backends (qwen3 / voxtral-realtime)
(port of whisperlivekit_tpu/streaming/qwen3_batch.py).

Tower KV and decoder KV live in device-resident lane pools; sessions issue
typed ops (prime / append / decode) through an OpBatcher, so concurrent
sessions' blocks encode in ONE device call and their hypotheses decode in
another — the causal-mode analog of the AlignAtt batch scheduler.

Lane heterogeneity (per-lane frames_filled / text_pos) is native to the
compute functions (models/qwen3_asr.py takes [B] position vectors). The
pools are written IN PLACE (JAX donates them): an append reads and writes
its lanes' rows of both pools one layer at a time (the compute functions'
``lanes``), so no copy of the batch's rows of a whole pool is made (at
Uni-MoE-2.0-Omni's 64 lanes the tower pool alone is 11.7 GB); a decode
runs on a copy of its lanes' text-pool rows only, since the hypothesis
region is disposable (overwritten by the next block) — pool rows stay
untouched. On a CUDA device that copy goes into the service's static decode
cache (``DecodeGraphs``), whose greedy step is one CUDA graph a padded
batch, replayed for every step after that batch's first; elsewhere into a
fresh gathered copy, each step eager.

Spans (``engine/trace.py``): ``causal.prime``, ``causal.append`` and
``causal.decode``, one per pooled op, ``lanes`` its sessions' rows (prime
and append only enqueue: their device time lands in the next read, the
decode's); counters ``causal.append_rows`` (rows an append ran, padding
included) and ``causal.logits_rows``; ``causal.graph_captures`` and
``causal.graph_replays`` (``DecodeGraphs``). A model with expert layers has its
routing counts (``llama.moe_counts``) copied with the decode's read of its
tokens and added as ``moe.pairs``, ``moe.null`` and ``moe.hit``.

Duplicate scatter indices never reach a live lane: a batch's padding rows
and the ops of closed sessions all address the scratch row 0 (which no
session is given), while the live lanes of one batch are distinct (each
session's ops run one at a time, and a lane belongs to one session). Which
duplicate write wins on the scratch row is unspecified, as in XLA, and
nothing reads it for a live lane.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..audio.mel import log_mel_spectrogram
from ..engine.op_batcher import OpBatcher
from ..engine.trace import TRACER
from ..models import llama as lm
from ..models import qwen3_asr as qm

logger = logging.getLogger(__name__)


class LaneToken:
    """A session's claim on a pool lane. ``alive`` flips False at close();
    any of the session's ops still queued in the batcher then execute
    against the scratch row instead of a possibly re-acquired lane."""

    __slots__ = ("lane", "alive")

    def __init__(self, lane: int):
        self.lane = lane
        self.alive = True


class CausalPools:
    """Per-lane tower + decoder KV pools on ``device``. Row 0 is scratch
    (batch padding).

    Tower rows are sized to the segment policy's admitted window
    (window_blocks x block_frames), not the 30 s architectural max — at 15 s
    windows that halves the largest allocation in the engine."""

    SCRATCH = 0

    def __init__(self, dims: qm.Qwen3ASRDims, capacity: int, text_cache_len: int,
                 dtype=torch.float32, tower_frames: int = 0, device="cpu"):
        L, H = dims.audio_layers, dims.audio_heads
        dh = dims.d_audio // H
        C = capacity + 1
        frames = min(tower_frames or dims.max_frames, dims.max_frames)
        kw = dict(dtype=dtype, device=device)
        self.tower_k = torch.zeros((L, C, frames, H, dh), **kw)
        self.tower_v = torch.zeros((L, C, frames, H, dh), **kw)
        t = dims.text
        shape = (t.n_layers, C, text_cache_len, t.n_kv_heads, t.head_dim)
        self.text_k = torch.zeros(shape, **kw)
        self.text_v = torch.zeros(shape, **kw)
        self._free = list(range(1, C))

    def acquire(self) -> Optional[int]:
        return self._free.pop() if self._free else None

    def release(self, lane: int) -> None:
        if lane != self.SCRATCH:
            self._free.append(lane)

    def lane_bytes(self) -> int:
        """Card bytes one lane holds across the four pools."""
        return sum(p[:, 0].numel() * p.element_size()
                   for p in (self.tower_k, self.tower_v, self.text_k, self.text_v))


# ---------------------------------------------------------------------------
# Pooled device calls
# ---------------------------------------------------------------------------


@torch.no_grad()
def _prime_pooled(model, pools: CausalPools, lanes: torch.Tensor, prompt: torch.Tensor,
                  dims: qm.Qwen3ASRDims) -> None:
    """Zero the lanes' decoder rows and prefill the prompt, in place."""
    B = lanes.shape[0]
    tk = pools.text_k
    cache = lm.LlamaCache(torch.zeros((tk.shape[0], B) + tk.shape[2:], dtype=tk.dtype, device=tk.device),
                          torch.zeros((tk.shape[0], B) + tk.shape[2:], dtype=tk.dtype, device=tk.device))
    lm.forward(model.text, lm.embed_tokens(model.text, prompt),
               torch.zeros(B, dtype=torch.long, device=lanes.device), cache, dims.text, last_only=True)
    pools.text_k[:, lanes] = cache.k
    pools.text_v[:, lanes] = cache.v


@torch.no_grad()
def _append_pooled(model, pools: CausalPools, lanes: torch.Tensor, audio: torch.Tensor,
                   start_frame: torch.Tensor, text_pos: torch.Tensor, dims: qm.Qwen3ASRDims) -> None:
    """One causal block per lane, encoded + fed to the decoder, in one call
    (the mel computed from the raw blocks, each lane with its own floor),
    reading and writing the pools in place. Padding rows and closed
    sessions' ops carry the scratch row as their lane."""
    mel = log_mel_spectrogram(audio, n_mels=dims.n_mels)
    qm.append_audio_block(model, mel, qm.TowerCache(pools.tower_k, pools.tower_v),
                          lm.LlamaCache(pools.text_k, pools.text_v), start_frame, text_pos, dims,
                          lanes=lanes)


class DecodeGraphs:
    """The pooled decode's static state: a decode cache of ``rows`` lanes
    (the service's largest padded batch) into which each decode op copies
    its lanes' text-pool rows in place, the step's token and position
    inputs, and on a CUDA device one CUDA graph of the greedy step (the
    token's embedding, ``llama.forward`` at S=1, the last row's logits) for
    each padded batch B (the cache length is the buffers').

    A batch of B lanes uses the leading B rows of every buffer. Its first
    step runs eagerly on them; the same step then runs once more on a side
    stream (the warm-up a capture needs: it rewrites the cache rows just
    written with the same values, and its counts are dropped: the host's
    diverted, the routing accumulator restored) and is captured there, on
    this thread alone (``thread_local``: other threads may enqueue copies
    meanwhile). Every later step of that B replays the graph: no shape of
    the step depends on the data (``llama.forward`` masks the whole cache,
    every routed expert runs on every row). A replay adds the host counts
    the captured forward made (``moe.calls``, ``moe.rows``) and
    ``causal.graph_replays``; each capture counts ``causal.graph_captures``.
    The graphs share one memory pool. Off CUDA nothing is captured and every
    step runs eagerly on the static buffers."""

    def __init__(self, pools: CausalPools, rows: int):
        tk = pools.text_k
        self.rows = rows
        self.k = torch.empty((tk.shape[0], rows) + tk.shape[2:], dtype=tk.dtype, device=tk.device)
        self.v = torch.empty_like(self.k)
        self.tok = torch.zeros((rows, 1), dtype=torch.long, device=tk.device)
        self.pos = torch.zeros(rows, dtype=torch.long, device=tk.device)
        self.graphs = {}  # B -> (graph, its logits [B, V], the host counts of a replay)
        self.pool = None
        self.stream = torch.cuda.Stream(device=tk.device) if tk.is_cuda else None

    def load(self, pools: CausalPools, lanes: torch.Tensor) -> lm.LlamaCache:
        """The lanes' text-pool rows copied into the leading rows, in place:
        the batch's decode cache (views)."""
        B = lanes.shape[0]
        k, v = self.k[:, :B], self.v[:, :B]
        torch.index_select(pools.text_k, 1, lanes, out=k)
        torch.index_select(pools.text_v, 1, lanes, out=v)
        return lm.LlamaCache(k, v)

    def runner(self, model, dims: qm.Qwen3ASRDims, B: int):
        """``decode_hypothesis``' ``step`` for the B lanes ``load`` filled."""
        text = model.text
        tok, pos = self.tok[:B], self.pos[:B]
        cache = lm.LlamaCache(self.k[:, :B], self.v[:, :B])

        def forward() -> torch.Tensor:
            logits, _ = lm.forward(text, lm.embed_tokens(text, tok), pos, cache, dims.text, last_only=True)
            return logits[:, -1]

        def step(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
            tok[:, 0].copy_(t)
            pos.copy_(p)
            entry = self.graphs.get(B)
            if entry is not None:
                graph, out, counts = entry
                graph.replay()
                for name, n in counts.items():
                    TRACER.count(name, n)
                return out
            out = forward()
            if self.stream is not None:
                self.graphs[B] = self._capture(text, forward)
            return out

        return step

    def _capture(self, text, forward):
        acc = text.moe_counts
        kept = None if acc is None else acc.clone()
        s = self.stream
        s.wait_stream(torch.cuda.current_stream())
        with TRACER.diverted(), torch.cuda.stream(s):
            forward()
        graph = torch.cuda.CUDAGraph()
        with TRACER.diverted() as counts:
            with torch.cuda.graph(graph, pool=self.pool, stream=s, capture_error_mode="thread_local"):
                out = forward()
        torch.cuda.current_stream().wait_stream(s)
        if kept is not None:
            acc.copy_(kept)
        self.pool = graph.pool()
        TRACER.count("causal.graph_captures")
        counts["causal.graph_replays"] = 1
        return graph, out, counts


@torch.no_grad()
def _decode_pooled(model, pools: CausalPools, lanes: torch.Tensor, start_tokens: torch.Tensor,
                   text_pos: torch.Tensor, dims: qm.Qwen3ASRDims, eos_id: int, max_new: int,
                   graphs: Optional[DecodeGraphs] = None):
    """Greedy hypotheses for B lanes from their pooled audio prefixes.
    The hypothesis KV lands in a COPY only — pool rows stay untouched
    (disposable-hypothesis contract): ``graphs``' static cache, whose step
    then runs each greedy step, or without it a fresh gathered copy."""
    if graphs is None:
        xc, step = lm.LlamaCache(pools.text_k[:, lanes], pools.text_v[:, lanes]), None
    else:
        xc, step = graphs.load(pools, lanes), graphs.runner(model, dims, lanes.shape[0])
    tokens, n, _ = qm.decode_hypothesis(model, xc, start_tokens, text_pos, eos_id, dims, max_new=max_new,
                                        step=step)
    return tokens, n


# ---------------------------------------------------------------------------
# The op service
# ---------------------------------------------------------------------------


class CausalBatchService:
    """Shared per-engine service: pools + batched op runners. Sessions call
    the async ops; the OpBatcher packs concurrent sessions per op type."""

    def __init__(self, holder, capacity: int = 32, window_s: float = 0.01):
        self.holder = holder
        self.dims = holder.dims
        self.device = holder.device
        blocks = self.dims.window_blocks(holder.window_s)
        self.pools = CausalPools(
            self.dims, capacity, holder.text_cache_len, holder.params.dtype,
            tower_frames=(blocks + 1) * self.dims.block_frames, device=self.device,
        )
        # the decode's static cache and step graphs, on a CUDA device; a
        # batch wider than it (closed sessions' ops beside every lane) takes
        # the gathered copy
        self.graphs = DecodeGraphs(self.pools, self._pad(capacity)) if self.pools.text_k.is_cuda else None
        self.batcher = OpBatcher(window_s=window_s)
        # the short ops first: a session's decode follows its append, so a
        # decode that waits for the pending appends (two at most a session,
        # keyed by its lane token) takes every ready session
        self.batcher.register("prime", self._run_prime, priority=1)
        self.batcher.register("append", self._run_append, priority=1)
        self.batcher.register("decode", self._run_decode)

    # -- async session-facing ops. Each payload carries the session's lane
    # TOKEN: a disconnect can leave ops queued after the worker task is
    # cancelled, and the lane may be re-acquired — dead ops must not touch it.

    async def prime(self, token: "LaneToken", ctx_ids: Optional[List[int]] = None) -> None:
        await self.batcher.submit("prime", (token, list(ctx_ids or [])), key=token)

    async def append(self, token: "LaneToken", block: np.ndarray,
                     start_frame: int, text_pos: int) -> None:
        await self.batcher.submit("append", (token, block, start_frame, text_pos), key=token)

    async def decode(self, token: "LaneToken", text_pos: int) -> List[int]:
        return await self.batcher.submit("decode", (token, text_pos))

    def stats(self) -> dict:
        return self.batcher.stats()

    def close(self) -> None:
        """Release the decode's static cache, its graphs and their pool."""
        self.graphs = None

    # -- batch runners (one device call each, in a worker thread) ----------------

    @staticmethod
    def _pad(n: int) -> int:
        return 1 << (n - 1).bit_length()

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _run_prime(self, items: List[Tuple["LaneToken", List[int]]]) -> List[None]:
        with TRACER.span("causal.prime", lanes=len(items)):
            return self._prime(items)

    def _run_append(self, items: List[Tuple]) -> List[None]:
        with TRACER.span("causal.append", lanes=len(items)):
            return self._append(items)

    def _run_decode(self, items: List[Tuple]) -> List[List[int]]:
        with TRACER.span("causal.decode", lanes=len(items)):
            return self._decode(items)

    def _prime(self, items: List[Tuple["LaneToken", List[int]]]) -> List[None]:
        tokens = [it[0] for it in items]
        lanes = [t.lane if t.alive else CausalPools.SCRATCH for t in tokens]
        B = self._pad(len(lanes))
        lane_arr = np.full(B, CausalPools.SCRATCH, np.int64)
        lane_arr[: len(lanes)] = lanes
        # per-lane carry context, right-padded to the holder's fixed budget:
        # padded positions sit at cache indices >= the lane's text_pos, are
        # masked by the position-causal mask (llama.py forward) and are
        # overwritten by the next audio block's sequential writes — so one
        # prime shape serves every carry length
        ctx_budget = getattr(self.holder, "ctx_budget", 0)
        prompt = np.tile(np.asarray(self.holder.prompt_ids, np.int64), (B, 1))
        if ctx_budget:
            ctx = np.zeros((B, ctx_budget), np.int64)
            for i, (_, ids) in enumerate(items):
                ids = list(ids)[:ctx_budget]
                ctx[i, : len(ids)] = ids
            prompt = np.concatenate([prompt, ctx], axis=1)
        _prime_pooled(self.holder.params, self.pools, self._tensor(lane_arr), self._tensor(prompt), self.dims)
        TRACER.count("causal.logits_rows", B)
        return [None] * len(lanes)

    def _append(self, items: List[Tuple]) -> List[None]:
        d = self.dims
        B = self._pad(len(items))
        lanes = np.full(B, CausalPools.SCRATCH, np.int64)
        audio = np.zeros((B, d.block_samples), np.float32)
        start = np.zeros(B, np.int64)
        tpos = np.zeros(B, np.int64)
        for i, (token, block, sf, tp) in enumerate(items):
            lanes[i] = token.lane if token.alive else CausalPools.SCRATCH
            start[i], tpos[i] = sf, tp
            audio[i] = block
        _append_pooled(
            self.holder.params, self.pools, self._tensor(lanes), self._tensor(audio),
            self._tensor(start), self._tensor(tpos), d,
        )
        TRACER.count("causal.append_rows", B)
        TRACER.count("causal.logits_rows", B)
        return [None] * len(items)

    def _decode(self, items: List[Tuple]) -> List[List[int]]:
        h = self.holder
        B = self._pad(len(items))
        lanes = np.full(B, CausalPools.SCRATCH, np.int64)
        tpos = np.zeros(B, np.int64)
        for i, (token, tp) in enumerate(items):
            lanes[i] = token.lane if token.alive else CausalPools.SCRATCH
            tpos[i] = tp
        start = np.tile(np.asarray(h.hyp_start_ids, np.int64), (B, 1))
        graphs = self.graphs if self.graphs is not None and B <= self.graphs.rows else None
        toks, n = _decode_pooled(
            h.params, self.pools, self._tensor(lanes), self._tensor(start), self._tensor(tpos),
            self.dims, h.eos_id, h.max_new, graphs=graphs,
        )
        toks, n = self._read(toks, n)
        return [
            [int(x) for x in toks[i][: int(n[i])]] for i in range(len(items))
        ]

    def _read(self, toks: torch.Tensor, n: torch.Tensor):
        """The decode's one host read: its tokens and lengths, and with
        expert layers the routing counts since the last read (then zeroed),
        added to the tracer's ``moe.pairs``, ``moe.null`` and ``moe.hit``."""
        text = self.holder.params.text
        if not self.dims.text.moe:
            return toks.cpu().numpy(), n.cpu().numpy()
        acc = lm.moe_counts(text, toks.device)
        B, S = toks.shape
        host = torch.cat([toks.reshape(-1), n, acc.reshape(-1)]).cpu().numpy()
        acc.zero_()
        took, hit = host[B * S + B:].reshape(2, -1)
        E = self.dims.text.n_routed_experts
        TRACER.count("moe.pairs", int(took[:E].sum()))
        TRACER.count("moe.null", int(took[E:].sum()))
        TRACER.count("moe.hit", int(hit[:E].sum()))
        return host[: B * S].reshape(B, S), host[B * S: B * S + B]
