"""Training step over the Whisper weights, with data and tensor parallelism
(port of whisperlivekit_tpu/parallel/train.py).

Teacher-forced next-token cross-entropy over the decoder, with optional
alignment supervision of the heads the serving gate reads, and AdamW with
optax's numbers. The consumer is the structured-weights trainer
(harness/train_structured.py). The step launches no hand-written kernel:
the encoder runs its differentiable attention (``encode(..., flash=False)``,
as in JAX, where the Pallas kernel has no VJP), and the decoder's training
cross-attention is the plain ``_attend``.

Differences from JAX, each forced by eager PyTorch: the module and the
optimizer are updated in place (``train_step`` returns the same objects with
the step count advanced), and ``make_sharded_train_step`` returns the step
itself rather than a function that jits it.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models.whisper import model as wm
from ..models.whisper.dims import ModelDimensions
from .mesh import shard_batch, shard_dims, shard_params

Schedule = Callable[[int], float]


# optax.adamw's defaults
B1, B2, EPS = 0.9, 0.999, 1e-8


class AdamW(NamedTuple):
    """``optax.adamw``'s numbers; ``init`` builds the torch optimizer.

    torch's AdamW is optax's update: decoupled weight decay on every
    parameter, bias-corrected moments, ``eps`` outside the square root.
    ``lr`` may be a schedule of the update count; as in optax it is read at
    the count before the update, so a warmup from 0 makes a first update
    of 0."""

    lr: Union[float, Schedule] = 1e-4
    weight_decay: float = 0.01

    def lr_at(self, count: int) -> float:
        return float(self.lr(count)) if callable(self.lr) else float(self.lr)

    def init(self, params: wm.Whisper) -> torch.optim.AdamW:
        """The optimizer over ``params``, whose gradients it switches on (the
        loaders return modules with ``requires_grad`` off)."""
        params.requires_grad_(True)
        return torch.optim.AdamW(
            params.parameters(), lr=self.lr_at(0), betas=(B1, B2), eps=EPS,
            weight_decay=self.weight_decay)


class TrainState(NamedTuple):
    params: wm.Whisper
    opt_state: torch.optim.AdamW
    step: int


def make_optimizer(lr: Union[float, Schedule] = 1e-4, weight_decay: float = 0.01) -> AdamW:
    return AdamW(lr, weight_decay)


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
    end_value: float = 0.0,
) -> Schedule:
    """``optax.warmup_cosine_decay_schedule`` (exponent 1): linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine to
    ``end_value`` at ``decay_steps`` (which counts the warmup), held after."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return init_value + (peak_value - init_value) * count / warmup_steps
        t = min(count - warmup_steps, cos_steps)
        decayed = (1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / cos_steps)) + alpha
        return peak_value * decayed

    return schedule


def _ce_parts(params, mel, tokens, dims, align=None):
    """(summed target NLL, target count, align probs [K,B,S,T] or None)."""
    # flash=False: the kernel has no backward; the plain attention does
    enc = wm.encode(params, mel, dims, flash=False)
    xkv = wm.cross_kv(params, enc, dims)
    B = tokens.shape[0]
    cache = wm.init_cache(dims, B, dtype=params.dtype, device=tokens.device)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits, aprob, _ = wm.decode(
        params, inputs, torch.zeros((B,), dtype=torch.long, device=tokens.device), xkv, cache, dims,
        align=align,
    )
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long().clamp(min=0)[..., None])[..., 0]
    mask = (targets >= 0).float()
    return (nll * mask).sum(), mask.sum(), aprob


def loss_fn(params: wm.Whisper, mel, tokens, dims: ModelDimensions, align=None,
            align_lo=None, align_hi=None, align_weight: float = 1.0) -> torch.Tensor:
    """Teacher-forced next-token cross-entropy over the decoder; targets
    below 0 are masked.

    Optional alignment supervision (``align``: an ``AlignSpec`` of the heads
    the serving gate reads, with per-row frame windows ``align_lo`` /
    ``align_hi`` [S], -1 = unsupervised, shared across the batch) adds
    ``-log(clip(mass, 1e-6, 1))`` of each head's attention mass inside the
    row's window, averaged over the supervised rows x heads x batch and
    weighted by ``align_weight``."""
    nll_sum, count, aprob = _ce_parts(params, mel, tokens, dims, align)
    ce = nll_sum / torch.clamp(count, min=1.0)
    if align is None:
        return ce
    if align_lo is None or align_hi is None:
        raise ValueError(
            "align supervision requires align_lo/align_hi frame windows "
            "([S] int, shared across the batch: every row carries the same "
            "alignment schedule, as the synthetic aligned data does)"
        )
    T_enc = aprob.shape[-1]
    lo = torch.as_tensor(align_lo, device=aprob.device).long()
    hi = torch.as_tensor(align_hi, device=aprob.device).long()
    t_idx = torch.arange(T_enc, device=aprob.device)[None, :]
    win = ((t_idx >= lo[:, None]) & (t_idx < hi[:, None])).float()[None, None]  # [1,1,S,T]
    mass = (aprob * win).sum(-1)                                               # [K,B,S]
    sup = (lo >= 0).float()[None, None, :]
    a_nll = -torch.log(torch.clamp(mass, 1e-6, 1.0))
    a_loss = (a_nll * sup).sum() / torch.clamp(sup.sum() * aprob.shape[0] * aprob.shape[1], min=1.0)
    return ce + align_weight * a_loss


def _set_lr(state: TrainState, tx: AdamW) -> None:
    lr = tx.lr_at(state.step)
    for group in state.opt_state.param_groups:
        group["lr"] = lr


def train_step(state: TrainState, mel, tokens, dims: ModelDimensions, tx: AdamW,
               align=None, align_lo=None, align_hi=None,
               align_weight: float = 1.0) -> tuple:
    """One AdamW update on ``loss_fn``; returns (state, loss). The weights,
    the moments and the parameters' ``.grad`` (this step's gradients) are
    updated in place."""
    _set_lr(state, tx)
    state.opt_state.zero_grad(set_to_none=True)
    loss = loss_fn(state.params, mel, tokens, dims, align, align_lo, align_hi, align_weight)
    loss.backward()
    state.opt_state.step()
    return state._replace(step=state.step + 1), loss.detach()


def make_sharded_train_step(mesh: DeviceMesh, dims: ModelDimensions, tx: AdamW):
    """The train step with data parallelism over 'data' and tensor
    parallelism over 'model' (the state from ``init_train_state`` on the same
    mesh). ``step(state, mel, tokens)`` takes the global batch, the same on
    every rank, and computes on its 'data' slice. Each slice divides its CE
    sum by the global target count, and the gradients are summed over
    'data': the update equals the unsharded step's, also when slices hold
    different numbers of targets."""
    data = mesh["data"].get_group()
    n_data = mesh["data"].size()
    local = shard_dims(dims, mesh["model"].size())

    def step(state: TrainState, mel, tokens) -> tuple:
        mel_l, tok_l = shard_batch(mel, mesh), shard_batch(tokens, mesh)
        _set_lr(state, tx)
        state.opt_state.zero_grad(set_to_none=True)
        nll_sum, count, _ = _ce_parts(state.params, mel_l, tok_l, local)
        total = count.detach().clone()
        if n_data > 1:
            dist.all_reduce(total, group=data)
        loss = nll_sum / torch.clamp(total, min=1.0)
        loss.backward()
        if n_data > 1:
            for p in state.params.parameters():
                if p.grad is not None:
                    dist.all_reduce(p.grad, group=data)
            loss = loss.detach().clone()
            dist.all_reduce(loss, group=data)
        state.opt_state.step()
        return state._replace(step=state.step + 1), loss.detach()

    return step


def init_train_state(dims: ModelDimensions, mesh: Optional[DeviceMesh], tx: AdamW,
                     generator: Optional[torch.Generator] = None, dtype=torch.float32,
                     device=None) -> TrainState:
    """Random weights (``init_params``; seed 0 by default), sharded over
    ``mesh`` when given (None: one device, no process group), and the
    optimizer over them. ``device`` None means the card."""
    from ..engine.core import default_device

    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    params = wm.init_params(dims, gen, dtype=dtype, device="cpu")
    if mesh is not None:
        params = shard_params(params, mesh)
    else:
        params = params.to(torch.device(device) if device is not None else default_device())
    return TrainState(params=params, opt_state=tx.init(params), step=0)
