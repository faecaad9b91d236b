"""Random Whisper weights drawn from the run's seed, in OpenAI's layout.

Both sides get the same tensors: the program loads them through its
checkpoint converter, the reference reads them as they are. They are drawn
on the device by a ``torch.Generator`` in two large float32 calls (one for
the matrices, one for the vectors), then scaled and cast per tensor to the
serving dtype (``draw`` says how the seed enters). Scales follow the program's own random init where it has
one (linear weights N(0, 1/d_in), convolutions N(0, 1/(3 c_in)), token
embedding N(0, 0.02)); biases, layer-norm gains and offsets and the learned
decoder positions, which that init leaves at 0 or 1, get small draws
(0.02) here, so a step that dropped one would show. ``draw_shapes`` draws
any family's list of tensors the same way.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def whisper_shapes(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor; kind picks the scale."""
    d, m, v = cfg["d_model"], cfg["num_mel_bins"], cfg["vocab_size"]
    f_enc, f_dec = cfg["encoder_ffn_dim"], cfg["decoder_ffn_dim"]
    out = [
        ("encoder.conv1.weight", (d, m, 3), "conv"), ("encoder.conv1.bias", (d,), "small"),
        ("encoder.conv2.weight", (d, d, 3), "conv"), ("encoder.conv2.bias", (d,), "small"),
    ]

    def block(p: str, ffn: int, cross: bool) -> None:
        attns = [("attn", "attn_ln")] + ([("cross_attn", "cross_attn_ln")] if cross else [])
        for a, ln in attns:
            out.extend([(f"{p}.{ln}.weight", (d,), "gain"), (f"{p}.{ln}.bias", (d,), "small")])
            for proj in ("query", "key", "value", "out"):
                out.append((f"{p}.{a}.{proj}.weight", (d, d), "linear"))
                if proj != "key":  # Whisper's key projections have no bias
                    out.append((f"{p}.{a}.{proj}.bias", (d,), "small"))
        out.extend([
            (f"{p}.mlp_ln.weight", (d,), "gain"), (f"{p}.mlp_ln.bias", (d,), "small"),
            (f"{p}.mlp.0.weight", (ffn, d), "linear"), (f"{p}.mlp.0.bias", (ffn,), "small"),
            (f"{p}.mlp.2.weight", (d, ffn), "linear"), (f"{p}.mlp.2.bias", (d,), "small"),
        ])

    for i in range(cfg["encoder_layers"]):
        block(f"encoder.blocks.{i}", f_enc, False)
    out += [("encoder.ln_post.weight", (d,), "gain"), ("encoder.ln_post.bias", (d,), "small")]
    out += [("decoder.token_embedding.weight", (v, d), "embed"),
            ("decoder.positional_embedding", (cfg["max_target_positions"], d), "small")]
    for i in range(cfg["decoder_layers"]):
        block(f"decoder.blocks.{i}", f_dec, True)
    out += [("decoder.ln.weight", (d,), "gain"), ("decoder.ln.bias", (d,), "small")]
    return out


def _scale(kind: str, shape: tuple) -> float:
    if kind == "linear":
        return shape[1] ** -0.5
    if kind == "conv":
        return (3 * shape[1]) ** -0.5
    return 0.02  # embed, small, gain (around 1)


def _unit(sizes, big, seed: int, device):
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return {
        True: torch.randn(big, generator=gen, device=device, dtype=torch.float32),
        False: torch.randn(sum(sizes) - big, generator=gen, device=device, dtype=torch.float32),
    }


@torch.no_grad()
def draw(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The state dict for ``seed``: the same seed gives the same tensors.

    The configuration's ``weights`` fixes one random model
    (``base_seed``); ``seed`` perturbs every tensor of it by
    ``perturbation`` of its own scale. Independent draws of a random
    Whisper differ several-fold in how often the policy's output guard
    resets a session, and so in the work a window holds; a deployment
    serves one model, and a perturbed copy of one random model keeps that
    behaviour while every number still changes with the seed."""
    return draw_shapes(whisper_shapes(cfg), cfg.get("weights", {}), seed, device, dtype)


@torch.no_grad()
def draw_shapes(shapes: List[Tuple[str, tuple, str]], spec: dict, seed: int, device,
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The tensors ``shapes`` names (name, shape, kind), drawn as ``draw``
    says, with ``spec`` a configuration's ``weights``."""
    sizes = [int(torch.Size(s).numel()) for _, s, _ in shapes]
    big = sum(n for n, (_, _, k) in zip(sizes, shapes) if k in ("linear", "conv", "embed"))
    pools = _unit(sizes, big, spec.get("base_seed", seed), device)
    if "base_seed" in spec:
        noise = _unit(sizes, big, seed, device)
        for k in pools:
            pools[k].add_(noise[k], alpha=float(spec["perturbation"]))
        del noise
    at = {True: 0, False: 0}
    sd = {}
    for (name, shape, kind), n in zip(shapes, sizes):
        large = kind in ("linear", "conv", "embed")
        x = pools[large][at[large]: at[large] + n].view(shape) * _scale(kind, shape)
        at[large] += n
        if kind == "gain":
            x = x + 1.0
        sd[name] = x.to(dtype)
    del pools
    return sd
