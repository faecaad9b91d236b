"""Device mesh and tensor-parallel sharding of the Whisper weights (port of
whisperlivekit_tpu/parallel/mesh.py).

The mesh is a ``torch.distributed`` ``DeviceMesh`` with ('data', 'model')
axes, one rank per device, made after ``init_process_group``. The layout is
JAX's Megatron one, read through the port's ``[out, in]`` dense weights:
q/k/v/fc1 are column-parallel (weight and bias ``Shard(0)``: each rank holds
a block of output features, so a block of heads), o/fc2 row-parallel (weight
``Shard(1)``, bias replicated), everything else replicated. Placements are
DTensor placements over the whole mesh, replicated along 'data'.

The forward passes (models/whisper/model.py) are plain functions over module
weights, so ``parallelize_module``'s hooks would never fire, and the decoder
writes its KV cache in place with plain index tensors, which DTensor refuses
to mix. So ``shard_params`` gives each rank a ``Whisper`` module of its own
shards (sliced by ``distribute_tensor``), and each sharded ``Dense`` carries
a ``TPRole`` whose collectives ``dense`` runs: a column-parallel input enters
through an identity whose backward all-reduces the input gradient, a
row-parallel product leaves through an all-reduce over 'model' before its
bias (one per attention and one per MLP, as XLA inserts). Run the forward
functions with the shard's ``dims`` (``sharded.dims``: heads and widths per
rank), on the whole batch or on this rank's 'data' slice (``shard_batch``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Placement, Replicate, Shard, distribute_tensor

from ..models.whisper import model as wm

AXES = ("data", "model")
COLUMN = ("q", "k", "v", "fc1")  # shard the output features
ROW = ("o", "fc2")               # shard the input features


def make_mesh(
    n_devices: Optional[int] = None,
    shape: Optional[Tuple[int, int]] = None,
    device_type: Optional[str] = None,
) -> DeviceMesh:
    """Mesh with ('data', 'model') axes over the process group's ranks.

    Without ``shape`` the model axis is the first of 8, 4, 2 that divides
    ``n_devices`` (the world size by default), as in JAX. ``device_type``
    None means the card ("cuda"); the CPU tests pass "cpu" (gloo)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh spans the whole process group: {n} devices asked, world size {world}")
    if shape is None:
        model = next((c for c in (8, 4, 2) if n % c == 0), 1)
        shape = (n // model, model)
    return init_device_mesh(device_type or "cuda", tuple(shape), mesh_dim_names=AXES)


def spec_for_path(path: str) -> Tuple[Placement, Placement]:
    """Placements over ('data', 'model') for one parameter, by its module
    path (``decoder.blocks.0.attn.q.weight``)."""
    parts = path.split(".")
    leaf = parts[-1]
    proj = parts[-2] if len(parts) >= 2 else ""
    if proj in COLUMN:
        return (Replicate(), Shard(0))
    if proj in ROW and leaf == "weight":
        return (Replicate(), Shard(1))
    # layernorms, convs, embeddings, row-parallel biases: replicated
    return (Replicate(), Replicate())


def param_specs(params: nn.Module) -> Dict[str, Tuple[Placement, Placement]]:
    """Placements per parameter name of ``params``."""
    return {name: spec_for_path(name) for name, _ in params.named_parameters()}


def batch_spec() -> Tuple[Placement, Placement]:
    """A batch's placements: dim 0 split over 'data', replicated over 'model'."""
    return (Shard(0), Replicate())


def shard_batch(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's 'data' slice of a global batch (``batch_spec``)."""
    return distribute_tensor(x.to(_mesh_device(mesh)), mesh, batch_spec()).to_local()


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the input gradient over 'model'
    (each rank's column shard saw the whole input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Sums the row shards' partial products over 'model'; identity backward."""

    @staticmethod
    def forward(ctx, y, group):
        y = y.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class TPRole(NamedTuple):
    """A sharded ``Dense``'s collectives: ``dense`` passes its input through
    ``enter`` and its f32 product, before the bias, through ``leave``."""

    enter: Callable[[torch.Tensor], torch.Tensor]
    leave: Callable[[torch.Tensor], torch.Tensor]


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_dims(dims, n_model: int):
    """The dimensions one of ``n_model`` tensor-parallel shards computes
    with: heads, and the widths they span, divided by the model axis."""
    for heads, width in ((dims.n_audio_head, dims.n_audio_state), (dims.n_text_head, dims.n_text_state)):
        if heads % n_model or width % n_model:
            raise ValueError(f"{heads} heads of width {width} do not split over {n_model} model ranks")
    return dataclasses.replace(
        dims, n_audio_state=dims.n_audio_state // n_model, n_audio_head=dims.n_audio_head // n_model,
        n_text_state=dims.n_text_state // n_model, n_text_head=dims.n_text_head // n_model)


def shard_params(params: wm.Whisper, mesh: DeviceMesh) -> wm.Whisper:
    """This rank's shards of ``params`` (the same weights on every rank), as
    a ``Whisper`` module on the mesh's device whose ``dims`` are the shard's
    (``shard_dims``) and whose sharded ``Dense`` modules carry their
    ``TPRole``. ``requires_grad`` is kept per parameter."""
    n_model = mesh["model"].size()
    group = mesh["model"].get_group()
    column = TPRole(lambda x: _CopyToModel.apply(x, group), _identity)
    row = TPRole(_identity, lambda y: _ReduceFromModel.apply(y, group))
    out = copy.deepcopy(params).to(_mesh_device(mesh))
    with torch.no_grad():
        for name, p in list(out.named_parameters()):
            placements = spec_for_path(name)
            if all(isinstance(pl, Replicate) for pl in placements):
                continue
            local = distribute_tensor(p.detach(), mesh, placements).to_local().contiguous()
            owner = out.get_submodule(name.rsplit(".", 1)[0])
            setattr(owner, name.rsplit(".", 1)[1], nn.Parameter(local, requires_grad=p.requires_grad))
    if n_model > 1:
        for name, mod in out.named_modules():
            if isinstance(mod, wm.Dense):
                proj = name.rsplit(".", 1)[-1]
                mod.tp = column if proj in COLUMN else row if proj in ROW else None
    out.dims = shard_dims(params.dims, n_model)
    return out
