"""One rank of the port's mesh tests (tests/test_torch_mesh.py): a process
of a 2-rank gloo group on the CPU, started with the spawn method. Imports
torch and the port only; what it computes goes to ``<out>/rank<r>.pt``, and
a failure's traceback to ``<out>/rank<r>.err``.

Per rank, on weights the test bridged from JAX's ``init_params``:

- the ('data', 'model') mesh over the group and the shard layout;
- encode, and encode + cross_kv + decode, on a (1, 2) mesh (tensor
  parallel) against the same rank's unsharded forward;
- one ``make_sharded_train_step`` on the (1, 2) mesh and one on a (2, 1)
  mesh (data parallel), each against ``train_step`` on the unsharded
  weights, with the sharded weights gathered back whole.
"""

from __future__ import annotations

import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from whisperlivekit_tpu_torch.models.whisper import model as TM
from whisperlivekit_tpu_torch.models.whisper.dims import ModelDimensions
from whisperlivekit_tpu_torch.parallel import mesh as PM
from whisperlivekit_tpu_torch.parallel import train as PT

DIMS = dict(n_mels=80, n_audio_ctx=64, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
            n_vocab=512, n_text_ctx=32, n_text_state=64, n_text_head=4, n_text_layer=2)
LR = 1e-3


def _full(model, mesh) -> dict:
    """Every parameter of a sharded module, gathered whole."""
    out = {}
    for name, p in model.named_parameters():
        placements = PM.spec_for_path(name)
        out[name] = DTensor.from_local(p.detach(), mesh, placements).full_tensor().numpy()
    return out


def _step_pair(tree, dims, mesh, mel, tok) -> dict:
    """One sharded train step and one unsharded, from the same weights."""
    tx = PT.make_optimizer(LR)
    ref = TM.params_from_jax_numpy(tree, dims)
    ref_state = PT.TrainState(ref, tx.init(ref), 0)
    ref_state, ref_loss = PT.train_step(ref_state, torch.from_numpy(mel), torch.from_numpy(tok), dims, tx)
    sharded = PM.shard_params(TM.params_from_jax_numpy(tree, dims), mesh)
    state = PT.TrainState(sharded, tx.init(sharded), 0)
    step = PT.make_sharded_train_step(mesh, dims, tx)
    state, loss = step(state, torch.from_numpy(mel), torch.from_numpy(tok))
    return dict(loss=float(loss), ref_loss=float(ref_loss), weights=_full(state.params, mesh),
                ref_weights={n: p.detach().numpy() for n, p in ref.named_parameters()}, steps=state.step)


def _run(tree) -> dict:
    torch.set_num_threads(1)
    dims = ModelDimensions(**DIMS)
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, 80, 128)).astype(np.float32)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 512, (2, 5)).astype(np.int64)
    res = {}

    mesh = PM.make_mesh(device_type="cpu")
    res["mesh"] = (tuple(mesh.shape), tuple(mesh.mesh_dim_names), mesh.size())
    model = TM.params_from_jax_numpy(tree, dims)
    sharded = PM.shard_params(model, mesh)
    res["local_shapes"] = {n: tuple(p.shape) for n, p in sharded.named_parameters()}
    res["specs"] = {n: tuple(type(pl).__name__ + str(getattr(pl, "dim", ""))
                             for pl in spec) for n, spec in PM.param_specs(model).items()}
    res["dims"] = (sharded.dims.n_audio_head, sharded.dims.n_text_head, sharded.dims.head_dim)
    with torch.no_grad():
        m = torch.from_numpy(mel)
        res["encode"] = (TM.encode(sharded, m, sharded.dims).numpy(), TM.encode(model, m, dims).numpy())

        def run(p, d):
            x = TM.cross_kv(p, TM.encode(p, m, d), d)
            c = TM.init_cache(d, 2)
            lg, _, _ = TM.decode(p, torch.from_numpy(tokens), torch.zeros(2, dtype=torch.long), x, c, d)
            return lg.numpy()

        res["decode"] = (run(sharded, sharded.dims), run(model, dims))

    # train steps: targets padded unevenly across rows, so the data slices
    # hold different numbers of targets
    rng = np.random.default_rng(2)
    mel4 = rng.standard_normal((4, 80, 128)).astype(np.float32)
    tok4 = rng.integers(0, 512, (4, 9)).astype(np.int32)
    tok4[0, 4:] = -1
    tok4[3, 7:] = -1
    res["tp_step"] = _step_pair(tree, dims, mesh, mel4, tok4)
    res["dp_step"] = _step_pair(tree, dims, PM.make_mesh(shape=(2, 1), device_type="cpu"), mel4, tok4)
    return res


def main(rank: int, world: int, init_file: str, tree, out: str) -> None:
    out = Path(out)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
        try:
            res = _run(tree)
        finally:
            dist.destroy_process_group()
        torch.save(res, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
