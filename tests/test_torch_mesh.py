"""The port's device mesh and tensor/data-parallel train step
(whisperlivekit_tpu_torch/parallel/), twins of tests/test_tp_inference.py on
a 2-rank gloo group on the CPU, plus one data-parallel and one
tensor-parallel ``train_step`` against the unsharded step.

The weights are JAX's ``init_params`` at test_tp_inference.py's dims,
bridged; the two ranks run tests/torch_mesh_worker.py (spawned, joined
within 60 s, initialised through a file store in ``tmp_path``) and write
what they computed; the tests read it. Tolerances: test_tp_inference.py's
(encode 2e-4, decode 2e-3); the train steps as the JAX parity tests (loss
2e-5, weights atol 2e-5 + rtol 1e-4).
"""

import multiprocessing
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from whisperlivekit_tpu.models.whisper import model as JM
from whisperlivekit_tpu.models.whisper.dims import ModelDimensions as JDims

import torch_mesh_worker as W

WORLD = 2
JOIN_S = 60


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the two ranks once; their results, by rank."""
    out = tmp_path_factory.mktemp("mesh")
    tree = jax.tree.map(np.asarray, JM.init_params(JDims(**W.DIMS), jax.random.PRNGKey(0)))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=W.main, args=(r, WORLD, str(out / "store"), tree, str(out)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
    errs = "\n".join(f.read_text() for f in sorted(Path(out).glob("*.err")))
    assert not hung, f"ranks {hung} still running after {JOIN_S} s\n{errs}"
    assert all(p.exitcode == 0 for p in procs), f"exit codes {[p.exitcode for p in procs]}\n{errs}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def test_mesh_shape(ranks):
    for res in ranks:
        shape, names, size = res["mesh"]
        assert set(names) == {"data", "model"} and size == WORLD
        assert shape == (1, 2)  # the model axis takes the first of 8, 4, 2 that divides 2


def test_tp_encode_matches_single_device(ranks):
    for res in ranks:
        got, want = res["encode"]
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_tp_decode_matches_single_device(ranks):
    for res in ranks:
        got, want = res["decode"]
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_param_shard_layout(ranks):
    """Column/row-parallel placement on the port's [out, in] weights: q and
    fc1 shard the output dim (weight and bias), o and fc2 the input dim
    (bias replicated), layernorms and embeddings replicate."""
    res = ranks[0]
    shapes, specs = res["local_shapes"], res["specs"]
    blk = "decoder.blocks.0."
    assert shapes[blk + "attn.q.weight"] == (32, 64) and shapes[blk + "attn.q.bias"] == (32,)
    assert shapes[blk + "cross.k.weight"] == (32, 64)
    assert shapes[blk + "fc1.weight"] == (128, 64)
    assert shapes[blk + "attn.o.weight"] == (64, 32) and shapes[blk + "attn.o.bias"] == (64,)
    assert shapes[blk + "fc2.weight"] == (64, 128)
    assert shapes[blk + "attn_ln.scale"] == (64,) and shapes["decoder.tok_emb"] == (512, 64)
    assert specs[blk + "attn.q.weight"] == ("Replicate", "Shard0")
    assert specs[blk + "fc2.weight"] == ("Replicate", "Shard1")
    assert specs[blk + "fc2.bias"] == ("Replicate", "Replicate")
    assert specs["encoder.conv1.weight"] == ("Replicate", "Replicate")
    assert res["dims"] == (2, 2, 16)  # heads per rank; the head width stays


@pytest.mark.parametrize("kind", ["tp_step", "dp_step"])
def test_sharded_train_step_matches_unsharded(ranks, kind):
    for res in ranks:
        step = res[kind]
        assert step["steps"] == 1
        assert abs(step["loss"] - step["ref_loss"]) <= 2e-5
        assert step["weights"].keys() == step["ref_weights"].keys()
        for name, want in step["ref_weights"].items():
            np.testing.assert_allclose(step["weights"][name], want, atol=2e-5, rtol=1e-4, err_msg=name)
