"""Port parity: parallel/train.py and harness/train_structured.py of
whisperlivekit_tpu_torch against the JAX train step and
scripts/train_structured_weights.py, on weights bridged from JAX's
``init_params`` and the same numpy inputs.

Tolerances: loss within 2e-5, every gradient and every weight after three
AdamW steps within atol 2e-5 + rtol 1e-4 of JAX's (f32 on the CPU; the
two sides differ only in summation order). The loss and gradient checks run
at the tensor-parallel tests' dims (64 wide, 2+2 layers, vocab 512); the
trainer's own checks keep the width and depth but take Whisper's vocabulary
and 30 s context, which its tokens and mels need.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from whisperlivekit_tpu.models.whisper import model as JM
from whisperlivekit_tpu.models.whisper.dims import ModelDimensions as JDims
from whisperlivekit_tpu.models.whisper.dims import default_alignment_heads
from whisperlivekit_tpu.parallel import train as JT
from whisperlivekit_tpu_torch.harness import train_structured as TS
from whisperlivekit_tpu_torch.harness.vocab import write_standin_vocab
from whisperlivekit_tpu_torch.models.whisper import model as TM
from whisperlivekit_tpu_torch.models.whisper.dims import ModelDimensions
from whisperlivekit_tpu_torch.models.whisper.tokenizer import get_tokenizer
from whisperlivekit_tpu_torch.parallel import train as TT

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

LOSS_TOL = 2e-5
ATOL, RTOL = 2e-5, 1e-4
SMALL = dict(n_mels=80, n_audio_ctx=64, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
             n_vocab=512, n_text_ctx=32, n_text_state=64, n_text_head=4, n_text_layer=2)
WIDE = dict(SMALL, n_audio_ctx=1500, n_vocab=51865, n_text_ctx=448)
SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "train_structured_weights.py"


def _dims(kw):
    return JDims(**kw), ModelDimensions(**kw)


# the JAX side jitted (dims and the optimizer static), as the script runs it
_jax_value_and_grad = jax.jit(jax.value_and_grad(JT.loss_fn), static_argnums=(3,))
_jax_train_step = jax.jit(JT.train_step, static_argnums=(3, 4))


def _jax_params(jd, seed=0):
    """JAX ``init_params`` with every leaf nudged off its init (nonzero
    biases and position rows), as numpy and as JAX arrays."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, JM.init_params(jd, jax.random.PRNGKey(seed)))
    tree = jax.tree.map(lambda x: (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32), tree)
    return tree, jax.tree.map(jnp.asarray, tree)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_tree_close(got, want):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=ATOL, rtol=RTOL, err_msg=k)


def _batch(seed, B=2, S=12, n_frames=128, vocab=512):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((B, 80, n_frames)).astype(np.float32)
    tok = rng.integers(0, vocab, (B, S)).astype(np.int32)
    tok[1, S - 3:] = -1  # padding: masked targets (and -1 inputs, as the trainer feeds)
    lo = np.full(S - 1, -1, np.int32)
    hi = np.full(S - 1, -1, np.int32)
    lo[3:8] = np.arange(5) * 10
    hi[3:8] = lo[3:8] + 8
    return mel, tok, lo, hi


def _align_args(jd, lo, hi, on, weight=0.7):
    if not on:
        return (None, None, None, 1.0), (None, None, None, 1.0)
    pairs = default_alignment_heads(jd)
    return ((JM.AlignSpec.from_pairs(pairs), jnp.asarray(lo), jnp.asarray(hi), weight),
            (TM.AlignSpec.from_pairs(pairs), torch.from_numpy(lo), torch.from_numpy(hi), weight))


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WLK_TPU_ASSET_DIR", str(write_standin_vocab(tmp_path_factory.mktemp("vocab")).parent))
        yield get_tokenizer(True, language="en", task="transcribe")


@pytest.fixture(scope="module")
def script():
    """scripts/train_structured_weights.py, imported as a module."""
    spec = importlib.util.spec_from_file_location("train_structured_weights", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# The weight bridge and encode's flash switch
# ---------------------------------------------------------------------------


def test_params_to_jax_numpy_inverts_the_bridge():
    jd, td = _dims(SMALL)
    tree, _ = _jax_params(jd)
    model = TM.params_from_jax_numpy(tree, td)
    back = TM.params_to_jax_numpy(model, td)
    g, w = _leaves(back), _leaves(tree)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    zero = TM.params_to_jax_numpy(model, td, grad=True)
    assert all(not v.any() for v in _leaves(zero).values())


def test_encode_flash_false_matches_default_and_true_needs_cuda():
    jd, td = _dims(SMALL)
    tree, _ = _jax_params(jd)
    model = TM.params_from_jax_numpy(tree, td)
    mel = torch.from_numpy(_batch(0)[0])
    np.testing.assert_array_equal(TM.encode(model, mel, td, flash=False).numpy(),
                                  TM.encode(model, mel, td).numpy())
    with pytest.raises(ValueError, match="needs CUDA"):
        TM.encode(model, mel, td, flash=True)


@pytest.mark.cuda
def test_flash_kernel_raises_under_grad_on_gpu():
    """K1 has no backward: with an input that requires grad it raises, and
    ``encode(flash=False)`` gives the encoder's q/k/v weights gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from whisperlivekit_tpu_torch.ops.flash_encoder import flash_encoder_attn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q = torch.randn(1, 4, 64, 64, device="cuda", requires_grad=True)
    k = torch.randn(1, 4, 64, 64, device="cuda")
    v = torch.randn(1, 4, 64, 64, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        flash_encoder_attn(q, k, v, t_valid=64)
    with torch.no_grad():
        flash_encoder_attn(q, k, v, t_valid=64)
    jd, td = _dims(dict(SMALL, n_audio_state=256, n_text_state=256))  # Dh 64: K1's by default
    model = TM.params_from_jax_numpy(_jax_params(jd)[0], td, device="cuda").requires_grad_(True)
    mel = torch.from_numpy(_batch(0)[0]).cuda()
    with pytest.raises(RuntimeError, match="no backward"):
        TM.encode(model, mel, td)
    TM.encode(model, mel, td, flash=False).square().sum().backward()
    for blk in model.encoder.blocks:
        for proj in (blk.attn.q, blk.attn.k, blk.attn.v):
            assert proj.weight.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# loss_fn and train_step against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("align", [False, True], ids=["ce", "ce+align"])
def test_loss_and_grads_match_jax(align):
    jd, td = _dims(SMALL)
    tree, jp = _jax_params(jd)
    mel, tok, lo, hi = _batch(1)
    jargs, targs = _align_args(jd, lo, hi, align)
    want_loss, want_grads = _jax_value_and_grad(jp, jnp.asarray(mel), jnp.asarray(tok), jd, *jargs)
    model = TM.params_from_jax_numpy(tree, td).requires_grad_(True)
    loss = TT.loss_fn(model, torch.from_numpy(mel), torch.from_numpy(tok), td, *targs)
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= LOSS_TOL
    _assert_tree_close(TM.params_to_jax_numpy(model, td, grad=True), want_grads)
    # the gradient reaches the encoder's attention and the decoder's cache writes
    assert model.encoder.blocks[0].attn.q.weight.grad.abs().sum() > 0
    assert model.decoder.blocks[0].attn.k.weight.grad.abs().sum() > 0


def test_align_without_windows_raises():
    jd, td = _dims(SMALL)
    model = TM.params_from_jax_numpy(_jax_params(jd)[0], td)
    mel, tok, _, _ = _batch(2)
    spec = TM.AlignSpec.from_pairs(default_alignment_heads(jd))
    with pytest.raises(ValueError, match="align_lo/align_hi"):
        TT.loss_fn(model, torch.from_numpy(mel), torch.from_numpy(tok), td, align=spec)


def test_schedule_matches_optax():
    for init, peak, warm, decay, end in ((0.0, 1e-3, 40, 400, 5e-5), (0.0, 1e-2, 2, 10, 0.0),
                                         (1e-4, 3e-3, 0, 50, 1e-4)):
        want = optax.warmup_cosine_decay_schedule(init, peak, warm, decay, end)
        got = TT.warmup_cosine_decay_schedule(init, peak, warm, decay, end)
        for count in (0, 1, 2, warm - 1, warm, warm + 1, decay // 2, decay - 1, decay, decay + 7):
            if count >= 0:
                # optax evaluates in float32, the port in Python floats
                assert got(count) == pytest.approx(float(want(count)), rel=1e-5, abs=1e-12), count
    assert TT.make_optimizer().lr_at(5) == 1e-4


@pytest.mark.parametrize("align", [False, True], ids=["ce", "ce+align"])
def test_three_adamw_steps_match_optax(align):
    """Three ``train_step``s under a warmup-cosine schedule whose first
    update has lr 0, against ``optax.adamw``: losses and the weights."""
    jd, td = _dims(SMALL)
    tree, jp = _jax_params(jd, seed=3)
    sched = dict(init_value=0.0, peak_value=1e-2, warmup_steps=2, decay_steps=10, end_value=5e-4)
    jtx = JT.make_optimizer(optax.warmup_cosine_decay_schedule(**sched))
    ttx = TT.make_optimizer(TT.warmup_cosine_decay_schedule(**sched))
    jstate = JT.TrainState(jp, jtx.init(jp), jnp.int32(0))
    model = TM.params_from_jax_numpy(tree, td)
    tstate = TT.TrainState(model, ttx.init(model), 0)
    assert all(p.requires_grad for p in model.parameters())
    for i in range(3):
        mel, tok, lo, hi = _batch(10 + i)
        jargs, targs = _align_args(jd, lo, hi, align)
        before = TM.params_to_jax_numpy(model, td)
        jstate, jloss = _jax_train_step(jstate, jnp.asarray(mel), jnp.asarray(tok), jd, jtx, *jargs)
        tstate, tloss = TT.train_step(tstate, torch.from_numpy(mel), torch.from_numpy(tok), td, ttx, *targs)
        assert abs(tloss.item() - float(jloss)) <= LOSS_TOL
        after = TM.params_to_jax_numpy(model, td)
        if i == 0:  # lr 0: nothing moves, though the moments fill
            _assert_tree_close(after, before)
            assert all(np.array_equal(a, b) for a, b in zip(_leaves(after).values(), _leaves(before).values()))
        _assert_tree_close(after, jstate.params)
    assert tstate.step == 3
    moved = max(np.abs(_leaves(after)[k] - _leaves(tree)[k]).max() for k in _leaves(tree))
    assert moved > 1e-3  # the two later updates are large against the tolerance


# ---------------------------------------------------------------------------
# The structured-weights trainer against scripts/train_structured_weights.py
# ---------------------------------------------------------------------------


def test_word_vocab_falls_back_on_the_standin_vocabulary(vocab, script):
    assert script.word_vocab(vocab) == ([], [])  # no 4-byte token in the stand-in
    words, ids = TS.word_vocab(vocab)
    assert words == TS.STANDIN_POOL[:24] and len(set(ids)) == 24
    assert all(vocab.encode(" " + w) == [i] for w, i in zip(words, ids))
    assert TS.WORD_POOL == script.WORD_POOL


def test_synthesis_matches_the_script(script):
    for fn, args in ((TS.schedule, (7, 29.0, 24)), (TS.events_words, (5, 2.0, 9.0, TS.STANDIN_POOL)),
                     (TS._word_formants, (13, 24)), (TS.align_windows, (4, 48, 29))):
        got, want = fn(*args), getattr(script, fn.__name__)(*args)
        np.testing.assert_array_equal(np.asarray(got, dtype=object), np.asarray(want, dtype=object))
    np.testing.assert_array_equal(TS.events_audio(1.5, 3, 0.7), script.events_audio(1.5, 3, 0.7))
    ev = TS.schedule(11, 4.0, 24)
    np.testing.assert_array_equal(TS.render_events(ev, 4.0, 0.0, 24), script.render_events(ev, 4.0, 0.0, 24))


def test_align_scaffold_matches_the_script(script):
    jd, td = _dims(WIDE)
    tree, jp = _jax_params(jd)
    want = script.align_scaffold(jax.tree.map(lambda x: x, jp), jd, prompt_len=4)
    got = TS.align_scaffold(TM.params_from_jax_numpy(tree, td), td, prompt_len=4)
    _assert_tree_close(TM.params_to_jax_numpy(got, td), want)
    np.testing.assert_array_equal(got.decoder.blocks[1].cross.q.weight, got.decoder.blocks[1].cross.k.weight)


def test_first_losses_match_the_script(vocab, script):
    """The script's training recipe (scaffold, align supervision, its
    schedule) and the port's, on the script's ``make_batch`` output: the
    first three losses agree."""
    jd, td = _dims(WIDE)
    words, word_ids = TS.word_vocab(vocab)
    prompt_len = len(vocab.sot_sequence_including_notimestamps)
    tree, jp = _jax_params(jd, seed=5)
    jp = script.align_scaffold(jp, jd, prompt_len)
    model = TS.align_scaffold(TM.params_from_jax_numpy(tree, td), td, prompt_len)
    sched = dict(init_value=0.0, peak_value=1e-3, warmup_steps=40, decay_steps=400, end_value=5e-5)
    jtx = JT.make_optimizer(optax.warmup_cosine_decay_schedule(**sched))
    ttx = TT.make_optimizer(TT.warmup_cosine_decay_schedule(**sched))
    jstate = JT.TrainState(jp, jtx.init(jp), jnp.int32(0))
    tstate = TT.TrainState(model, ttx.init(model), 0)
    n_events = len(script.schedule(0, script.WIN_S - 1.0, len(words)))
    lo, hi = script.align_windows(prompt_len, 48, n_events)
    jal = JM.AlignSpec.from_pairs(default_alignment_heads(jd))
    tal = TM.AlignSpec.from_pairs(default_alignment_heads(jd))
    for i in range(3):
        mel, tok = script.make_batch(vocab, word_ids, len(words), [10_000 + 2 * i, 10_001 + 2 * i], 48, 80)
        assert mel.shape == (2, 80, 3000) and (tok[:, :prompt_len] == vocab.sot_sequence_including_notimestamps).all()
        jstate, jloss = _jax_train_step(jstate, jnp.asarray(mel), jnp.asarray(tok), jd, jtx,
                                        jal, jnp.asarray(lo), jnp.asarray(hi), 1.0)
        tstate, tloss = TT.train_step(tstate, torch.from_numpy(mel), torch.from_numpy(tok), td, ttx,
                                      tal, torch.from_numpy(lo), torch.from_numpy(hi), 1.0)
        assert abs(tloss.item() - float(jloss)) <= LOSS_TOL, i


def test_npz_loads_through_the_script(tmp_path, script):
    jd, td = _dims(WIDE)
    tree, _ = _jax_params(jd)
    model = TM.params_from_jax_numpy(tree, td, dtype=torch.bfloat16)
    path = tmp_path / "w.npz"
    TS.save_params(model, "base", path)
    jtree, name = script.load_params(str(path))
    assert name == "base"
    want = TM.params_to_jax_numpy(model, td)
    got = jax.tree.map(lambda x: np.asarray(x, np.float32), jtree)
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys() and all(np.array_equal(g[k], w[k]) for k in w)
    assert all(str(x.dtype) == "bfloat16" for x in jax.tree.leaves(jtree))
    # and back through the port's reader, bit for bit (MODEL_DIMS["base"] names
    # the dims; only the tree is compared)
    z = np.load(path)
    assert z["__dims__"] == "base" and z["encoder/blocks/attn/q/w"].dtype == np.dtype("V2")


def test_trainer_runs_end_to_end_on_the_cpu(tmp_path, vocab, monkeypatch):
    """``main`` at a tiny size: the loss falls, the npz round-trips bit for
    bit through ``load_params`` and the native directory loads."""
    from whisperlivekit_tpu_torch.models.whisper import dims as D
    from whisperlivekit_tpu_torch.models.whisper.load import load_native

    _, td = _dims(WIDE)
    monkeypatch.setitem(D.MODEL_DIMS, "tiny-train", td)
    out, native, report = tmp_path / "w.npz", tmp_path / "native", tmp_path / "r.json"
    rep = TS.main(["--model", "tiny-train", "--steps", "12", "--batch", "2", "--dataset-batches", "2",
                   "--lr", "3e-3", "--n-words", "6", "--out", str(out), "--out-native", str(native),
                   "--report", str(report), "--cache-dir", str(tmp_path / "ds")], device="cpu")
    assert len(rep["losses"]) == 12 and np.isfinite(rep["losses"]).all()
    assert np.mean(rep["losses"][-3:]) < rep["losses"][0]
    assert 0.0 <= rep["greedy_token_accuracy"] <= 1.0 and 0.0 < rep["align_sharpness_mean_maxp"] <= 1.0
    assert list((tmp_path / "ds").glob("*.npz"))
    loaded, name = TS.load_params(out, device="cpu")
    assert name == "tiny-train" and loaded.dtype == torch.bfloat16
    nat, ndims = load_native(native)
    assert dataclasses.asdict(ndims) == dataclasses.asdict(td)
    for (n1, a), (n2, b) in zip(loaded.named_parameters(), nat.named_parameters()):
        assert n1 == n2 and torch.equal(a, b), n1
