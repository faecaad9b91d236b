"""The port's batched Silero VAD (audio/vad_model.py, audio/vad_batched.py)
against the JAX package's (audio/vad_jax.py, audio/vad_batched.py), on the
CPU.

Neither machine has Silero's ``silero_vad.jit``, so both packages read one
seeded stand-in in its layout (``harness/vad_checkpoint.py``, written in a
temporary directory, its head calibrated on audio of other seeds than the
audio scored here):

- the loader (bit-equal), the step (1e-5, state carried), the JAX pytree
  bridge, the stand-in's own scripted forward through the port's host path
  (2e-4, the JAX suite's Silero bar), lane isolation (1e-5), and
  FixedVADIterator's events on both packages' frame models;
- the batched scheduler: a window with one lane twice (sub-steps), a
  concurrent run, lane release and exhaustion, AsyncFixedVADIterator's
  events;
- the wiring: the engine builds the scheduler on its device (CPU here),
  falls back only when the file is absent, raises on a corrupt file and
  without CUDA when no device is given; the pipeline serves words under
  ``vac`` with it, alone and beside the JAX package's on one checkpoint.
"""

import asyncio
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperlivekit_tpu.audio import vad as JVAD
from whisperlivekit_tpu.audio import vad_batched as JB
from whisperlivekit_tpu.audio import vad_jax as JV
from whisperlivekit_tpu.harness import harness as JH
from whisperlivekit_tpu.models.whisper.dims import MODEL_DIMS
from whisperlivekit_tpu_torch.audio import vad as TVAD
from whisperlivekit_tpu_torch.audio import vad_batched as TB
from whisperlivekit_tpu_torch.audio import vad_model as TV
from whisperlivekit_tpu_torch.engine import core as TC
from whisperlivekit_tpu_torch.harness import harness as TH
from whisperlivekit_tpu_torch.harness import vad_checkpoint as VC
from whisperlivekit_tpu_torch.harness.vocab import write_standin_vocab
from torch_ckpt import canonical_state_dict, write_openai

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6

STANDIN_SEED = 5
STEP_TOL = 1e-5      # f32 step, JAX against the port (tests/test_vad_jax.py:65's lane bar)
SCRIPTED_TOL = 2e-4  # against the scripted forward (tests/test_vad_jax.py:50)
NEAR = 1e-3          # no JAX probability this close to 0.5 or 0.35
N_FRAMES = 90


def speech_with_pause(seconds: float, seed: int) -> np.ndarray:
    """f32 PCM: faint noise (0.4 s), a modulated voiced tone under noise,
    faint noise again (0.6 s), another tone: a stream opening in silence
    with one pause."""
    rng = np.random.default_rng(seed)
    quiet = lambda s: (1e-3 * rng.standard_normal(int(16000 * s))).astype(np.float32)  # noqa: E731

    def voiced(s):
        t = np.arange(int(16000 * s)) / 16000
        f0 = rng.uniform(120, 300)
        sig = 0.25 * np.sin(2 * np.pi * f0 * t) * (1 + 0.4 * np.sin(2 * np.pi * 3.1 * t))
        return (sig + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)

    half = (seconds - 1.0) / 2
    return np.concatenate([quiet(0.4), voiced(half), quiet(0.6), voiced(half)])


def lanes_audio(n_lanes: int, seed: int) -> np.ndarray:
    """[n_lanes, 90 * 512] f32, a distinct seed per lane."""
    return np.stack([speech_with_pause(N_FRAMES * 512 / 16000, seed * 100 + i)[: N_FRAMES * 512]
                     for i in range(n_lanes)])


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """A calibrated stand-in and the stand-in vocabulary in one asset
    directory; both packages' weights read from it."""
    root = tmp_path_factory.mktemp("vad")
    path = VC.write_silero_standin(root, STANDIN_SEED, calibrate=VC.calibration_audio(STANDIN_SEED + 1))
    write_standin_vocab(root)
    return dict(dir=root, path=str(path), jax=JV.load_params(str(path)),
                torch=TV.load_params(str(path), device="cpu"))


def _assert_clear_of_thresholds(probs):
    probs = np.asarray(probs)
    near = min(np.abs(probs - 0.5).min(), np.abs(probs - 0.35).min())
    assert near >= NEAR, (f"a JAX probability lies {near:.2e} from a threshold (0.5 or 0.35): the two "
                          "packages' events could differ by rounding alone on this audio")


# ---------------------------------------------------------------------------
# the model: loader, step, bridge, scripted forward, lanes, iterator
# ---------------------------------------------------------------------------


def test_load_params_bit_equal_to_jax(standin):
    j, t = standin["jax"], standin["torch"].state_dict()
    pairs = [(j["stft_basis"], t["stft_basis"])]
    pairs += [(j["enc"][i][a], t[f"enc.{i}.{b}"]) for i in range(4) for a, b in (("w", "weight"), ("b", "bias"))]
    pairs += [(j["lstm"][a], t[f"lstm.{b}"]) for a, b in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                                                         ("b_ih", "bias_ih"), ("b_hh", "bias_hh"))]
    pairs += [(j["head"]["w"], t["head.weight"]), (j["head"]["b"], t["head.bias"])]
    assert len(pairs) == len(t) == 15
    for a, b in pairs:
        a = np.asarray(a)
        assert a.dtype == np.float32 and b.dtype == torch.float32 and a.shape == tuple(b.shape)
        assert np.array_equal(a, b.numpy())
    assert standin["torch"].stft_basis.device.type == "cpu"


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_lanes", [1, 8])
def test_vad_step_matches_jax(standin, seed, n_lanes):
    """90 frames, state carried: probabilities, h and c within 1e-5, the
    context exact."""
    audio = lanes_audio(n_lanes, seed)
    sj, st = JV.init_state(n_lanes), TV.init_state(n_lanes, "cpu")
    probs = []
    for i in range(N_FRAMES):
        frames = audio[:, i * 512 : (i + 1) * 512]
        pj, sj = JV.vad_step(standin["jax"], sj, jnp.asarray(frames))
        pt, st = TV.vad_step(standin["torch"], st, torch.from_numpy(frames))
        assert pt.shape == (n_lanes,) and pt.dtype == torch.float32
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=STEP_TOL)
        np.testing.assert_allclose(st.h.numpy(), np.asarray(sj.h), rtol=0, atol=STEP_TOL)
        np.testing.assert_allclose(st.c.numpy(), np.asarray(sj.c), rtol=0, atol=STEP_TOL)
        assert np.array_equal(st.context.numpy(), np.asarray(sj.context))
        probs.append(np.asarray(pj))
    probs = np.stack(probs)
    _assert_clear_of_thresholds(probs)
    # the calibrated stand-in opens and closes on this audio: every lane has
    # frames over 0.5 and under 0.35
    assert (probs.max(0) > 0.5).all() and (probs.min(0) < 0.35).all()


def test_params_from_jax_gives_the_same_step(standin):
    bridged = TV.params_from_jax(jax.tree_util.tree_map(np.asarray, standin["jax"]))
    for k, v in standin["torch"].state_dict().items():
        assert torch.equal(bridged.state_dict()[k], v), k
    audio = lanes_audio(4, seed=3)
    sa, sb = TV.init_state(4, "cpu"), TV.init_state(4, "cpu")
    for i in range(0, N_FRAMES, 3):
        frames = torch.from_numpy(audio[:, i * 512 : (i + 1) * 512])
        pa, sa = TV.vad_step(bridged, sa, frames)
        pb, sb = TV.vad_step(standin["torch"], sb, frames)
        assert torch.equal(pa, pb) and torch.equal(sa.h, sb.h) and torch.equal(sa.c, sb.c)


def test_step_matches_the_scripted_forward(standin):
    """The port's step against the stand-in's own TorchScript forward, run
    by the port's host path (SileroJITVAD), within the JAX suite's 2e-4."""
    oracle = TVAD.SileroJITVAD(standin["path"])
    vad = TV.SileroTorchVAD(params=standin["torch"])
    audio = lanes_audio(1, seed=4)[0]
    worst = 0.0
    for i in range(N_FRAMES):
        frame = audio[i * 512 : (i + 1) * 512]
        worst = max(worst, abs(vad(frame) - oracle(frame)))
    assert worst < SCRIPTED_TOL
    oracle.reset_states()
    vad2 = vad.new_session()
    assert vad2.params is vad.params and vad2(audio[:512]) == pytest.approx(oracle(audio[:512]), abs=SCRIPTED_TOL)


def test_batched_lanes_match_sequential(standin):
    """Twin of tests/test_vad_jax.py::test_batched_lanes_match_sequential:
    two lanes stepped together equal each stepped alone."""
    a = lanes_audio(1, seed=5)[0]
    b = lanes_audio(1, seed=6)[0] * 0.01  # near-silence lane
    s2, sa, sb = TV.init_state(2, "cpu"), TV.init_state(1, "cpu"), TV.init_state(1, "cpu")
    for i in range(0, len(a) - 512, 512):
        fa, fb = torch.from_numpy(a[i : i + 512]), torch.from_numpy(b[i : i + 512])
        p2, s2 = TV.vad_step(standin["torch"], s2, torch.stack([fa, fb]))
        pa, sa = TV.vad_step(standin["torch"], sa, fa[None])
        pb, sb = TV.vad_step(standin["torch"], sb, fb[None])
        np.testing.assert_allclose(p2.numpy(), [float(pa[0]), float(pb[0])], rtol=0, atol=STEP_TOL)


def test_batched_silero_vad_steps_and_resets_a_lane(standin):
    vad = TV.BatchedSileroVAD(3, model_path=standin["path"], device="cpu")
    audio = lanes_audio(3, seed=7)
    first = vad.step(audio[:, :512])
    for i in range(1, 20):
        vad.step(audio[:, i * 512 : (i + 1) * 512])
    vad.reset_lane(1)
    assert not vad.state.h[1].any() and not vad.state.c[1].any() and not vad.state.context[1].any()
    assert vad.state.h[0].any()
    again = vad.step(audio[:, :512])
    assert again[1] == first[1] and isinstance(again, np.ndarray) and again.shape == (3,)


def _events(it, audio, step=4096):
    out = []
    for i in range(0, len(audio), step):
        out.extend(it(audio[i : i + step]))
    return out


def test_fixed_iterator_events_equal_jax(standin):
    """FixedVADIterator over SileroTorchVAD gives JAX's events (over
    SileroJAXVAD), sample for sample, at the default thresholds."""
    audio = np.concatenate([lanes_audio(1, seed=8)[0], lanes_audio(1, seed=9)[0]])
    tj = _events(JVAD.FixedVADIterator(JV.SileroJAXVAD(params=standin["jax"])), audio)
    tt = _events(TVAD.FixedVADIterator(TV.SileroTorchVAD(params=standin["torch"])), audio)
    assert tt == tj
    assert [next(iter(e)) for e in tt] == ["start", "end"] * 3 + ["start"]  # four voiced spans, three pauses
    probs, s = [], JV.init_state(1)
    for i in range(0, len(audio) - 511, 512):
        p, s = JV.vad_step(standin["jax"], s, jnp.asarray(audio[i : i + 512])[None])
        probs.append(float(p[0]))
    _assert_clear_of_thresholds(probs)


def test_without_cuda_the_loader_raises(standin, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TV.load_params(standin["path"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TB.BatchedVADScheduler(max_lanes=2)


def test_missing_file_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        TV.load_params(str(tmp_path / "silero_vad.jit"), device="cpu")


# ---------------------------------------------------------------------------
# the batched scheduler
# ---------------------------------------------------------------------------


def _schedulers(standin, lanes=4, window_s=0.01):
    return (JB.BatchedVADScheduler(max_lanes=lanes, window_s=window_s, params=standin["jax"]),
            TB.BatchedVADScheduler(max_lanes=lanes, window_s=window_s, params=standin["torch"]))


def test_step_splits_a_lane_submitted_twice(standin):
    """``_step`` on one fixed window in which lane 2 appears twice (and lane
    0 three times): sequential sub-steps, the same probabilities as JAX
    within 1e-5, the same step and frame counts."""
    audio = lanes_audio(3, seed=10)
    order = [(0, 0), (2, 0), (1, 0), (2, 1), (0, 1), (0, 2)]  # (lane, frame index)

    async def run(sched):
        loop = asyncio.get_running_loop()
        batch = [(lane, audio[lane, k * 512 : (k + 1) * 512], loop.create_future()) for lane, k in order]
        sched._step(batch)
        return [b[2].result() for b in batch], sched.n_steps, sched.n_frames_scored

    j, t = _schedulers(standin)
    pj, nj, fj = asyncio.run(run(j))
    pt, nt, ft = asyncio.run(run(t))
    np.testing.assert_allclose(pt, pj, rtol=0, atol=STEP_TOL)
    assert (nt, ft) == (nj, fj) == (3, 6)
    # sub-steps are sequential: lane 0's third frame scored after its second
    solo, s = [], TV.init_state(1, "cpu")
    for k in range(3):
        p, s = TV.vad_step(standin["torch"], s, torch.from_numpy(audio[0, k * 512 : (k + 1) * 512])[None])
        solo.append(float(p[0]))
    np.testing.assert_allclose([pt[0], pt[4], pt[5]], solo, rtol=0, atol=STEP_TOL)
    stats = t.stats()
    assert stats["n_steps"] == 3 and stats["lanes_per_step_max"] == 3 and stats["lanes_per_step_mean"] == 2.0
    assert stats["step_ms_p50"] is not None and stats["step_ms_p95"] >= stats["step_ms_p50"]


def test_concurrent_scoring_matches_jax(standin):
    """Three lanes scoring 40 frames each at once (asyncio.gather): every
    probability within 1e-5 of JAX's, the same frames scored. Step counts
    depend on timing and are not compared."""
    audio = lanes_audio(3, seed=11)

    async def run(sched):
        lanes = [sched.acquire() for _ in range(3)]

        async def one(lane, pcm):
            return [await sched.score(lane, pcm[k * 512 : (k + 1) * 512]) for k in range(40)]

        out = await asyncio.gather(*(one(lane, audio[i]) for i, lane in enumerate(lanes)))
        return np.asarray(out), sched.n_frames_scored, sched.n_steps

    j, t = _schedulers(standin)
    pj, fj, _ = asyncio.run(run(j))
    pt, ft, nt = asyncio.run(run(t))
    np.testing.assert_allclose(pt, pj, rtol=0, atol=STEP_TOL)
    assert ft == fj == 120 and nt <= 120
    assert t.max_lanes_per_step >= 2  # the window packed lanes together


def test_release_resets_the_lane_and_exhaustion(standin):
    async def main():
        sched = TB.BatchedVADScheduler(max_lanes=1, window_s=0.01, params=standin["torch"])
        lane = sched.acquire()
        frame = lanes_audio(1, seed=12)[0][8000:8512]
        p1 = await sched.score(lane, frame)
        p1b = await sched.score(lane, frame)
        assert sched.pool.h[lane].any()
        sched.release(lane)
        assert not sched.pool.h[lane].any() and not sched.pool.c[lane].any()
        assert not sched.pool.context[lane].any()
        lane2 = sched.acquire()
        assert lane2 == lane
        p2 = await sched.score(lane2, frame)
        assert p1 == p2 and p1b != p1  # fresh state after release
        assert sched.acquire() is None  # exhausted
        with pytest.raises(RuntimeError, match="exhausted"):
            TB.AsyncFixedVADIterator(sched)
        assert sched.pool.h.device.type == "cpu"

    asyncio.run(main())


def test_async_iterator_events_equal_jax(standin):
    """AsyncFixedVADIterator on both packages' schedulers, two sessions at
    once over audio with pauses: the same events, sample for sample, and
    the same as FixedVADIterator over the frame model."""
    audios = [np.concatenate([lanes_audio(1, seed=s)[0], np.zeros(8000, np.float32)]) for s in (13, 14)]

    async def run(B, sched):
        its = [B.AsyncFixedVADIterator(sched) for _ in audios]

        async def one(it, audio):
            out = []
            for i in range(0, len(audio), 2048):
                out.extend(await it(audio[i : i + 2048]))
            it.close()
            return out

        events = await asyncio.gather(*(one(it, a) for it, a in zip(its, audios)))
        assert all(it.lane is None for it in its) and len(sched._free) == sched.capacity
        return events

    j, t = _schedulers(standin)
    ej = asyncio.run(run(JB, j))
    et = asyncio.run(run(TB, t))
    assert et == ej
    sync = [_events(TVAD.FixedVADIterator(TV.SileroTorchVAD(params=standin["torch"])), a, 2048) for a in audios]
    assert et == sync
    for ev in et:
        assert [next(iter(e)) for e in ev] == ["start", "end"] * 2


# ---------------------------------------------------------------------------
# the wiring: engine, processor, pipeline
# ---------------------------------------------------------------------------


@pytest.fixture
def engine_env(standin, monkeypatch, tmp_path):
    monkeypatch.setenv("WLK_TPU_ASSET_DIR", str(standin["dir"]))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    TC.TranscriptionEngine.reset()
    yield standin
    TC.TranscriptionEngine.reset()


def _engine(device="cpu", **kw):
    TC.TranscriptionEngine.reset()
    base = dict(model_size="random:dev-tiny", lan="en", vac=True, vad_backend="jax-batched",
                param_dtype="float32", scheduler=False, log_level="ERROR")
    return TC.TranscriptionEngine(device=device, **{**base, **kw})


def test_engine_builds_the_scheduler_on_its_device(engine_env):
    from whisperlivekit_tpu_torch.session.processor import AudioProcessor

    eng = _engine(max_batch_sessions=3)
    sched = eng.vad_scheduler
    assert isinstance(sched, TB.BatchedVADScheduler) and eng.vac_model is None
    assert sched.capacity == 12 and sched.pool.h.shape == (12, 128)
    assert all(t.device.type == "cpu" for t in sched.pool) and sched.params.stft_basis.device.type == "cpu"
    proc = AudioProcessor(transcription_engine=eng)
    assert proc._vac_async and isinstance(proc.ingest.vad, TB.AsyncFixedVADIterator)
    # the host path beside it: vad_backend="auto" runs the stand-in through torch.jit
    host = _engine(vad_backend="auto")
    assert host.vad_scheduler is None and isinstance(host.vac_model, TVAD.SileroJITVAD)
    assert not AudioProcessor(transcription_engine=host)._vac_async


def test_engine_without_the_file_warns_and_uses_the_host_vad(engine_env, tmp_path, monkeypatch, caplog):
    empty = tmp_path / "empty"
    write_standin_vocab(empty)
    monkeypatch.setenv("WLK_TPU_ASSET_DIR", str(empty))
    with caplog.at_level(logging.WARNING):
        eng = _engine()
    assert eng.vad_scheduler is None and isinstance(eng.vac_model, TVAD.EnergyVAD)
    assert "jax-batched VAD unavailable" in caplog.text


def test_engine_with_a_corrupt_file_raises(engine_env, tmp_path, monkeypatch):
    bad = tmp_path / "bad"
    write_standin_vocab(bad)
    (bad / "silero_vad.jit").write_bytes(b"not a torchscript archive")
    monkeypatch.setenv("WLK_TPU_ASSET_DIR", str(bad))
    with pytest.raises(RuntimeError):
        _engine()


def test_engine_without_cuda_and_no_device_raises(engine_env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _engine(device=None)


def test_pipeline_with_batched_vad(engine_env):
    """Twin of tests/test_vad_batched.py::test_pipeline_with_batched_vad on
    the calibrated stand-in: the session ends without error, got words, and
    its gate closed at the pause."""
    async def main():
        TH.reset_engine_cache()
        try:
            async with TH.TestHarness(model_size="random:dev-tiny", lan="en", vac=True,
                                      vad_backend="jax-batched", log_level="ERROR", device="cpu") as h:
                assert h._processor._vac_async
                await h.feed_audio(speech_with_pause(6.0, seed=15), speed=0)
                await h.drain(1.0)
                final = await h.finish(timeout=60)
                m = h.metrics
                sched = h._processor.engine.vad_scheduler
            return final, (m.n_silence_events, m.total_silence_duration_s), sched
        finally:
            TH.reset_engine_cache()

    final, (n_silences, silence_s), sched = asyncio.run(main())
    assert final.error == "" and final.text.strip()
    # the opening silence ended at the speech, and the pause (0.6 s) closed
    # and reopened the gate
    assert n_silences == 2 and 0.5 < silence_s < 1.5
    assert sched.n_frames_scored >= 180 and sched.pool.h.device.type == "cpu"


def test_both_packages_serve_vac_alike(engine_env, tmp_path):
    """Both packages' TestHarness, vac=True with vad_backend="jax-batched",
    on one dev-tiny checkpoint, the stand-in and one PCM: the same silence
    records (count and seconds), and words on both. The words themselves
    depend on how much audio each transcription call finds queued behind
    the VAD's window, so they are not compared (two JAX runs of this test
    differ from each other under vac; tests/test_torch_harness.py compares
    tokens with vac off)."""
    ckpt = write_openai(tmp_path / "tiny.pt", canonical_state_dict(MODEL_DIMS["dev-tiny"], seed=3),
                        MODEL_DIMS["dev-tiny"], np.float32)
    pcm = speech_with_pause(6.0, seed=16)

    def stream(H, **kw):
        async def main():
            H.reset_engine_cache()
            try:
                async with H.TestHarness(model_path=str(ckpt), lan="en", vac=True, vad_backend="jax-batched",
                                         param_dtype="float32", log_level="ERROR", **kw) as h:
                    assert h._processor._vac_async
                    await h.feed_audio(pcm, speed=0)
                    await h.drain(1.0)
                    final = await h.finish(timeout=120)
                    return final, (h.metrics.n_silence_events, h.metrics.total_silence_duration_s)
            finally:
                H.reset_engine_cache()
        return asyncio.run(main())

    js, jsil = stream(JH)
    ts, tsil = stream(TH, device="cpu")
    assert ts.error == js.error == ""
    assert tsil == jsil and tsil[0] == 2
    assert ts.text.strip() and js.text.strip()
