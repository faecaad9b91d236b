"""The port's pooled causal lanes (streaming/qwen3_batch.py) and OpBatcher
(engine/op_batcher.py) on the CPU at DEV_TINY widths, against the port's
local-cache path and the JAX package's pooled service on the same weights.

Load-bearing properties: pooled-lane outputs equal the local-cache path
and JAX's pooled output exactly, concurrent sessions' ops pack into shared
device calls, hypothesis decode never mutates pool rows, lanes recycle,
duplicate scatter indices land only on the scratch row (whose contents no
live lane reads), and the segment policy flushes before a lane's tower or
text rows would clamp.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from whisperlivekit_tpu.models import qwen3_asr as JQ
from whisperlivekit_tpu.streaming import qwen3_batch as JB
from whisperlivekit_tpu.streaming import qwen3_causal as JC
from whisperlivekit_tpu_torch.models import qwen3_asr as TQ
from whisperlivekit_tpu_torch.streaming import qwen3_batch as TB
from whisperlivekit_tpu_torch.streaming import qwen3_causal as TC

torch.set_num_threads(1)  # tier-1 runs under xdist -n 6


@pytest.fixture(scope="module")
def holders():
    jp = JQ.init_params(JQ.DEV_TINY, jax.random.PRNGKey(0))
    tm = TQ.qwen3_params_from_jax(jax.tree.map(np.asarray, jp), TQ.DEV_TINY)
    return (JC.Qwen3CausalASR(jp, JQ.DEV_TINY, window_s=4.0, max_new=8),
            TC.Qwen3CausalASR(tm, TQ.DEV_TINY, window_s=4.0, max_new=8))


@pytest.fixture()
def holder(holders):
    return holders[1]


def audio_seconds(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * n)) / 16000
    return (0.3 * np.sin(2 * np.pi * 200 * t) + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)


def _tokens(tokens):
    return [(t.text, t.start, t.end) for t in tokens]


def collect_local(C, holder, seeds, n_sec=3):
    """Reference: each session through the local-cache sync path."""
    results = []
    for seed in seeds:
        proc = C.Qwen3CausalProcessor(holder)
        committed = []
        for i in range(n_sec):
            proc.insert_audio_chunk(audio_seconds(1, seed=seed * 10 + i), float(i + 1))
            committed.extend(proc.process_iter()[0])
        committed.extend(proc.finish()[0])
        results.append(_tokens(committed))
    return results


def collect_pooled(C, service, holder, seeds, n_sec=3):
    async def one(seed):
        proc = C.Qwen3CausalProcessor(holder, service=service)
        committed = []
        for i in range(n_sec):
            proc.insert_audio_chunk(audio_seconds(1, seed=seed * 10 + i), float(i + 1))
            committed.extend((await proc.process_iter_async())[0])
        committed.extend((await proc.finish_async())[0])
        proc.close()
        return _tokens(committed)

    async def main():
        return list(await asyncio.gather(*(one(s) for s in seeds)))

    return asyncio.run(main())


def test_pooled_equals_local_and_jax(holders):
    """Three concurrent pooled sessions (a batch of 3 padded to 4: one
    scratch row) commit the local path's exact words and times, and JAX's
    pooled service's; the batcher packed their ops."""
    jh, th = holders
    local = collect_local(TC, th, seeds=[1, 2, 3])
    service = TB.CausalBatchService(th, capacity=4, window_s=0.05)
    pooled = collect_pooled(TC, service, th, seeds=[1, 2, 3])
    jax_pooled = collect_pooled(JC, JB.CausalBatchService(jh, capacity=4, window_s=0.05, inline=False),
                                jh, seeds=[1, 2, 3])
    assert pooled == local == jax_pooled
    assert all(pooled)
    stats = service.stats()
    assert stats["append"]["ops"] >= 3
    assert stats["append"]["avg_ops_per_batch"] > 1 and stats["decode"]["avg_ops_per_batch"] > 1


def test_op_batcher_packs_and_serializes_across_event_loops():
    """Same-typed ops pack into one runner call; runners of different types
    never overlap (they share the pools), and both hold in a second event
    loop (the engine's warmup runs the pooled ops in one loop and the
    server in another): the batcher's queues, tasks and lock follow the
    running loop."""
    import threading
    import time

    from whisperlivekit_tpu_torch.engine.op_batcher import OpBatcher

    batcher, busy, overlaps = OpBatcher(window_s=0.02), threading.Lock(), []

    def runner(payloads):
        if not busy.acquire(blocking=False):
            overlaps.append(payloads)
            return payloads
        try:
            time.sleep(0.03)
            return [p * 10 for p in payloads]
        finally:
            busy.release()

    batcher.register("a", runner)
    batcher.register("b", runner)

    async def main():
        return await asyncio.gather(*(batcher.submit(op, i) for i in range(3) for op in ("a", "b")))

    for _ in range(2):
        assert asyncio.run(main()) == [i * 10 for i in range(3) for _ in "ab"]
    assert not overlaps
    stats = batcher.stats()
    assert stats["a"] == {"batches": 2, "ops": 6, "avg_ops_per_batch": 3.0} and stats["b"]["batches"] == 2


def test_decode_does_not_mutate_pools(holder):
    async def main():
        service = TB.CausalBatchService(holder, capacity=2, window_s=0.0)
        proc = TC.Qwen3CausalProcessor(holder, service=service)
        proc.insert_audio_chunk(audio_seconds(1), 1.0)
        await proc.process_iter_async()
        lane = proc.lane
        before = [p[:, lane].clone() for p in (service.pools.text_k, service.pools.text_v)]
        await service.decode(proc._lane_token, proc.text_pos)  # extra decode
        after = [p[:, lane] for p in (service.pools.text_k, service.pools.text_v)]
        proc.close()
        return before, after

    before, after = asyncio.run(main())
    assert all(torch.equal(b, a) for b, a in zip(before, after))


def test_lane_recycling(holder):
    async def main():
        service = TB.CausalBatchService(holder, capacity=1, window_s=0.0)
        p1 = TC.Qwen3CausalProcessor(holder, service=service)
        p1.insert_audio_chunk(audio_seconds(1), 1.0)
        await p1.process_iter_async()
        assert p1.lane == 1

        p2 = TC.Qwen3CausalProcessor(holder, service=service)
        p2.insert_audio_chunk(audio_seconds(1), 1.0)
        with pytest.raises(RuntimeError, match="exhausted"):
            await p2.process_iter_async()

        p1.close()
        await p2.process_iter_async()  # lane freed: works now
        assert p2.lane == 1
        p2.close()

    asyncio.run(main())


def test_dead_session_ops_hit_scratch_which_no_lane_reads(holder):
    """Ops still queued when a session closes must not touch a re-acquired
    lane (the disconnect race): dead tokens execute against the scratch row.
    The scratch row, poisoned with NaN, takes every padding and dead write
    (duplicate indices) and never reaches a live lane's words."""
    want = collect_local(TC, holder, seeds=[4, 5])

    async def main():
        service = TB.CausalBatchService(holder, capacity=2, window_s=0.05)
        pools = service.pools
        for p in (pools.tower_k, pools.tower_v, pools.text_k, pools.text_v):
            p[:, TB.CausalPools.SCRATCH] = float("nan")
        p1 = TC.Qwen3CausalProcessor(holder, service=service)
        p1.insert_audio_chunk(audio_seconds(1, seed=1), 1.0)
        await p1.process_iter_async()
        token, lane = p1._lane_token, p1.lane
        p1.close()  # token dead, lane freed

        async def one(seed):
            proc = TC.Qwen3CausalProcessor(holder, service=service)
            committed = []
            for i in range(3):
                proc.insert_audio_chunk(audio_seconds(1, seed=seed * 10 + i), float(i + 1))
                committed.extend((await proc.process_iter_async())[0])
                if seed == 4 and i == 0:
                    assert proc.lane == lane  # recycled
                    before = pools.text_k[:, lane].clone()
                    # a stale op from the dead session fires late, packed with live ones
                    await service.append(token, audio_seconds(1, seed=9)[: holder.dims.block_samples], 0, 4)
                    assert torch.equal(pools.text_k[:, lane], before)
            committed.extend((await proc.finish_async())[0])
            proc.close()
            return _tokens(committed)

        got = list(await asyncio.gather(one(4), one(5)))
        scratch_dirty = torch.isnan(pools.tower_k[:, TB.CausalPools.SCRATCH]).float().mean().item() < 1
        return got, scratch_dirty

    got, scratch_written = asyncio.run(main())
    assert got == want
    assert scratch_written  # padding and dead ops did land on the scratch row


def test_policy_flushes_before_rows_clamp(holder):
    """Cache writes clamp at the last row (JAX's ``minimum(pos, T-1)``);
    the segment policy must flush first: over 7 s of 0.4 s blocks with 4 s
    windows every append fits its lane's tower and text rows, and every
    hypothesis fits the text rows."""
    seen = []

    class Checked(TB.CausalBatchService):
        def _run_append(self, items):
            for _, _, start_frame, text_pos in items:
                seen.append(("append", start_frame + self.dims.block_frames, self.pools.tower_k.shape[2],
                             text_pos + self.dims.block_tokens, self.pools.text_k.shape[2]))
            return super()._run_append(items)

        def _run_decode(self, items):
            for _, text_pos in items:
                last = text_pos + len(self.holder.hyp_start_ids) + self.holder.max_new - 1
                seen.append(("decode", 0, 1, last, self.pools.text_k.shape[2]))
            return super()._run_decode(items)

    async def main():
        service = Checked(holder, capacity=1, window_s=0.0)
        proc = TC.Qwen3CausalProcessor(holder, service=service)
        for i in range(7):
            proc.insert_audio_chunk(audio_seconds(1, seed=i), float(i + 1))
            await proc.process_iter_async()
        await proc.finish_async()
        proc.close()

    asyncio.run(main())
    assert sum(1 for s in seen if s[0] == "append") == 18  # 7 s of 0.4 s blocks, the last padded
    assert all(end <= rows and text_end <= text_rows for _, end, rows, text_end, text_rows in seen), seen


def test_engine_wires_service_and_warms_the_pooled_path():
    from whisperlivekit_tpu_torch.config import WLKConfig
    from whisperlivekit_tpu_torch.engine.core import TranscriptionEngine, online_factory

    TranscriptionEngine.reset()
    try:
        cfg = WLKConfig(backend="qwen3", backend_policy="causal", model_size="random:dev-tiny", lan="en",
                        vac=False, pcm_input=True, scheduler=True, max_batch_sessions=4,
                        param_dtype="float32", log_level="ERROR")
        engine = TranscriptionEngine(cfg, device="cpu")
        assert isinstance(engine.scheduler, TB.CausalBatchService)
        assert engine.scheduler.pools.text_k.shape[1] == 5  # 4 lanes and the scratch row
        engine.warmup_synthetic()  # no running loop: the pooled ops run
        assert engine.scheduler.stats()["append"]["ops"] == 3  # 1 s of 0.4 s blocks, the last padded
        assert len(engine.scheduler.pools._free) == 4  # the warmup's lane came back
        proc = online_factory(cfg, engine.asr, scheduler=engine.scheduler)
        assert proc.service is engine.scheduler and hasattr(proc, "process_iter_async")
    finally:
        TranscriptionEngine.reset()
