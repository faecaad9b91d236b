"""Batched VAD scheduling: all sessions' 32 ms ticks in one device step
(port of whisperlivekit_tpu/audio/vad_batched.py).

Sessions submit frames into a queue; the scheduler packs a scheduling
window's worth of lanes, gathers their LSTM/context state from a pool on
the device (``index_select``), runs one ``vad_step`` (audio/vad_model.py —
the weight-exact Silero port), scatters the state back (``index_copy_``)
and reads the probabilities to the host once per sub-step. Per-lane state
never leaves the device. The step runs on the event loop's thread, as in
the JAX package.

Opt-in via ``vad_backend="jax-batched"`` (the JAX package's name for it,
so one command line serves both packages).
"""

from __future__ import annotations

import asyncio
import collections
import logging
import time
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

from .vad import FRAME, VADIterator
from .vad_model import VADState, init_state, load_params, vad_step

logger = logging.getLogger(__name__)

RECENT_STEPS = 4096  # sub-steps whose (lanes, ms) ``stats`` keeps for its quantiles


class BatchedVADScheduler:
    def __init__(self, max_lanes: int = 256, window_s: float = 0.01, params=None, device=None):
        self.params = params if params is not None else load_params(device=device)
        self.device = self.params.stft_basis.device
        self.capacity = max_lanes
        self.window_s = window_s
        self.pool: VADState = init_state(max_lanes, self.device)
        self._free = list(range(max_lanes))
        self._queue: Optional[asyncio.Queue] = None
        self._task: Optional[asyncio.Task] = None
        self.n_steps = 0
        self.n_frames_scored = 0
        self.max_lanes_per_step = 0
        self._recent: Deque[Tuple[int, float]] = collections.deque(maxlen=RECENT_STEPS)

    def acquire(self) -> Optional[int]:
        return self._free.pop() if self._free else None

    def release(self, lane: int) -> None:
        self.reset_lane(lane)
        self._free.append(lane)

    def reset_lane(self, lane: int) -> None:
        for t in self.pool:
            t[lane].zero_()

    async def score(self, lane: int, frame: np.ndarray) -> float:
        """Score one 512-sample frame for one lane (updates its state)."""
        self._ensure_running()
        fut = asyncio.get_running_loop().create_future()
        await self._queue.put((lane, np.asarray(frame, np.float32), fut))
        return await fut

    def stats(self) -> dict:
        """Sub-steps, lanes per sub-step (mean, max) and the ms of a
        sub-step on the event loop's thread, the host read included (p50,
        p95 over the last ``RECENT_STEPS``)."""
        ms = sorted(m for _, m in self._recent)

        def q(p: float) -> Optional[float]:
            return round(ms[min(int(p * len(ms)), len(ms) - 1)], 4) if ms else None

        return dict(n_steps=self.n_steps, n_frames_scored=self.n_frames_scored,
                    lanes_per_step_mean=round(self.n_frames_scored / max(self.n_steps, 1), 3),
                    lanes_per_step_max=self.max_lanes_per_step, step_ms_p50=q(0.5), step_ms_p95=q(0.95))

    def reset_stats(self) -> None:
        self.n_steps = self.n_frames_scored = self.max_lanes_per_step = 0
        self._recent.clear()

    # ---- internals ----------------------------------------------------------

    def _ensure_running(self) -> None:
        if self._task is None or self._task.done():
            self._queue = asyncio.Queue()
            self._task = asyncio.get_running_loop().create_task(
                self._run(), name="vad-scheduler"
            )

    async def _run(self) -> None:
        while True:
            batch: List[Tuple] = [await self._queue.get()]
            deadline = asyncio.get_running_loop().time() + self.window_s
            while True:
                timeout = deadline - asyncio.get_running_loop().time()
                if timeout <= 0:
                    break
                try:
                    batch.append(await asyncio.wait_for(self._queue.get(), timeout))
                except asyncio.TimeoutError:
                    break
            try:
                self._step(batch)
            except Exception as e:
                logger.exception("batched VAD step failed")
                for _, _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)

    def _step(self, batch: List[Tuple]) -> None:
        # one entry per lane per step: a lane submitting twice in a window
        # must see sequential state updates — split into sub-steps
        while batch:
            seen = set()
            sub, rest = [], []
            for item in batch:
                (sub if item[0] not in seen and not seen.add(item[0]) else rest).append(item)
            batch = rest

            t0 = time.perf_counter()
            lanes = torch.as_tensor([b[0] for b in sub], dtype=torch.long).to(self.device)
            frames = torch.from_numpy(np.stack([b[1] for b in sub])).to(self.device)
            state = VADState(*(t.index_select(0, lanes) for t in self.pool))
            probs, new_state = vad_step(self.params, state, frames)
            for pool, new in zip(self.pool, new_state):
                pool.index_copy_(0, lanes, new)
            probs_np = probs.cpu().numpy()
            self._recent.append((len(sub), (time.perf_counter() - t0) * 1e3))
            self.n_steps += 1
            self.n_frames_scored += len(sub)
            self.max_lanes_per_step = max(self.max_lanes_per_step, len(sub))
            for (lane, _, fut), p in zip(sub, probs_np):
                if not fut.done():
                    fut.set_result(float(p))


class AsyncFixedVADIterator:
    """FixedVADIterator with the frame model on the batched scheduler.

    Same hysteresis + ordered event contract (reference
    silero_vad_iterator.py:288-317), but ``__call__`` is async.
    """

    def __init__(self, scheduler: BatchedVADScheduler, **kw):
        self.scheduler = scheduler
        self.lane = scheduler.acquire()
        if self.lane is None:
            raise RuntimeError("VAD lane pool exhausted")

        class _Remote:
            def reset_states(inner) -> None:
                scheduler.reset_lane(self.lane)

            def __call__(inner, frame, sr=16000):  # pragma: no cover
                raise RuntimeError("use the async path")

        self._iter = VADIterator(_Remote(), **kw)
        self.buffer = np.array([], dtype=np.float32)

    def reset_states(self) -> None:
        self._iter.reset_states()
        self.buffer = np.array([], dtype=np.float32)

    async def __call__(self, x: np.ndarray, return_seconds: bool = False) -> List[dict]:
        self.buffer = np.append(self.buffer, x)
        events: List[dict] = []
        it = self._iter
        while len(self.buffer) >= FRAME:
            frame = self.buffer[:FRAME]
            self.buffer = self.buffer[FRAME:]
            prob = await self.scheduler.score(self.lane, frame)

            # inline hysteresis (VADIterator.__call__ with an async prob)
            it.current_sample += FRAME
            r = None
            if prob >= it.threshold and it.temp_end:
                it.temp_end = 0
            if prob >= it.threshold and not it.triggered:
                it.triggered = True
                start = max(0, it.current_sample - it.speech_pad_samples - FRAME)
                r = {"start": int(start) if not return_seconds else round(start / it.sampling_rate, 1)}
            elif prob < it.threshold - 0.15 and it.triggered:
                if not it.temp_end:
                    it.temp_end = it.current_sample
                if it.current_sample - it.temp_end >= it.min_silence_samples:
                    end = it.temp_end + it.speech_pad_samples - FRAME
                    it.temp_end = 0
                    it.triggered = False
                    r = {"end": int(end) if not return_seconds else round(end / it.sampling_rate, 1)}
            if r is not None:
                events.append(r)
        return events

    def close(self) -> None:
        if self.lane is not None:
            self.scheduler.release(self.lane)
            self.lane = None
