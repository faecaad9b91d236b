"""An open loop: ``sessions`` live streams, each fed ``chunk_s`` chunks on
the wall clock at ``speed`` times real time, their starts spread evenly
over one chunk in an order drawn from the plan's seed. Each session calls
the policy as the session pipeline does: whenever audio is queued and its
previous call has returned, with everything queued. The window opens
``warm_s`` seconds after the first start.
"""

from __future__ import annotations

import asyncio
import heapq
import time
from typing import List

import numpy as np

from lib.audio import SR
from lib.drive import Window, close_window, plan_seed, slot_voice, trace_after, voices_for


def plan(traffic: dict, seed: int, n: int):
    """(slot order, start offsets in seconds): the starts spread evenly over
    one chunk, in an order drawn from the plan's seed."""
    perm = np.random.default_rng([plan_seed(traffic, seed), 7]).permutation(n)
    return perm, [float(perm[j]) * float(traffic["chunk_s"]) / n / float(traffic["speed"]) for j in range(n)]


async def run(system, traffic: dict, seed: int, seconds: float, trace=None, sessions=None) -> Window:
    rec = system.recorder
    n = int(sessions or traffic["sessions"])
    perm, offsets = plan(traffic, seed, n)
    voices = voices_for(traffic, seed)
    chunk_s, speed = float(traffic["chunk_s"]), float(traffic["speed"])
    chunk = int(round(chunk_s * SR))
    win = Window(sessions=n)
    stop = asyncio.Event()
    t_start = time.perf_counter() + 0.2
    t0 = [t_start + o for o in offsets]
    queued: List[List[np.ndarray]] = [[] for _ in range(n)]
    ready = [asyncio.Event() for _ in range(n)]

    async def feeder() -> None:
        heap = [(t0[j] + chunk_s / speed, j, 0) for j in range(n)]
        heapq.heapify(heap)
        while not stop.is_set():
            due, j, i = heap[0]
            wait = due - time.perf_counter()
            if wait > 0:
                await asyncio.sleep(wait)
                continue
            heapq.heappop(heap)
            win.feeder_late_s = max(win.feeder_late_s, -wait)
            voice, start = win.streams[j]
            queued[j].append(voices.read(voice, start, i * chunk, (i + 1) * chunk))
            ready[j].set()
            heapq.heappush(heap, (t0[j] + (i + 2) * chunk_s / speed, j, i + 1))

    async def session(j: int) -> None:
        proc = system.new_session()
        fed = [0]
        rec.attach(proc, j, lambda: fed[0], due=lambda s: t0[j] + s / SR / speed)
        while not stop.is_set():
            await ready[j].wait()
            ready[j].clear()
            if stop.is_set():
                break
            audio = np.concatenate(queued[j])
            queued[j].clear()
            fed[0] += len(audio)
            proc.insert_audio_chunk(audio, fed[0] / SR)
            await proc.process_iter_async()

    for j in range(n):
        win.streams[j] = slot_voice(j, perm, voices)
    tasks = [asyncio.create_task(session(j)) for j in range(n)]
    feed_task = asyncio.create_task(feeder())
    await asyncio.sleep(max(0.0, t_start + float(traffic["warm_s"]) - time.perf_counter()))
    win.w0 = time.perf_counter()
    system.scheduler.reset_stats()
    await asyncio.sleep(seconds)
    close_window(win, system)
    await trace_after(win, trace, traffic.get("trace_s", 8.0))
    stop.set()
    for e in ready:
        e.set()
    await asyncio.gather(*tasks)
    await feed_task
    return win
