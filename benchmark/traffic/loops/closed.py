"""A closed, saturated loop: slots of sessions, ``lane_groups`` times the
scheduler's lane cap. A session gets its next ``chunk_s`` of audio as soon
as its previous tick returns. Its first tick holds ``first_chunk_s`` of
audio, spread linearly over the slots.

With ``session_s`` (a list of lengths in whole seconds) a session lasts
one of those lengths, ends with its final flush and is replaced at once
by a fresh one in its slot; every slot cycles through the same lengths,
in an order drawn from the plan's seed.

Warmed up, and the window opens, once every slot has run ``warm_ticks``
ticks after its first or, with ``session_s``, once every slot's first
session has been flushed and replaced: by then the first-tick anchor, the
inc ticks and the flush have all run.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np

from lib.audio import SR
from lib.drive import Window, close_window, plan_seed, slot_voice, trace_after, voices_for, wait_until


def plan(traffic: dict, seed: int, n_slots: int):
    """(slot order, first-tick seconds by slot, session lengths by slot or
    None): every seed gets the same sizes, in an order drawn from the
    plan's seed."""
    rng = np.random.default_rng([plan_seed(traffic, seed), 7])
    perm = rng.permutation(n_slots)
    lo, hi = traffic["first_chunk_s"]
    first = [lo + (hi - lo) * j / n_slots for j in range(n_slots)]
    lives = traffic.get("session_s")
    orders = [list(rng.permutation(lives)) for _ in range(n_slots)] if lives else None
    return perm, first, orders


async def run(system, traffic: dict, seed: int, seconds: float, trace=None, sessions=None) -> Window:
    rec = system.recorder
    n_slots = int(traffic["lane_groups"] * system.lanes)
    perm, first, orders = plan(traffic, seed, n_slots)
    voices = voices_for(traffic, seed)
    chunk = int(round(traffic["chunk_s"] * SR))
    warm_ticks = int(traffic.get("warm_ticks", 2))
    win = Window(sessions=n_slots)
    stop = asyncio.Event()
    done_ticks = [0] * n_slots
    instances = [0] * n_slots
    next_sid = [0]

    async def slot(j: int) -> None:
        voice, start = slot_voice(j, perm, voices)
        base = 0
        while not stop.is_set():
            sid = next_sid[0]
            next_sid[0] += 1
            proc = system.new_session()
            fed = [0]
            rec.attach(proc, sid, lambda f=fed: f[0])
            win.streams[sid] = (voice, (start + base) % voices.length)
            life = None
            if orders is not None:
                life = int(orders[j][instances[j] % len(orders[j])] * SR)

            def feed(n: int) -> None:
                proc.insert_audio_chunk(voices.read(voice, start + base, fed[0], fed[0] + n),
                                        (fed[0] + n) / SR)
                fed[0] += n

            n0 = int(round(first[j] * SR)) if instances[j] == 0 else chunk
            feed(min(n0, life) if life else n0)
            await proc.process_iter_async()
            done_ticks[j] += 1
            while not stop.is_set():
                if life is not None and fed[0] >= life:
                    await proc.finish_async()
                    proc.close()
                    break
                feed(min(chunk, life - fed[0]) if life else chunk)
                await proc.process_iter_async()
                done_ticks[j] += 1
            base += fed[0]
            instances[j] += 1
            if life is None:
                return

    def warmed() -> bool:
        if orders:
            return all(n >= 1 for n in instances)
        return all(n >= 1 + warm_ticks for n in done_ticks)

    tasks = [asyncio.create_task(slot(j)) for j in range(n_slots)]
    await wait_until(warmed, tasks)
    win.w0 = time.perf_counter()
    system.scheduler.reset_stats()
    await asyncio.sleep(seconds)
    close_window(win, system)
    await trace_after(win, trace, traffic.get("trace_s", 8.0))
    stop.set()
    await asyncio.gather(*tasks)
    return win
