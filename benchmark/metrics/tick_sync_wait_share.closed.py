"""Share of the window's ``sched.tick`` seconds (the worker's call of
``run_tick_batch``) that the host spent waiting on the card: the decode
loop's reads of its active lanes (``step.sync``), the chunked anchor's lane
read (``anchor.sync``) and the reads of the packed outputs (``fetch.*``).
Near 0 the card waits on the host's launches; near 100 the host waits on
the card. From the program's tracer (``stats()["trace"]``, always on,
zeroed at the window's start); nothing from a program without it."""

SYNC = ("step.sync", "anchor.sync")


def read(ctx):
    spans = (ctx.window.stats.get("trace") or {}).get("spans", {})
    tick = spans.get("sched.tick", (0, 0.0, 0))[1]
    if not tick:
        return None
    wait = sum(v[1] for k, v in spans.items() if k in SYNC or k.startswith("fetch."))
    return 100.0 * wait / tick
