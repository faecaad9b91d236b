"""Seconds from the process's start to the window's start: imports, the
weights, the engine and the scheduler's warm pass, the audio, the first
ticks and the warm-up."""


def read(ctx):
    return ctx.setup_s
