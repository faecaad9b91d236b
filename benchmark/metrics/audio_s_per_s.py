"""Seconds of audio the sessions advanced inside the window, over the
window's seconds: the real-time streams one card serves.

Each tick's audio is spread over its session's cycle, from the session's
previous result to its own (``lib.context.audio_rate``). Every second of
every session is in some cycle, so a stall anywhere in the window lowers
the rate; counting only the ticks that complete inside the window would
instead move the rate by a whole group tick (24 lanes at large-v3, about
4 % of a 30 s window) with where the window's edges happen to fall."""

from lib.context import audio_rate


def read(ctx):
    return audio_rate(ctx.records, ctx.window.w0, ctx.window.w1)
