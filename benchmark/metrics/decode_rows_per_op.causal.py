"""Sessions' rows per pooled decode op in the window (the ``causal.decode``
span's lanes over its count): how fully the op batcher packs the closed
loop's groups into one decode. From the program's tracer
(``stats()["trace"]``); nothing from a program without the span."""


def read(ctx):
    n, _, lanes = (ctx.window.stats.get("trace") or {}).get("spans", {}).get("causal.decode", (0, 0.0, 0))
    return lanes / n if n else None
