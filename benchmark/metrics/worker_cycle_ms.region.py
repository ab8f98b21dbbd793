"""The micro-batcher's worker cycle under the closed-loop region: the
window's milliseconds over the batches it completed in them, from the
frontend's ``stats()``, without the time the profiling took and its
batches; the worker is never idle in this cell (moves
serve_images_per_s)."""


def read(ctx):
    w, c = ctx.window, ctx.counters
    batches = w.get("batches", 0) - c.get("profiled_batches", 0)
    if batches <= 0:
        return None
    return 1e3 * (w["seconds"] - c.get("profiled_s", 0.0)) / batches
