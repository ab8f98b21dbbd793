"""The micro-batcher's occupancy under open-loop tiles: the slots its
batches filled over the slots they had, over the window, from the
frontend's ``stats()`` (moves serve_p95_ms)."""


def read(ctx):
    w = ctx.window
    if not w.get("batches"):
        return None
    return 100.0 * w["slots"] / (w["batches"] * w["batch_size"])
