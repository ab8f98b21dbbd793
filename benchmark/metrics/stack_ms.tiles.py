"""The micro-batcher's host stack and zero-pad a batch under open-loop
tiles: the mean of the program's ``serve.stack`` spans in the traced
slice (moves serve_p95_ms)."""

from benchlib import spans


def read(ctx):
    return spans.mean_ms(ctx, "serve.stack")
