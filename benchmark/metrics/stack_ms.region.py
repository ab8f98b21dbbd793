"""The micro-batcher's host stack a batch under the closed-loop region:
the mean of the program's ``serve.stack`` spans in the traced slice
(moves serve_images_per_s)."""

from benchlib import spans


def read(ctx):
    return spans.mean_ms(ctx, "serve.stack")
