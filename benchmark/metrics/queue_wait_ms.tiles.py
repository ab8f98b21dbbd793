"""The 90th percentile of a request's wait in the micro-batcher's queue
under open-loop tiles, from its submit to the start of the batch that took
it (the program's ``serve.queue`` spans of the requests submitted in the
traced slice; moves serve_p95_ms)."""

from benchlib import spans


def read(ctx):
    return spans.percentile_ms(ctx, "serve.queue", 90.0)
