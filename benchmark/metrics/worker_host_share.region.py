"""The share of the traced slice the micro-batcher's worker spends on the
host with nothing of the engine's on the card, under the closed-loop
region: its ``serve.fill`` (a batch's gather from its head on),
``serve.stack`` and ``serve.deliver`` spans over the slice, in percent
(moves serve_images_per_s).  The wait for a batch's head is the load's,
and is left out."""

from benchlib import spans


def read(ctx):
    return spans.worker_host_share(ctx)
