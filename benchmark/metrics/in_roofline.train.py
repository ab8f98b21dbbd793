"""The instance norms' share of their roofline over a training step: the
bytes of every site's forward and backward at the card's bandwidth over
the traced time of the kernels that compute them, K1 and K2 (moves
train_samples_per_s)."""

from benchlib import readers


def read(ctx):
    return readers.roofline(ctx, readers.train_work(ctx).in_bytes, ("in_act (K1)", "in_bwd (K2)"))
