"""The reflect pads' share of their roofline over a training step: the
bytes of every site's forward and backward at the card's bandwidth over
the traced time of ATen's reflection_pad2d forward and K6 (moves
train_samples_per_s)."""

from benchlib import readers


def read(ctx):
    return readers.roofline(ctx, readers.train_work(ctx).pad_bytes, ("reflect pad", "reflect_pad_bwd (K6)"))
