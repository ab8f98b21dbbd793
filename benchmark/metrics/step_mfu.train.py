"""The whole training step's share of the card's dense peak in the compute
dtype: the benchmark's operations of every step of the window over the
window's length, the traced slice left out (moves train_samples_per_s)."""

from benchlib import readers


def read(ctx):
    return readers.step_mfu(ctx)
