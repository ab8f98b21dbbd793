"""The card's milliseconds a traced step in the discriminators' update,
the trainers' ``train.d_update`` spans (moves train_samples_per_s)."""

from benchlib import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, ("train.d_update",))
