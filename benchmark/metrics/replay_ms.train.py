"""The card's milliseconds a traced step in the cycle trainer's replay
buffers, its ``train.replay`` spans (moves train_samples_per_s)."""

from benchlib import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, ("train.replay",))
