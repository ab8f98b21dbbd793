"""The card's milliseconds a traced step in the generators' reads and
update: the paired trainer's ``train.g_forward`` and ``train.g_update``
spans, the cycle trainer's ``train.g_update`` (moves
train_samples_per_s)."""

from benchlib import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, ("train.g_forward", "train.g_update"))
