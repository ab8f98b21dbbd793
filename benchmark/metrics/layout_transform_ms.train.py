"""Device milliseconds a traced step in cuDNN's NCHW/NHWC layout
transforms (moves train_samples_per_s)."""

from benchlib import readers


def read(ctx):
    return readers.device_ms_per_step(ctx, "cuDNN layout transform")
