"""The serving engine's share of the card's dense f32 peak under open-loop
tiles: the answered images' forward operations over the device's busy
time in the traced slice (moves serve_p95_ms)."""

from benchlib import readers


def read(ctx):
    return readers.engine_mfu(ctx)
