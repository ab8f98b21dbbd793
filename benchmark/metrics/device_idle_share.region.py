"""The share of the traced slice in which nothing ran on the card, in
percent."""

from benchlib import readers


def read(ctx):
    return readers.idle_share(ctx)
