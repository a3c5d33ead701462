"""Idle per cent of the device over traced teacher epochs."""

from gnnbench import readers


def read(ctx):
    return readers.idle_share(ctx, "train")
