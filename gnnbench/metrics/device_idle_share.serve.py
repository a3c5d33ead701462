"""Idle per cent of the device over traced requests."""

from gnnbench import readers


def read(ctx):
    return readers.idle_share(ctx, "serve")
