"""gat_fwd's share of its roofline (all its launches, hub passes included)."""

from gnnbench import readers


def read(ctx):
    return readers.roofline(ctx, "gat_fwd")
