"""Teacher epochs' counted FLOPs over the f32 peak."""

from gnnbench import readers


def read(ctx):
    return readers.mfu(ctx, "train")
