"""Host ms of the teacher runner's train-epoch call."""

from gnnbench import readers


def read(ctx):
    return readers.mean_ms(ctx, "teacher_epochs", "train")
