"""Host ms of the teacher runner's intermediate eval (with its metrics row)."""

from gnnbench import readers


def read(ctx):
    return readers.mean_ms(ctx, "teacher_epochs", "eval")
