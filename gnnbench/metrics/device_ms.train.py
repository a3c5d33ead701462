"""Device-busy ms per traced teacher epoch: the device's share of the
epoch, without the host's launch path, which moves from run to run."""

from gnnbench import readers


def read(ctx):
    return readers.device_ms(ctx, "train")
