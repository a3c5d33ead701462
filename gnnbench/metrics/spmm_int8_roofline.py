"""spmm_csr_int8's share of its roofline: the int8 eval's hops (all their
launches, hub combine passes included)."""

from gnnbench import readers


def read(ctx):
    return readers.roofline(ctx, "spmm_csr_int8")
