"""spmm_csr_weighted's share of its roofline: APPNP's weighted hops, both
walks (all their launches, hub combine passes included)."""

from gnnbench import readers


def read(ctx):
    return readers.roofline(ctx, "spmm_csr_weighted")
