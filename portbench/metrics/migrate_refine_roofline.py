"""Kernel ``migrate_refine``: share of its roofline (``kernels/migrate_refine.py``'s
counts at the cell's shapes over its device time), in %."""

from portbench.kernels import migrate_refine as kernel, roofline


def read(ctx):
    return roofline(kernel, ctx)
