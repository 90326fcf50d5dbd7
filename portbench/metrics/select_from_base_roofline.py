"""Kernel ``select_from_base``: share of its roofline (``kernels/select_from_base.py``'s
counts at the cell's shapes over its device time), in %."""

from portbench.kernels import select_from_base as kernel, roofline


def read(ctx):
    return roofline(kernel, ctx)
