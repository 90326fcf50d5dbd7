"""Kernel ``fragscore``: share of its roofline (``kernels/fragscore.py``'s
counts at the cell's shapes over its device time), in %."""

from portbench.kernels import fragscore as kernel, roofline


def read(ctx):
    return roofline(kernel, ctx)
