"""The flash forward kernel's share of its roofline in a traced batch: the
least time of its launches (K1, and K3 or K6 should generation route
attention there; ``portbench/counts/kernels.py`` at each launch's shape)
over their device time, in percent."""

from portbench.readings import roofline


def read(ctx):
    return roofline(ctx, "flash_fwd")
