"""K2's share of its roofline in a traced batch: the least time of its
launches (three TF32 products a tap) over their device time, in percent."""

from portbench.readings import roofline


def read(ctx):
    return roofline(ctx, "mrf")
