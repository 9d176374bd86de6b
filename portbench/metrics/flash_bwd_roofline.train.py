"""The flash kernels of training (the forward with log-sum-exp, K3, on the
forward body it shares with K1 and K6; K4 dK/dV; K5 dQ) against their
roofline in a traced session: their launches' summed least time over their
summed device time, in percent."""

from portbench.readings import roofline


def read(ctx):
    return roofline(ctx, "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
