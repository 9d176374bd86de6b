"""Device ms of a batch's VAE decode and vocoder: the kernel time launched
inside them in a traced batch; reported when K2's records match its
launches."""

from portbench.readings import checked, range_per_call


def read(ctx):
    if not checked(ctx, "mrf"):
        return None
    s = range_per_call(ctx, ["decode", "vocoder"], "device_s")
    return None if s is None else 1e3 * s
