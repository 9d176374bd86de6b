"""Device ms of one CFG-folded UNet step: the kernel time launched inside
the UNet's calls of a traced batch, per call; reported when the flash
forward kernel's records match its launches."""

from portbench.readings import checked, range_per_call


def read(ctx):
    if not checked(ctx, "flash_fwd"):
        return None
    s = range_per_call(ctx, ["unet"], "device_s", per="unet")
    return None if s is None else 1e3 * s
