"""Kernel records launched inside one UNet step of a traced batch;
reported when the flash forward kernel's records match its launches."""

from portbench.readings import checked, range_per_call


def read(ctx):
    return range_per_call(ctx, ["unet"], "records", per="unet") if checked(ctx, "flash_fwd") else None
