"""Device ms of one training step (VAE encode, text tower, UNet forward and
backward, clip, AdamW): the kernel time launched inside the steps of a
traced session, per step; reported when the flash kernels' records match
their launches."""

from portbench.readings import checked, range_per_call


def read(ctx):
    if not checked(ctx, "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        return None
    s = range_per_call(ctx, ["train_step"], "device_s", per="train_step")
    return None if s is None else 1e3 * s
