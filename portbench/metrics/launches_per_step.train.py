"""Kernel records launched inside one training step of a traced session;
reported when the flash kernels' records match their launches."""

from portbench.readings import checked, range_per_call


def read(ctx):
    ok = checked(ctx, "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
    return range_per_call(ctx, ["train_step"], "records", per="train_step") if ok else None
