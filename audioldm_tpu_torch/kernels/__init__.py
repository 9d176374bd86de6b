"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: K1 ``flash_attention.flash_attention`` and K2 ``mrf_conv.mrf_stage``."""

from audioldm_tpu_torch.kernels import flash_attention, mrf_conv

__all__ = ["flash_attention", "mrf_conv", "launch_counts", "reset_launches"]


def launch_counts() -> dict:
    """Kernel launches since the last ``reset_launches``: for each kernel, a
    dict from variant (dtype and shape, see each wrapper) to launches."""
    return {"flash_fwd": dict(flash_attention.flash_attention.launches), "mrf_stage": dict(mrf_conv.mrf_stage.launches)}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    flash_attention.flash_attention.launches.clear()
    mrf_conv.mrf_stage.launches.clear()
