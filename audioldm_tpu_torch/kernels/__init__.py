"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: K1 ``flash_attention.flash_attention`` (inference forward; K6, its
one-pass form for a single kv block, behind ``set_one_pass``), K3
``flash_attention.flash_fwd_lse``, K4 ``flash_attention.flash_bwd_dkv`` and K5
``flash_attention.flash_bwd_dq`` (the training forward and backward), K2
``mrf_conv.mrf_stage``, and the attention bench tool's diagnostic kernels K7
``attn_diag.diag_loop``, K8 ``attn_diag.fori_exp2``, K9 ``attn_diag.grid3``
and K10 ``attn_diag.grid3b``."""

from audioldm_tpu_torch.kernels import attn_diag, flash_attention, mrf_conv

__all__ = ["attn_diag", "flash_attention", "mrf_conv", "launch_counts", "reset_launches"]


def _counters() -> dict:
    fa = flash_attention
    return {
        "flash_fwd": fa.flash_attention.launches,
        "flash_fwd_one": fa.flash_attention.launches_one,
        "flash_fwd_lse": fa.flash_fwd_lse.launches,
        "flash_bwd_dkv": fa.flash_bwd_dkv.launches,
        "flash_bwd_dq": fa.flash_bwd_dq.launches,
        "mrf_stage": mrf_conv.mrf_stage.launches,
        "diag_loop": attn_diag.diag_loop.launches,
        "fori_exp2": attn_diag.fori_exp2.launches,
        "grid3": attn_diag.grid3.launches,
        "grid3b": attn_diag.grid3b.launches,
    }


def launch_counts() -> dict:
    """Kernel launches since the last ``reset_launches``: for each kernel, a
    dict from variant (dtype and shape, see each wrapper) to launches."""
    return {name: dict(c) for name, c in _counters().items()}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for c in _counters().values():
        c.clear()
