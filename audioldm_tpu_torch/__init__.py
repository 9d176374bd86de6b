"""PyTorch/CUDA port of audioldm_tpu: text-to-audio generation on an NVIDIA
Hopper GPU, with hand-written CUDA kernels where the JAX package has Pallas
kernels. Imports torch, never jax."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default) needs a
    GPU and raises without one: the port never moves to the CPU by itself.
    The CPU runs only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA GPU is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
