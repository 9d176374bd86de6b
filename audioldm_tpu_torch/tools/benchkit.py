"""What the port's full-width tools share: the JAX tools' stand-in
tokenizer and prompt rows, a median timer, and one JSON line of results
with the card's name and power limit.

JAX's tools time device-pure loops inside one jit by the slope between two
loop lengths. PyTorch runs eagerly, so the port's tools time each call on
the host clock between two ``torch.cuda.synchronize()`` after warm-up calls
and report the median (``median_s``); the launch gaps between kernels are
part of such a time, as they are of what a user waits for.
"""

from __future__ import annotations

import json
import statistics
import time

import numpy as np
import torch

from audioldm_tpu_torch.config import ClapTextConfig, UNetConfig, VAEConfig, VocoderConfig
from audioldm_tpu_torch.tools.bench_attn import card, need_device

__all__ = ["SECONDS", "TINY", "Tok", "card", "device_ms_per_call", "first_then_median", "median_s", "need_device", "prompt_rows", "report", "sync"]

SECONDS = 10.24  # the flagship clip

# the tools' tiny widths (``--width tiny``), the repo's tests/test_pipeline.py geometry
TINY = dict(
    text_cfg=ClapTextConfig(vocab_size=64, hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                            intermediate_size=32, max_position_embeddings=40, projection_dim=8),
    unet_cfg=UNetConfig(in_channels=4, out_channels=4, block_out_channels=(8, 16),
                        down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                        up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1, norm_num_groups=4,
                        attention_head_dim=2, projection_class_embeddings_input_dim=8),
    vae_cfg=VAEConfig(in_channels=1, out_channels=1, block_out_channels=(8, 16), layers_per_block=1, latent_channels=4,
                      norm_num_groups=4, scaling_factor=0.9),
    vocoder_cfg=VocoderConfig(model_in_dim=8, upsample_initial_channel=16, upsample_rates=(2, 2),
                              upsample_kernel_sizes=(4, 4), resblock_kernel_sizes=(3,),
                              resblock_dilation_sizes=((1, 3),), sampling_rate=16000),
)


class Tok:
    """The JAX tool's stand-in tokenizer: 512 ids a row (``length``), one id
    a word."""

    def __init__(self, length: int = 512):
        self.length = length

    def __call__(self, texts, max_length=None):
        n = self.length
        ids = np.full((len(texts), n), 1, np.int32)
        mask = np.zeros((len(texts), n), np.int32)
        for i, t in enumerate(texts):
            toks = [0] + [5 + (sum(map(ord, w)) % 40) for w in t.split()] + [2]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def prompt_rows(batch: int = 1, length: int = 512):
    """The JAX tools' fixed rows: ids 5 after a 0, every position attended;
    the unconditional row ids 1 after a 0, only the first attended."""
    ids = np.full((batch, length), 5, np.int32)
    ids[:, 0] = 0
    u_ids = np.full((1, length), 1, np.int32)
    u_ids[:, 0] = 0
    u_mask = np.zeros((1, length), np.int32)
    u_mask[:, 0] = 1
    return ids, np.ones((batch, length), np.int32), u_ids, u_mask


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def median_s(run, warm: int, timed: int, device) -> float:
    """Median seconds of ``timed`` calls of ``run(i)`` after ``warm`` ones,
    each between two synchronisations of the device."""
    for i in range(warm):
        run(i)
    times = []
    for i in range(timed):
        sync(device)
        t0 = time.perf_counter()
        run(warm + i)
        sync(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def first_then_median(run, warm: int, timed: int, device) -> tuple[float, float]:
    """Seconds of the first call of ``run`` (cuDNN's and the kernels'
    first-use costs included), then ``median_s`` of the rest."""
    sync(device)
    t0 = time.perf_counter()
    run(0)
    sync(device)
    first = time.perf_counter() - t0
    return first, median_s(lambda i: run(i + 1), warm, timed, device)


def device_ms_per_call(fn, iters: int = 3) -> float | None:
    """The device's kernel time of one call of ``fn``: the profiler's
    summed CUDA kernel time over ``iters`` calls after a warm-up call,
    divided by ``iters``, with the host's launch gaps left out. None on a
    machine without a GPU, or when the profiler saw no device activity."""
    if not torch.cuda.is_available():
        return None
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA") and not getattr(e, "is_user_annotation", False))
    return us / iters / 1e3 if us else None


def report(tool: str, device, **fields) -> dict:
    """Print one JSON line ``{"tool", "card", **fields}`` and return it; on
    the CPU the card is ``"cpu"`` and times mean nothing of a device."""
    out = {"tool": tool, "card": card(torch.device(device).type), **fields}
    print(json.dumps(out), flush=True)
    return out
