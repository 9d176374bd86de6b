"""Inputs made from the seed: prompt token rows, request seeds, log-mel
batches, adapters. The same seed gives the same inputs; every seed gives
inputs of the same sizes, so the work of a run does not depend on it."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.models import Attention


def prompt_table(text_cfg: dict, seed: int, rows: int, min_len: int, max_len: int, length: int = 512):
    """``rows`` distinct prompts as RoBERTa token rows ``<s> ids </s>`` padded
    to ``length``, their token counts uniform in ``[min_len, max_len]``,
    and the empty prompt. Returns ``(ids, mask, uncond_ids, uncond_mask)``,
    int32 numpy arrays."""
    rng = np.random.default_rng([int(seed), 1])
    bos, eos, pad = text_cfg["bos_token_id"], text_cfg["eos_token_id"], text_cfg["pad_token_id"]
    lo = max(bos, eos, pad) + 1
    lens = rng.integers(min_len, max_len + 1, size=rows)
    ids = np.full((rows, length), pad, np.int32)
    mask = np.zeros((rows, length), np.int32)
    body = rng.integers(lo, text_cfg["vocab_size"], size=(rows, length - 2), dtype=np.int32)
    for i, n in enumerate(lens):
        ids[i, 0], ids[i, 1 : n + 1], ids[i, n + 1] = bos, body[i, :n], eos
        mask[i, : n + 2] = 1
    uids = np.full((1, length), pad, np.int32)
    uids[0, :2] = (bos, eos)
    umask = np.zeros((1, length), np.int32)
    umask[0, :2] = 1
    return ids, mask, uids, umask


def request_seed(seed: int, row: int) -> int:
    """The seed of request ``row``'s initial latents."""
    return int(np.random.SeedSequence([int(seed), 2, int(row)]).generate_state(1, dtype=np.uint32)[0])


def mel_batches(seed: int, count: int, batch: int, frames: int, bins: int, device) -> list:
    """``count`` batches of log-mels ``[batch, 1, frames, bins]`` drawn on
    ``device``: N(-5, 2), the range of a real clip's log-mel."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 3)
    mel = torch.randn((count * batch, 1, frames, bins), generator=gen, device=device).mul_(2.0).sub_(5.0)
    return list(mel.split(batch))


def lora_paths(unet_model: torch.nn.Module, targets) -> list:
    """``(path, in, out)`` of every attention projection named in
    ``targets``, in module order."""
    out = []
    for name, m in unet_model.named_modules():
        if isinstance(m, Attention):
            for proj in targets:
                lin = getattr(m, proj)
                out.append((f"{name}.{proj}", lin.in_features, lin.out_features))
    return out


def adapters(paths: list, rank: int, b_std: float, seed: int, device) -> dict:
    """``{path: (A [in, r], B [r, out])}`` in float32: A ~ N(0, 1/r^2) (the
    peft ``gaussian`` rule), B ~ N(0, b_std^2) (B = 0 at ``b_std`` 0: a fresh
    adapter), drawn on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 4)
    out = {}
    for path, din, dout in paths:
        a = torch.randn((din, rank), generator=gen, device=device) / rank
        b = torch.randn((rank, dout), generator=gen, device=device) * b_std
        out[path] = (a, b)
    return out
