"""Evaluation metrics: CLAP similarity and Kernel Audio Distance (port of
audioldm_tpu/eval/metrics.py), in fp32 on the device of their inputs.

- CLAP score: the cosine of L2-normalised CLAP audio and text embeddings
  mapped to [0, 1] by ``(s + 1) / 2`` (train_audioldm_lora.py:128-137 of the
  reference).
- KAD: the unbiased MMD^2 between two sets of CLAP audio embeddings with a
  gaussian, iq or imq kernel, its bandwidth the median pairwise distance of
  the *generated* set, 1.0 when that is NaN or under 1e-6, scaled x100
  (train_audioldm_lora.py:234-294, SCALE_FACTOR at :71).
"""

from __future__ import annotations

from typing import Optional

import torch

SCALE_FACTOR = 100.0


def clap_similarity(audio_embed: torch.Tensor, text_embed: torch.Tensor) -> torch.Tensor:
    """``(cos(a, t) + 1) / 2`` over the last axis; inputs ``[D]`` or ``[B,
    D]``, normalised or not."""
    a = audio_embed / torch.linalg.norm(audio_embed, dim=-1, keepdim=True)
    t = text_embed / torch.linalg.norm(text_embed, dim=-1, keepdim=True)
    return ((a * t).sum(dim=-1) + 1.0) / 2.0


def median_pairwise_distance(
    x: torch.Tensor, subsample: Optional[int] = None, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """The median euclidean distance over the strict upper triangle
    (``torch.median(torch.pdist(x))``: the lower of the two middle values).
    With ``subsample`` below the number of pairs (the reference's branch for
    large sets): the median over ``subsample`` random pairs drawn from
    ``generator`` (on ``x``'s device), a self-pair moved to the next row."""
    x = x.float()
    n = x.shape[0]
    if subsample is not None and subsample < n * (n - 1) / 2:
        idx1 = torch.randint(0, n, (subsample,), generator=generator, device=x.device)
        idx2 = torch.randint(0, n, (subsample,), generator=generator, device=x.device)
        idx2 = torch.where(idx1 == idx2, (idx2 + 1) % n, idx2)
        d = torch.sqrt(((x[idx1] - x[idx2]) ** 2).sum(dim=1))
    else:
        sq = (x * x).sum(dim=1)
        d = torch.sqrt(torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), min=0.0))
        iu = torch.triu_indices(n, n, offset=1, device=x.device)
        d = d[iu[0], iu[1]]
    pair = torch.sort(d).values
    return pair[(pair.shape[0] - 1) // 2]


def _kernel(name: str, d2: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    if name == "gaussian":
        return torch.exp(-gamma * d2)
    if name == "iq":
        return 1.0 / (1.0 + gamma * d2)
    if name == "imq":
        return 1.0 / torch.sqrt(1.0 + gamma * d2)
    raise ValueError(f"invalid kernel: {name}")


def kernel_audio_distance(x: torch.Tensor, y: torch.Tensor, kernel: str = "gaussian") -> torch.Tensor:
    """Unbiased ``MMD^2(x, y) * 100`` with the bandwidth from ``y`` (the
    reference calls ``calc_kernel_audio_distance(ref, gen)``, so it comes
    from the generated set; callers keep that order, ``kad(ref, gen)``).
    Raises on fewer than 2 embeddings in a set: the estimator divides by
    ``n * (n - 1)``."""
    x, y = x.float(), y.float()
    if x.shape[0] < 2 or y.shape[0] < 2:
        raise ValueError(f"KAD needs >= 2 embeddings per set, got {x.shape[0]} vs {y.shape[0]} "
                         "(add more clips to the smaller corpus)")
    bw = median_pairwise_distance(y)
    bw = torch.where(torch.isnan(bw) | (bw < 1e-6), torch.ones_like(bw), bw)
    gamma = 1.0 / (2.0 * bw**2 + 1e-8)

    def sq_dists(a, b):
        return (a * a).sum(dim=1)[:, None] + (b * b).sum(dim=1)[None, :] - 2.0 * (a @ b.T)

    def within(a):  # the mean kernel value off the diagonal
        k = _kernel(kernel, sq_dists(a, a), gamma)
        k = k - torch.diag(torch.diag(k))
        return k.sum() / (a.shape[0] * (a.shape[0] - 1))

    return (within(x) + within(y) - 2.0 * _kernel(kernel, sq_dists(x, y), gamma).mean()) * SCALE_FACTOR
