"""K2 against the plain resblock path on the real vocoder geometry (the
port's copy of the repo's ``tools/bench_vocoder_mrf.py``): mel ``[B, 1024,
64]`` -> 163 840 samples a clip, audioldm-s's HiFi-GAN with random weights
from seed 0, fp32.

    python -m audioldm_tpu_torch.tools.bench_vocoder_mrf [--batch 1] [--device cuda]

Prints one JSON line a variant, as the JAX tool does: the whole vocoder
with its two late stages through ``kernels/mrf_conv.py mrf_stage`` (K2; the
last with conv_post and tanh fused) and with every stage through
``mrf_stage_plain`` (``F.conv1d``), with the stages that K2 ran
(``routed_stages``); then each late stage alone, K2 against the plain
version on the same random input at that stage's shape. Each time is the
median of single calls on the host clock between two synchronisations after
warm-up calls (``benchkit.median_s``), where the JAX tool takes the slope
between two loop lengths inside one jit. Its ``--block-t`` and
``--max-channels`` are TPU knobs (the kernel's time block in VMEM, the
routing gate) with no counterpart: the CUDA kernel tiles its own samples
and K2 takes what ``mrf_conv.supported`` says.

``bench`` takes ``device="cpu"`` and a vocoder of any width, so that a test
can drive it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from audioldm_tpu_torch.config import VocoderConfig
from audioldm_tpu_torch.kernels import mrf_conv
from audioldm_tpu_torch.models.vocoder import SpeechT5HifiGan
from audioldm_tpu_torch.pipeline.generate import init_random_
from audioldm_tpu_torch.tools.benchkit import card, median_s, need_device

FRAMES = 1024  # mel frames of a 10.24 s clip


@contextlib.contextmanager
def plain_stages(vocoder: SpeechT5HifiGan):
    """Every stage of ``vocoder`` through ``mrf_stage_plain`` (no K2)."""
    vocoder.route_from = lambda t: None
    try:
        yield
    finally:
        del vocoder.route_from


def k2_launches() -> int:
    return sum(mrf_conv.mrf_stage.launches.values())


def late_stages(vocoder: SpeechT5HifiGan, frames: int = FRAMES):
    """``(index, channels, samples)`` of each stage that K2 runs at
    ``frames`` mel frames (the vocoder's own routing)."""
    route = vocoder.route_from(frames)
    if route is None:
        return []
    lens = vocoder.stage_lengths(frames)
    c0 = vocoder.cfg.upsample_initial_channel
    return [(i, c0 // 2 ** (i + 1), lens[i]) for i in range(route, len(lens))]


def bench(vocoder: SpeechT5HifiGan | None = None, batch: int = 1, device: str = "cuda", frames: int = FRAMES,
          warm: int = 3, timed: int = 10) -> list:
    """The whole vocoder with and without K2, then each late stage alone;
    one JSON line a record. The weights are made outside inference mode,
    so that K2's wrapper keeps them packed: weights made under it are
    inference tensors, which it repacks every call, and the fused route's
    time would be the repack's as much as the kernel's."""
    need_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    if vocoder is None:
        with torch.device(device):
            vocoder = init_random_(SpeechT5HifiGan(VocoderConfig()), gen).eval()
    with torch.inference_mode():
        return _bench(vocoder, batch, device, frames, warm, timed, gen)


def _bench(vocoder, batch, device, frames, warm, timed, gen) -> list:
    mel = torch.randn(batch, frames, vocoder.cfg.model_in_dim, device=device, generator=gen)
    recs, name = [], card(torch.device(device).type)
    for routed in (False, True):
        with contextlib.nullcontext() if routed else plain_stages(vocoder):
            before = k2_launches()
            wav = vocoder(mel)
            launched = k2_launches() - before
            s = median_s(lambda _: vocoder(mel), warm, timed, device)
        recs.append({"variant": "fused_mrf" if routed else "plain", "batch": batch, "ms": s * 1e3,
                     "routed_stages": launched, "finite": bool(torch.isfinite(wav).all())})
    nk = len(vocoder.cfg.resblock_kernel_sizes)
    kd = (vocoder.cfg.resblock_kernel_sizes, vocoder.cfg.resblock_dilation_sizes, vocoder.cfg.leaky_relu_slope)
    stages = late_stages(vocoder, frames)
    for i, c, t in stages:
        x = torch.randn(batch, c, t, device=device, generator=gen)
        blocks = list(vocoder.resblocks[i * nk : (i + 1) * nk])
        post = vocoder.conv_post if i == len(vocoder.upsampler) - 1 else None
        for fused, fn in ((False, mrf_conv.mrf_stage_plain), (True, mrf_conv.mrf_stage)):
            s = median_s(lambda _: fn(x, blocks, *kd, post=post), warm, timed, device)
            recs.append({"variant": f"stage{i} {'fused_mrf' if fused else 'plain'}", "batch": batch, "shape": [batch, c, t],
                         "post": post is not None, "ms": s * 1e3})
    if not any(r["routed_stages"] for r in recs[:2]) and stages:
        recs[1]["warning"] = "K2 did not route: the timing is the plain path"
    for r in recs:
        print(json.dumps({"tool": "bench_vocoder_mrf", "card": name, **r}), flush=True)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_vocoder_mrf: no CUDA GPU available", file=sys.stderr)
        return 1
    bench(batch=args.batch, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
