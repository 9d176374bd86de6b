"""CLAP-space proximity of the fast sampling paths to DDIM 50 on the GPU
(the port's copy of the repo's ``tools/quality_proximity.py``).

    python -m audioldm_tpu_torch.tools.quality_proximity [--width full|tiny] [--seconds S] [--seed 0] [--device cuda]

Proximity, not quality: limited-interval guidance (``gi50``, DDIM 50 with
guidance on (0.05, 0.65)), DPM-Solver++ 25, LCM 4 and MultiDiffusion windows
of 5 s (``windowed``, DDIM 50) change the sampling math, and their claims of
preserved quality need the real weights. With fixed seeds and fixed random
weights (seed 0), whose vocoder gain is calibrated first
(``eval/proximity.py calibrate_vocoder_gain``), this measures how close each
fast path's clip stays to the DDIM 50 clip of the same seed: the cosine of
their CLAP audio embeddings (``eval/clap_features.py`` fused 48 kHz
features through ``models/clap_audio.py``'s HTSAT tower at the
``laion/clap-htsat-fused`` geometry, random weights from seed + 1: a fixed
feature map, not a trained judge) and the correlation of their log-mels
(``eval/proximity.py``). A different seed's DDIM 50 clip
(``anchor_diffseed``, seed + 1000) is published beside them: a fast path
that reads no nearer than it has lost the content. A tripwire for a change
that wrecks a fast path while its latency stays flat.

``--width tiny`` is the CPU-sized form (the repo's tiny test geometry, a
narrow CLAP tower that still takes the real 4 x 1001 x 64 fused features;
0.08 s, DDIM 6, dpm++ 3, lcm 2, windows of 0.04 s, fp32). ``--device``
replaces the JAX tool's ``--cpu``. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from audioldm_tpu_torch.config import ClapAudioConfig
from audioldm_tpu_torch.eval.clap_features import batch_fused_features
from audioldm_tpu_torch.eval.proximity import calibrate_vocoder_gain, embedding_cosine, mel_correlation
from audioldm_tpu_torch.models.clap_audio import ClapAudioModelWithProjection
from audioldm_tpu_torch.ops.resample import resample_np
from audioldm_tpu_torch.pipeline.generate import AudioLDMModules, generate, init_random_, latent_shape, random_modules
from audioldm_tpu_torch.tools.benchkit import TINY, need_device, prompt_rows, report

# the JAX tool's tiny CLAP tower: narrow, at the real fused-feature geometry (spec 256)
TINY_CLAP = ClapAudioConfig(window_size=4, num_mel_bins=64, spec_size=256, patch_size=4,
                            patch_embeds_hidden_size=4, depths=(1, 1), num_attention_heads=(1, 2), hidden_size=8,
                            projection_dim=8, enable_fusion=True, aff_block_r=4)
WIDTHS = {  # seconds, ddim steps, dpm++ steps, lcm steps, window seconds, dtype
    "full": (10.24, 50, 25, 4, 5.0, torch.bfloat16),
    "tiny": (0.08, 6, 3, 2, 0.04, torch.float32),
}


def paths(steps: int, dpm_steps: int, lcm_steps: int, window_s: float) -> dict:
    """The gauge's paths by name: ``generate``'s keyword arguments."""
    ddim = dict(num_inference_steps=steps, scheduler="ddim")
    return {
        "ddim50": ddim,
        "gi50": dict(ddim, guidance_interval=(0.05, 0.65)),
        f"dpmpp{dpm_steps}": dict(num_inference_steps=dpm_steps, scheduler="dpm++"),
        f"lcm{lcm_steps}": dict(num_inference_steps=lcm_steps, scheduler="lcm"),
        "windowed": dict(ddim, window_seconds=window_s),
    }


def clap_tower(cfg: ClapAudioConfig, seed: int, device) -> ClapAudioModelWithProjection:
    """A CLAP audio tower with random weights drawn from ``seed``, moved
    whole to ``device`` (its shift masks and position indices are buffers
    made from numpy)."""
    clap = ClapAudioModelWithProjection(cfg).to(device)
    return init_random_(clap, torch.Generator(device=device).manual_seed(seed)).eval()


@torch.inference_mode()
def embed(clap: ClapAudioModelWithProjection, wavs: list, sr: int, device) -> np.ndarray:
    """Unit-norm CLAP audio embeddings of 16 kHz clips (fused features at 48 kHz)."""
    feats, longer = batch_fused_features([resample_np(w, sr, 48000) for w in wavs], device=device)
    emb = clap(feats, longer)["audio_embeds"].double().cpu().numpy()
    return emb / np.linalg.norm(emb, axis=-1, keepdims=True)


def proximity(modules: AudioLDMModules, clap: ClapAudioModelWithProjection, device: str = "cuda",
              seconds: float = 10.24, steps: int = 50, dpm_steps: int = 25, lcm_steps: int = 4, window_s: float = 5.0,
              seed: int = 0, dtype=torch.bfloat16, latents=None, draws=None, probe=None) -> dict:
    """Each fast path's CLAP cosine and log-mel correlation to DDIM 50, and
    the anchor's. ``latents`` (``{"seed", "anchor"}``: the init noise of
    the seed's paths and of the anchor, NCHW), ``draws`` (``generate``'s loop
    draws by path name) and ``probe`` (the gain calibration's mel) stand in
    for the seeded ones when given (a test hands over another package's)."""
    need_device(device)
    modules.to(device, dtype)
    rows = prompt_rows(1, 16)
    _, c, h, w = latent_shape(modules, 1, seconds)
    factor = 2 ** (len(modules.vae.cfg.block_out_channels) - 1)
    gain = calibrate_vocoder_gain(modules, (1, h * factor, modules.vocoder.cfg.model_in_dim), probe=probe)
    sr = modules.vocoder.cfg.sampling_rate
    wavs = {}
    for name, kw in list(paths(steps, dpm_steps, lcm_steps, window_s).items()) + [("anchor_diffseed", None)]:
        t0 = time.perf_counter()
        kw = dict(kw or paths(steps, dpm_steps, lcm_steps, window_s)["ddim50"])
        anchor = name == "anchor_diffseed"
        wav = generate(modules, *rows, seed=seed + 1000 if anchor else seed, audio_length_in_s=seconds,
                       guidance_scale=2.5, dtype=dtype, device=device,
                       latents=None if latents is None else latents["anchor" if anchor else "seed"],
                       draws=None if draws is None else draws.get(name), **kw)
        wavs[name] = wav[0].float().cpu().numpy()
        print(f"# {name}: {time.perf_counter() - t0:.1f}s  max|w|={np.abs(wavs[name]).max():.3f}", file=sys.stderr)
    if not all(np.abs(w).max() > 0.02 for w in wavs.values()):
        raise RuntimeError("near-silent output: the calibrated vocoder gives no live audio")
    order = list(wavs)
    emb = embed(clap, [wavs[k] for k in order], sr, device)
    ref = order.index("ddim50")
    if embedding_cosine(emb[ref], emb[ref]) <= 0.999999:
        raise RuntimeError("the cosine of an embedding with itself is not 1")
    result = {"gauge": "proximity-vs-ddim50 (NOT quality)", "seconds": seconds, "vocoder_gain": gain}
    for i, k in enumerate(order):
        if k != "ddim50":
            result[f"clap_cos_{k}"] = embedding_cosine(emb[ref], emb[i])
            result[f"mel_corr_{k}"] = mel_correlation(wavs["ddim50"], wavs[k], sr)
    return result


def run(width: str = "full", device: str = "cuda", seconds: float | None = None, seed: int = 0) -> dict:
    """The gauge at ``width``: the modules and the CLAP tower from ``seed``."""
    need_device(device)
    secs, steps, dpm, lcm, win, dtype = WIDTHS[width]
    modules = random_modules(seed=seed, device=device, **(TINY if width == "tiny" else {}))
    clap = clap_tower(ClapAudioConfig() if width == "full" else TINY_CLAP, seed + 1, device)
    out = proximity(modules, clap, device, seconds or secs, steps, dpm, lcm, win, seed, dtype)
    return report("quality_proximity", device, width=width, **out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", choices=["full", "tiny"], default="full")
    ap.add_argument("--seconds", type=float, default=None, help="clip length (default 10.24 full / 0.08 tiny)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("quality_proximity: no CUDA GPU available", file=sys.stderr)
        return 1
    run(args.width, args.device, args.seconds, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
