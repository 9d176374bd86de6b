"""Batch data prep throughput (BASELINE config 3; port of
tools/bench_dataprep.py).

    python -m audioldm_tpu_torch.tools.bench_dataprep [--batch 64] [--batches 8] [--skip-host] [--device cuda]

Stages, at ``--batch`` clips of 163 840 samples (10.24 s at 16 kHz):
- ``mel_only``: the data pipeline's device front end, reflect-pad, framed
  rFFT magnitude, Slaney mel, log, pad to 1024 frames (``ops.mel``);
- ``mel_plus_vae_encode``: the same, then the bf16 VAE encoder (random
  weights from a seed, audioldm-s widths) and a posterior sample times the
  scaling factor, as a training step consumes it;
- the host: ``data.native`` resample 22.05 kHz -> 16 kHz and normalise, a
  clip at a time, one thread.

Each device stage runs once to warm up, then ``--batches`` batches back to
back between two synchronisations (host clock). Prints one JSON line a
stage (``metric``, ``value`` in clips/s, the card's name and power limit)
and returns them. On the CPU (``--device cpu``) it runs the same at any
size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from audioldm_tpu_torch import resolve_device
from audioldm_tpu_torch.config import MelConfig, VAEConfig

SAMPLES = 163840  # 10.24 s at 16 kHz


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(batch: int = 64, batches: int = 8, device="cuda", skip_host: bool = False, samples: int = SAMPLES,
        vae_cfg: VAEConfig = VAEConfig()) -> list[dict]:
    """The stages' JSON records (see the module docstring); ``samples`` and
    ``vae_cfg`` shrink the work for a run on the CPU."""
    from audioldm_tpu_torch.models.vae import AutoencoderKL
    from audioldm_tpu_torch.ops.mel import log_mel_spectrogram
    from audioldm_tpu_torch.pipeline.generate import init_random_
    from audioldm_tpu_torch.tools.bench_attn import card

    dev = resolve_device(device)
    mel_cfg = MelConfig(duration=samples / 16000)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.device(dev):
        vae = init_random_(AutoencoderKL(vae_cfg), gen).eval()
    for m in vae.modules():  # the pipeline's bf16 rule: linear and conv weights, norms stay fp32
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)):
            m.to(torch.bfloat16)
    wavs = [0.1 * torch.randn(batch, samples, generator=gen, device=dev) for _ in range(2)]

    def mel_only(i):
        return log_mel_spectrogram(wavs[i % 2], mel_cfg)

    def mel_plus_vae_encode(i):
        dist = vae.encode(log_mel_spectrogram(wavs[i % 2], mel_cfg)[:, None].to(torch.bfloat16))
        return dist.sample(generator=gen) * vae_cfg.scaling_factor

    where = card(dev.type)
    out = []
    with torch.inference_mode():
        for name, fn in (("mel_only", mel_only), ("mel_plus_vae_encode", mel_plus_vae_encode)):
            first = fn(0)
            _sync(dev)
            t0 = time.perf_counter()
            for i in range(batches):
                fn(i)
            _sync(dev)
            dt = time.perf_counter() - t0
            clips_s = batches * batch / dt
            out.append({"metric": f"dataprep_{name}_clips_per_s", "value": clips_s, "unit": "clips/s", "batch": batch,
                        "batches": batches, "audio_s_per_s": clips_s * samples / 16000, "shape": list(first.shape),
                        "finite": bool(torch.isfinite(first).all()), "card": where})
    if not skip_host:
        from audioldm_tpu_torch.data import native

        if native.available():
            src = (np.random.default_rng(0).standard_normal((batch, int(samples * 22050 / 16000))) * 0.1).astype(np.float32)
            t0 = time.perf_counter()
            for row in src:
                native.normalize_native(native.resample_native(row, 22050, 16000))
            out.append({"metric": "dataprep_host_cpp_resample_normalize_clips_per_s",
                        "value": batch / (time.perf_counter() - t0), "unit": "clips/s", "batch": batch})
        else:
            out.append({"metric": "dataprep_host_cpp", "value": None, "note": "libaudioprep.so not built"})
    for rec in out:
        print(json.dumps(rec), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--skip-host", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.batch, args.batches, args.device, args.skip_host)
    return 0


if __name__ == "__main__":
    sys.exit(main())
