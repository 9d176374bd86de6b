"""The generate pipeline's stages outside the UNet, each timed alone on the
GPU (the port's copy of the repo's ``tools/bench_pipeline_tail.py``): text
encode (2 x 512 tokens), VAE decode (latents ``[1, 8, 256, 16]`` bf16 -> a
``[1, 1, 1024, 64]`` mel), and the vocoder (``[1, 1024, 64]`` -> 163 840
samples) in fp32, its two late stages through K2, and in bf16.

    python -m audioldm_tpu_torch.tools.bench_pipeline_tail [--device cuda]

audioldm-s with random weights from seed 0, the UNet and the VAE in bf16.
The port's vocoder computes in fp32; its bf16 run is the fp32 model under
``torch.autocast(dtype=torch.bfloat16)`` with every stage on the plain path,
the counterpart of the JAX tool's ``apply_vocoder(dtype=bf16)``, which K2
does not take either. Each time is the median of single calls on the host
clock between two synchronisations after warm-up calls
(``benchkit.median_s``), where the JAX tool takes the slope between two
loop lengths inside one jit. Prints a line a stage and one JSON line.

``bench`` takes ``device="cpu"`` and modules of any width, so that a test
can drive it.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from audioldm_tpu_torch.pipeline.generate import AudioLDMModules, decode_latents, encode_prompt, latent_shape, random_modules
from audioldm_tpu_torch.tools.bench_vocoder_mrf import k2_launches, plain_stages
from audioldm_tpu_torch.tools.benchkit import SECONDS, median_s, need_device, prompt_rows, report


def bench(modules: AudioLDMModules | None = None, device: str = "cuda", seconds: float = SECONDS, tokens: int = 512,
          warm: int = 3, timed: int = 10, dtype=torch.bfloat16) -> dict:
    """ms of each stage: ``text_encode``, ``vae_decode``, ``vocoder_fp32``
    (with its K2 launches) and ``vocoder_bf16``. The weights are made and
    cast outside inference mode (K2's packed-weight cache keys on their
    version counters)."""
    need_device(device)
    modules = modules or random_modules(seed=0, device=device)
    modules.to(device, dtype)
    with torch.inference_mode():
        return _bench(modules, device, seconds, tokens, warm, timed, dtype)


def _bench(modules, device, seconds, tokens, warm, timed, dtype) -> dict:
    dev = modules.device
    ids, mask, _, _ = prompt_rows(2, tokens)
    lat = torch.zeros(latent_shape(modules, 1, seconds), dtype=dtype, device=dev)
    mel = decode_latents(modules, lat, dtype)[:, 0].float()
    voc = modules.vocoder
    out = {}

    def stage(name, fn):
        out[name] = {"ms": median_s(lambda _: fn(), warm, timed, device) * 1e3}
        print(f"{name}: {out[name]['ms']:.3f} ms", flush=True)

    stage("text_encode", lambda: encode_prompt(modules, ids, mask))
    stage("vae_decode", lambda: decode_latents(modules, lat, dtype))
    before = k2_launches()
    wav = voc(mel)
    out_k2 = k2_launches() - before
    stage("vocoder_fp32", lambda: voc(mel))
    out["vocoder_fp32"].update(k2_launches_per_call=out_k2, finite=bool(torch.isfinite(wav).all()))
    with plain_stages(voc), torch.autocast(dev.type, dtype=torch.bfloat16):
        stage("vocoder_bf16", lambda: voc(mel))
    return report("bench_pipeline_tail", device, mel_shape=list(mel.shape), samples=int(wav.shape[-1]), stages=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_pipeline_tail: no CUDA GPU available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    modules = random_modules(seed=0, device=args.device)
    print(f"# init: {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    bench(modules, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
