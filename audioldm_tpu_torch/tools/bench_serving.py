"""Serving and sampler latency and throughput of the port at full model size
(its copy of the repo's ``tools/bench_serving.py``), on one GPU.

    python -m audioldm_tpu_torch.tools.bench_serving           # dpm++ 25/20 latency; serve batch 4 over three routes
    python -m audioldm_tpu_torch.tools.bench_serving --lcm     # lcm 8, 4, 2 and 1 steps at batch 1, no CFG
    python -m audioldm_tpu_torch.tools.bench_serving --sweep   # merged route at batches 1, 2, 4 and 8
    python -m audioldm_tpu_torch.tools.bench_serving --knee    # batches 8-24 to the first out-of-memory, with MFU
    python -m audioldm_tpu_torch.tools.bench_serving --hybrid  # the mixed batch by dense_lora_max_dim
    python -m audioldm_tpu_torch.tools.bench_serving --flush   # flush() overlapped against chunk by chunk

Flags combine; each section prints its lines in the JAX tool's words, one
measurement a line. The models are audioldm-s at full width with random
weights from seed 0, the UNet and the VAE in bf16, the vocoder fp32; clips
are 10.24 s, serving runs DDIM 50 with CFG 2.5. A figure is the median of
its timed runs after its warm-up runs, each run ended by a copy of its
output to the host (``ServeEngine`` returns host arrays; ``generate`` is
synchronised before the clock stops). ``--knee``'s MFU is the clip's
useful FLOPs (``utils.flops.pipeline_flops``) over the time and the H100
SXM's dense bf16 peak.

Each section is a function of the modules, the device and the sizes, so
that a test can drive it on the CPU at tiny widths (``device="cpu"``).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from audioldm_tpu_torch.config import LoRAConfig
from audioldm_tpu_torch.lora import init_lora
from audioldm_tpu_torch.pipeline.generate import AudioLDMModules, generate, latent_shape, random_modules
from audioldm_tpu_torch.serve import AdapterBank, ServeEngine
from audioldm_tpu_torch.tools.benchkit import SECONDS, Tok
from audioldm_tpu_torch.tools.benchkit import median_s as _median_s
from audioldm_tpu_torch.utils import flops as fl

PROMPT = "hip hop beat"
MIXED = ["a", "b", "a", "base"]


def make_adapters(modules: AudioLDMModules, lcfg: LoRAConfig, seeds) -> dict:
    """The JAX tool's adapters: fresh ones plus 0.01 everywhere (B nonzero)."""
    out = {}
    for name, s in seeds.items():
        lora = init_lora(modules.unet, lcfg, torch.Generator().manual_seed(s))
        with torch.no_grad():
            for p in lora.parameters():
                p.add_(0.01)
        out[name] = lora
    return out


def _prompt_rows(tok):
    enc, unc = tok([PROMPT]), tok([""])
    return enc["input_ids"], enc["attention_mask"], unc["input_ids"], unc["attention_mask"]


def _serve_line(prefix: str, dt: float, b: int) -> str:
    return f"{prefix}: {dt:.3f} s/batch = {dt / b:.3f} s/clip ({b / dt:.2f} clips/s)"


def sampler_latency(modules, device="cuda", seconds=SECONDS, steps=(25, 20), scheduler="dpm++", guidance=2.5,
                    warm=2, timed=5) -> dict:
    """s/clip of one prompt at batch 1 for each step count of ``scheduler``:
    dpm++ 25 and 20 with CFG (the main section), lcm 8-1 without."""
    rows = _prompt_rows(Tok())
    out = {}
    for n in steps:
        def run(seed):
            wav = generate(modules, *rows, seed=seed, num_inference_steps=n, audio_length_in_s=seconds,
                           guidance_scale=guidance, scheduler=scheduler, device=device)
            return wav[0, :8].cpu()

        out[n] = _median_s(run, warm, timed, device)
        print(f"{scheduler} {n} steps: {out[n]:.3f} s/clip", flush=True)
    return out


def serve_routes(modules, device="cuda", seconds=SECONDS, steps=50, warm=2, timed=3) -> dict:
    """A batch of 4 over the mixed rank-r route (buckets (4,)), the mixed
    split route (buckets (1, 2, 4)) and the uniform merged route."""
    lcfg = LoRAConfig(r=4, lora_alpha=4)
    bank = AdapterBank.from_adapters(make_adapters(modules, lcfg, {"a": 1, "b": 2}), lcfg, device=device)
    tok = Tok()
    coarse = ServeEngine(modules, tok, lcfg, bank=bank, bucket_sizes=(4,), device=device)
    fine = ServeEngine(modules, tok, lcfg, bank=bank, bucket_sizes=(1, 2, 4), device=device)
    gen = dict(num_inference_steps=steps, audio_length_in_s=seconds, guidance_scale=2.5)
    out = {}
    for tag, eng, adapters in (("mixed coarse-buckets(4,) gate->rank-r", coarse, MIXED),
                               ("mixed fine-buckets(1,2,4) split->merged", fine, MIXED),
                               ("uniform->merged", coarse, ["a"] * 4)):
        out[tag] = _median_s(lambda s: eng.generate([PROMPT] * 4, adapters=adapters, seed=s, **gen), warm, timed, device)
        print(_serve_line(f"serve batch=4 {tag}", out[tag], 4), flush=True)
    return out


def batch_sweep(modules, device="cuda", seconds=SECONDS, steps=50, batches=(1, 2, 4, 8), warm=2, timed=3) -> dict:
    """Throughput by batch size of uniform-adapter (merged route) traffic."""
    lcfg = LoRAConfig(r=4, lora_alpha=4)
    bank = AdapterBank.from_adapters(make_adapters(modules, lcfg, {"a": 1}), lcfg, device=device)
    out = {}
    for b in batches:
        eng = ServeEngine(modules, Tok(), lcfg, bank=bank, bucket_sizes=(b,), device=device)
        out[b] = _median_s(lambda s: eng.generate([PROMPT] * b, adapters=["a"] * b, seed=s, num_inference_steps=steps,
                                                  audio_length_in_s=seconds, guidance_scale=2.5), warm, timed, device)
        print(_serve_line(f"serve merged batch={b}", out[b], b), flush=True)
    return out


def clip_flops(modules: AudioLDMModules, steps: int, seconds: float, seqlen: int = 512) -> float:
    """Useful FLOPs of one CFG clip of ``seconds`` at ``steps`` DDIM steps."""
    _, _, h, w = latent_shape(modules, 1, seconds)
    return fl.pipeline_flops(modules.unet.cfg, modules.vae.cfg, modules.vocoder.cfg, modules.text_encoder.cfg,
                             steps=steps, latent_h=h, latent_w=w, seqlen=seqlen)["total"].useful


def throughput_knee(modules, device="cuda", seconds=SECONDS, steps=50, batches=(8, 12, 16, 20, 24), warm=2, timed=3) -> dict:
    """The batch of most clips/s for base traffic (the route production
    batches ride): steps through ``batches`` and stops at the first
    ``torch.cuda.OutOfMemoryError``, printing clips/s and MFU at each."""
    tok = Tok()
    per_clip = clip_flops(modules, steps, seconds)
    out, best = {}, None
    for b in batches:
        eng = ServeEngine(modules, tok, LoRAConfig(), bucket_sizes=(b,), device=device)
        try:
            dt = _median_s(lambda s: eng.generate([PROMPT] * b, seed=s, num_inference_steps=steps,
                                                  audio_length_in_s=seconds, guidance_scale=2.5), warm, timed, device)
        except torch.cuda.OutOfMemoryError as e:
            print(f"serve batch={b}: FAILED ({type(e).__name__}: {str(e)[:120]})", flush=True)
            del eng
            torch.cuda.empty_cache()
            break
        cps, mfu = b / dt, fl.mfu(b * per_clip, dt)
        out[b] = {"s_per_batch": dt, "clips_per_s": cps, "mfu": mfu}
        print(f"serve batch={b}: {dt:.3f} s/batch = {dt / b:.3f} s/clip ({cps:.2f} clips/s, mfu {mfu:.3f})", flush=True)
        if best is None or cps > best[1]:
            best = (b, cps, dt / b, mfu)
        del eng
    if best:
        print(f"KNEE: batch={best[0]} -> {best[1]:.2f} clips/s/chip ({best[2]:.3f} s/clip, mfu {best[3]:.3f})", flush=True)
    return out


def hybrid_sweep(modules, device="cuda", seconds=SECONDS, steps=50, dims=(None, 128, 256, 384), warm=2, timed=3) -> dict:
    """The mixed batch on the rank-r route, and dense below each
    ``dense_lora_max_dim``."""
    lcfg = LoRAConfig(r=4, lora_alpha=4)
    bank = AdapterBank.from_adapters(make_adapters(modules, lcfg, {"a": 1, "b": 2}), lcfg, device=device)
    out = {}
    for dmax in dims:
        tag = "rank-r" if dmax is None else f"hybrid<={dmax}"
        eng = ServeEngine(modules, Tok(), lcfg, bank=bank, bucket_sizes=(4,), dense_lora_max_dim=dmax,
                          device=device)
        out[tag] = _median_s(lambda s: eng.generate([PROMPT] * 4, adapters=MIXED, seed=s, num_inference_steps=steps,
                                                    audio_length_in_s=seconds, guidance_scale=2.5), warm, timed, device)
        print(f"serve mixed {tag}: {out[tag]:.3f} s/batch = {out[tag] / 4:.3f} s/clip", flush=True)
    return out


def flush_overlap(modules, device="cuda", seconds=SECONDS, steps=50, n=8, warm=2, timed=3) -> dict:
    """``flush`` of ``n`` requests in chunks of 4: every chunk launched
    before the first copy to the host, against copying each chunk before
    launching the next."""
    lcfg = LoRAConfig(r=4, lora_alpha=4)
    bank = AdapterBank.from_adapters(make_adapters(modules, lcfg, {"a": 1}), lcfg, device=device)
    eng = ServeEngine(modules, Tok(), lcfg, bank=bank, bucket_sizes=(4,), device=device)

    def overlapped(seed):
        eng._rng_counter = 0
        for i in range(n):
            eng.submit(f"{PROMPT} {i}", "a")
        return eng.flush(num_inference_steps=steps, audio_length_in_s=seconds, guidance_scale=2.5, seed=seed, max_batch=4)

    def sequential(seed):  # the same chunks, each copied before the next is launched
        eng._rng_counter = 0
        outs = []
        for c in range(0, n, 4):
            eng._rng_counter += 1
            parts = eng._generate_async([f"{PROMPT} {i}" for i in range(c, c + 4)], ["a"] * 4, steps, seconds, 2.5,
                                        "ddim", (seed, eng._rng_counter))
            outs.append(eng._assemble(parts, 4))
        return np.concatenate(outs)

    out = {}
    for tag, run in (("sequential", sequential), ("overlapped-flush", overlapped)):
        out[tag] = _median_s(run, warm, timed, device)
        print(f"flush n={n} chunks=4 {tag}: {out[tag]:.3f} s = {out[tag] / n:.3f} s/clip ({n / out[tag]:.2f} clips/s)",
              flush=True)
    return out


SECTIONS = ("lcm", "sweep", "knee", "hybrid", "flush")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    for name in SECTIONS:
        ap.add_argument(f"--{name}", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    modules = random_modules(seed=0, device=args.device)
    print(f"# init: {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    chosen = [name for name in SECTIONS if getattr(args, name)]
    if not chosen:
        sampler_latency(modules, args.device)
        serve_routes(modules, args.device)
    if "lcm" in chosen:
        sampler_latency(modules, args.device, steps=(8, 4, 2, 1), scheduler="lcm", guidance=1.0, timed=10)
    if "sweep" in chosen:
        batch_sweep(modules, args.device)
    if "knee" in chosen:
        throughput_knee(modules, args.device)
    if "hybrid" in chosen:
        hybrid_sweep(modules, args.device)
    if "flush" in chosen:
        flush_overlap(modules, args.device)


if __name__ == "__main__":
    main()
