#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (audioldm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the hand-written CUDA kernels from audioldm_tpu_torch/csrc with nvcc;
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, and times the kernel, the plain version and
   (for attention) PyTorch's own fused call as a yardstick;
3. drives the main path once through ``pipeline.generate.generate``: full
   audioldm-s widths with random weights from a seed, a 10.24 s clip, 50 DDIM
   steps, CFG 2.5, bf16 UNet and VAE, fp32 vocoder. It checks the waveform
   and that every kernel of the path launched (K1 500 times, K2 twice),
   times two more clips (s/clip is the median of three), and profiles two
   denoise steps for the device's busy share;
4. holds a tiny fp32 generation on the card (kernels routed) against the same
   generation on the CPU (plain versions).

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and as
its last line ``{"ok": true, "device": {...}}``. Exits nonzero, without that
line, when there is no CUDA GPU or any phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# least time the card could take (NVIDIA H100 SXM data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
# exp2 runs on the SFU: 16 per SM per clock (CUDA programming guide,
# compute capability 9.0) x 132 SMs x 1.98 GHz boost clock
SFU_EXP2_PER_S = 16 * 132 * 1.98e9
MRF_KS, MRF_DILS = (3, 7, 11), ((1, 3, 5),) * 3

SECONDS = 10.24
STEPS = 50
TINY = dict(
    text=dict(vocab_size=300, hidden_size=16, num_hidden_layers=1, num_attention_heads=2, intermediate_size=32,
              max_position_embeddings=514, projection_dim=8),
    unet=dict(in_channels=4, out_channels=4, block_out_channels=(8, 16),
              down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"), up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
              layers_per_block=1, norm_num_groups=4, attention_head_dim=2, projection_class_embeddings_input_dim=8),
    vae=dict(block_out_channels=(8, 16), layers_per_block=1, latent_channels=4, norm_num_groups=4, scaling_factor=0.9),
    voc=dict(model_in_dim=8, upsample_initial_channel=16, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4)),
)

failures: list[str] = []


def check(ok: bool, what: str) -> None:
    print(("ok   " if ok else "FAIL ") + what, flush=True)
    if not ok:
        failures.append(what)


def bound(nbytes: float, flops: float, kind: str, exp2: float = 0.0) -> tuple[float, str]:
    """Least time in ms: bytes over HBM rate, or operations over peak (the
    matmul/FMA FLOPs at ``kind``'s rate, the exp2 at the SFU's), the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / PEAK_FLOPS[kind], exp2 / SFU_EXP2_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, after
    one warm-up call (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flash_inputs(torch, seed: int = 0):
    """K1's main-path inputs: [2, 8, 4096, 16] bf16 (10.24 s clip), the
    ragged 4000 tokens of a 10.0 s clip, and fp32 (``--fp32``) at 4096 and
    at the 4016 tokens of a 10.04 s clip (4000 is a whole number of the fp32
    kernel's 32-row kv tiles, 4016 is not). q, k, v are
    head views of [B, N, C] projections, as the UNet hands them over.
    Yields ``(n, dtype, q, k, v)``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for n, dtype in ((4096, torch.bfloat16), (4000, torch.bfloat16), (4096, torch.float32), (4016, torch.float32)):
        q, k, v = (
            torch.randn(2, n, 128, device="cuda", generator=gen).to(dtype).view(2, n, 8, 16).transpose(1, 2)
            for _ in range(3)
        )
        yield n, dtype, q, k, v


def mrf_inputs(torch, seed: int = 1):
    """K2's main-path inputs, the last two vocoder stages of a 10.24 s clip
    (the second fuses conv_post). Yields ``(c, t, x, blocks, post)``."""
    from audioldm_tpu_torch.models.vocoder import HifiGanResidualBlock
    from audioldm_tpu_torch.pipeline.generate import init_random_

    gen = torch.Generator(device="cuda").manual_seed(seed)
    for c, t, with_post in ((64, 81936, False), (32, 163872, True)):
        with torch.device("cuda"):
            blocks = [init_random_(HifiGanResidualBlock(c, k, d), gen) for k, d in zip(MRF_KS, MRF_DILS)]
            post = init_random_(torch.nn.Conv1d(c, 1, 7, padding=3), gen) if with_post else None
        yield c, t, torch.randn(1, c, t, device="cuda", generator=gen), blocks, post


def k1_errors(out, ref, bf16: bool) -> dict:
    """K1 against its plain version: max and mean |out - ref| and the gain
    error <out - ref, ref> / <ref, ref>, each beside its bound. max: bf16
    max|ref| / 64 (2 to 4 bf16 ulps of the largest output), fp32 1e-5;
    mean: 1e-2 * mean|ref|; gain: 5e-4. Rounding noise averages out of the
    gain (~1e-5); a kernel that drops or adds a 64-row kv tile, or leaves
    the ragged tail's kv columns unmasked (their zero keys still enter the
    softmax sum and shrink every output by ~0.5% at 4000 tokens), does not."""
    diff = out - ref
    return {
        "max_abs_err": diff.abs().max().item(), "tolerance": ref.abs().max().item() / 64 if bf16 else 1e-5,
        "mean_abs_err": diff.abs().mean().item(), "mean_tolerance": 1e-2 * ref.abs().mean().item(),
        "gain_err": ((diff * ref).sum() / (ref * ref).sum()).item(), "gain_tolerance": 5e-4,
    }


def flash_cases(torch):
    import torch.nn.functional as F

    from audioldm_tpu_torch.kernels import flash_attention as fa

    out = []
    for n, dtype, q, k, v in flash_inputs(torch):
        bf16 = dtype == torch.bfloat16
        e = k1_errors(fa.flash_attention(q, k, v).double(), fa.sdpa_plain(q, k, v).double(), bf16)
        bh, d = 16, 16
        b_ms, b_by = bound(4 * bh * n * d * q.element_size(), 4 * bh * n * n * d, "bf16" if bf16 else "fp32",
                           exp2=bh * n * n)
        case = {
            "name": "flash_fwd", "route": "cuda", "source": "audioldm_tpu_torch/csrc/flash_attention.cu",
            "replaces": "audioldm_tpu/kernels/flash_attention.py:128", "shape": [2, 8, n, 16],
            "dtype": "bf16" if bf16 else "fp32", **e,
            "ms": cuda_ms(torch, lambda: fa.flash_attention(q, k, v), 50),
            "plain_ms": cuda_ms(torch, lambda: fa.sdpa_plain(q, k, v), 10),
            "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v), 50),
            "bound_ms": b_ms, "bound_by": b_by,
            "variant": (str(dtype).removeprefix("torch."), tuple(q.shape)),
        }
        check(e["max_abs_err"] <= e["tolerance"] and e["mean_abs_err"] <= e["mean_tolerance"]
              and abs(e["gain_err"]) <= e["gain_tolerance"],
              f"K1 flash_fwd {case['dtype']} [2,8,{n},16] kernel vs plain: max {e['max_abs_err']:.3g} <= "
              f"{e['tolerance']:.3g}, mean {e['mean_abs_err']:.3g} <= {e['mean_tolerance']:.3g}, "
              f"gain {e['gain_err']:.3g} within {e['gain_tolerance']}")
        out.append(case)
    return out


def mrf_cases(torch):
    from audioldm_tpu_torch.kernels import mrf_conv

    ks, dils = MRF_KS, MRF_DILS
    out = []
    for c, t, x, blocks, post in mrf_inputs(torch):
        with torch.no_grad():
            ref = mrf_conv.mrf_stage_plain(x, blocks, ks, dils, 0.1, post)
            diff = (mrf_conv.mrf_stage(x, blocks, ks, dils, 0.1, post) - ref).abs()
            err = diff.max().item()
            tol = 1e-4 * ref.abs().max().item()
            flops = 2 * c * c * t * 6 * sum(ks) + (2 * c * 7 * t if post is not None else 0)
            nbytes = 4 * (c * t + (t if post is not None else c * t) + c * c * 6 * sum(ks))
            b_ms, b_by = bound(nbytes, flops, "fp32")
            case = {
                "name": "mrf_stage", "route": "cuda", "source": "audioldm_tpu_torch/csrc/mrf_conv.cu",
                "replaces": "audioldm_tpu/kernels/mrf_conv.py:120", "shape": [1, c, t], "dtype": "fp32",
                "post": post is not None, "max_abs_err": err, "tolerance": tol, "mean_abs_err": diff.mean().item(),
                "ms": cuda_ms(torch, lambda: mrf_conv.mrf_stage(x, blocks, ks, dils, 0.1, post), 5),
                "plain_ms": cuda_ms(torch, lambda: mrf_conv.mrf_stage_plain(x, blocks, ks, dils, 0.1, post), 5),
                "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                "variant": (tuple(x.shape), 7 if post is not None else 0),
            }
        check(err <= tol, f"K2 mrf_stage [1,{c},{t}] post={post is not None}: max|kernel-plain| {err:.3g} <= {tol:.3g}")
        out.append(case)
    return out


def byte_tokenizer():
    """A byte-level tokenizer (the random-weight text tower has no vocab)."""
    from audioldm_tpu_torch.data.tokenizer import RobertaBPETokenizer, bytes_to_unicode

    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for ch in bytes_to_unicode().values():
        vocab[ch] = len(vocab)
    return RobertaBPETokenizer(vocab, [])


def main_path(torch) -> dict:
    from audioldm_tpu_torch.kernels import launch_counts, reset_launches
    from audioldm_tpu_torch.pipeline import generate as pg

    t0 = time.perf_counter()
    mods = pg.random_modules(seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tok = byte_tokenizer()
    enc, unc = tok(["hip hop music"]), tok([""])
    args = (mods, enc["input_ids"], enc["attention_mask"], unc["input_ids"], unc["attention_mask"])
    pg.generate(*args, seed=0, num_inference_steps=2, audio_length_in_s=SECONDS, guidance_scale=2.5)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def clip():
        t0 = time.perf_counter()
        out = pg.generate(*args, seed=0, num_inference_steps=STEPS, audio_length_in_s=SECONDS, guidance_scale=2.5)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    reset_launches()
    wav, s0 = clip()
    counts = launch_counts()
    # the host sets the step time and varies from run to run: two more clips
    # for the spread, the median is s/clip
    clip_s = [s0] + [clip()[1] for _ in range(2)]
    s_per_clip = sorted(clip_s)[1]

    check(tuple(wav.shape) == (1, int(SECONDS * 16000)), f"main path waveform shape {tuple(wav.shape)} == (1, 163840)")
    check(bool(torch.isfinite(wav).all()) and wav.abs().max().item() <= 1.0, "main path waveform finite, |x| <= 1")
    k1, k2 = sum(counts["flash_fwd"].values()), sum(counts["mrf_stage"].values())
    check(k1 == 10 * STEPS, f"K1 launched {k1} times on the main path (expect {10 * STEPS})")
    check(k2 == 2, f"K2 launched {k2} times on the main path (expect 2)")

    # the same clip again, stage by stage, for the time breakdown
    stages = {}
    with torch.inference_mode():
        t0 = time.perf_counter()
        cond, uncond = pg.encode_stage(*args)
        lat = pg.init_noise(mods, 0, 1, SECONDS)
        torch.cuda.synchronize()
        stages["text_and_noise_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lat = pg.denoise(mods, lat, cond, uncond, STEPS, 2.5, torch.bfloat16)
        torch.cuda.synchronize()
        stages["denoise_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mel = pg.decode_latents(mods, lat, torch.bfloat16)
        torch.cuda.synchronize()
        stages["vae_decode_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        wav2 = pg.vocode(mods, mel, wav.shape[1])
        torch.cuda.synchronize()
        stages["vocoder_s"] = time.perf_counter() - t0
    stages["max_abs_diff_vs_generate"] = (wav2 - wav).abs().max().item()
    return {"s_per_clip": s_per_clip, "clip_s": clip_s, "launches": counts, "stages": stages, "init_s": init_s,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "denoise_profile": profile_denoise(torch, mods, cond, uncond, stages["denoise_s"] / STEPS)}


def profile_denoise(torch, mods, cond, uncond, step_s: float) -> dict:
    """Device time per denoise step by kernel (torch.profiler over 2 steps),
    against the unprofiled wall time per step: the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    from audioldm_tpu_torch.pipeline import generate as pg

    lat = pg.init_noise(mods, 1, 1, SECONDS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pg.denoise(mods, lat, cond, uncond, 2, 2.5, torch.bfloat16)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    total_ms = sum(dev_us(e) for e in kernels) / 1e3 / 2
    if total_ms == 0:
        return {"device_ms_per_step": "not measured"}
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    return {
        "device_ms_per_step": total_ms, "wall_ms_per_step": step_s * 1e3,
        "device_busy_share": total_ms / (step_s * 1e3),
        "kernels_per_step": sum(e.count for e in kernels) / 2,
        "top": [[e.key[:60], dev_us(e) / 1e3 / 2, e.count / 2] for e in top],
    }


def tiny_reference(torch) -> float:
    """A tiny fp32 generation with both kernels routed on the card, held
    against the same generation on the CPU (plain versions), 2e-3."""
    from audioldm_tpu_torch import config as cfg
    from audioldm_tpu_torch.kernels import flash_attention as fa
    from audioldm_tpu_torch.pipeline import generate as pg

    def build():
        return pg.random_modules(
            3, cfg.UNetConfig(**TINY["unet"]), cfg.VAEConfig(**TINY["vae"]), cfg.ClapTextConfig(**TINY["text"]),
            cfg.VocoderConfig(**TINY["voc"]), device="cpu",
        )

    tok = byte_tokenizer()
    enc, unc = tok(["hip hop music"], max_length=16), tok([""], max_length=16)
    args = (enc["input_ids"], enc["attention_mask"], unc["input_ids"], unc["attention_mask"])
    kw = dict(seed=4, num_inference_steps=3, audio_length_in_s=0.04, dtype=torch.float32)
    saved = fa._MIN_TOKENS
    fa.set_min_tokens(256)  # the tiny level 0 has 320 tokens
    try:
        before = sum(fa.flash_attention.launches.values())
        gpu = pg.generate(build(), *args, device="cuda", **kw).cpu()
        routed = sum(fa.flash_attention.launches.values()) - before
        cpu = pg.generate(build(), *args, device="cpu", **kw)
    finally:
        fa.set_min_tokens(saved)
    err = (gpu - cpu).abs().max().item()
    check(routed == 18, f"tiny reference routed {routed} attention calls through K1 (expect 18)")
    check(err <= 2e-3, f"tiny fp32 generation, card vs CPU: max|d| {err:.3g} <= 2e-3")
    return err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    from audioldm_tpu_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output", flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build_s {time.perf_counter() - t0:.2f}", flush=True)

    # references in full fp32: cuDNN's fp32 convolutions default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = flash_cases(torch) + mrf_cases(torch)
    torch.backends.cudnn.allow_tf32 = True  # the main path runs PyTorch's defaults
    path = main_path(torch)
    for case in kernels:  # the main path's launches at this entry's dtype and shape
        case["launches"] = path["launches"][case["name"]].get(case.pop("variant"), 0)
    path["launches"] = {name: [[list(key), n] for key, n in c.items()] for name, c in path["launches"].items()}
    print(f"s_per_clip {path['s_per_clip']:.4f} (median of 3 clips; {STEPS} DDIM steps, {SECONDS} s, bf16, CFG 2.5)",
          flush=True)
    print("main_path " + json.dumps(path), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    tiny_reference(torch)

    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
