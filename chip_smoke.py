#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (audioldm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # everything; the form that ends in the ``ok`` line
    python3 chip_smoke.py train,tiny # some of the phases kernels,serve,train,tiny; no result lines

1. builds the hand-written CUDA kernels from audioldm_tpu_torch/csrc with nvcc;
2. holds each kernel (K1 flash forward, K2 fused MRF stage, K3 flash forward
   with lse, K4 flash dK/dV, K5 flash dQ) against its plain PyTorch version on
   the card, at the shapes the main paths give it, and times the kernel, the
   plain version and (for attention) PyTorch's own fused call as a yardstick;
   the differentiable ``flash_attention`` is also held against autograd
   through plain attention;
3. drives the serving path once through ``pipeline.generate.generate``: full
   audioldm-s widths with random weights from a seed, a 10.24 s clip, 50 DDIM
   steps, CFG 2.5, bf16 UNet and VAE, fp32 vocoder. It checks the waveform
   and that every kernel of the path launched (K1 500 times, K2 twice),
   times two more clips (s/clip is the median of three), and profiles two
   denoise steps for the device's busy share;
4. drives the training path through ``train.Trainer.fit``: the same widths,
   batch 2, bf16 frozen modules, fp32 rank-2 adapters on to_q and to_v, one
   warm-up step and 5 timed steps. It checks the losses, that the adapters
   move and the base weights do not, and that K3, K4 and K5 each launched 10
   times a step and K1 never; it times the step's stages and profiles two
   steps;
5. holds a tiny fp32 generation and a tiny fp32 training step on the card
   (kernels routed) against the same on the CPU (plain versions).

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and as
its last line ``{"ok": true, "device": {...}}``. Exits nonzero, without that
line, when there is no CUDA GPU or any phase fails.
"""

from __future__ import annotations

import json
import math
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
TRAIN_STEPS = 5
PHASES = ("kernels", "serve", "train", "tiny")  # all run by default; `chip_smoke.py train,tiny` runs some
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
    """A flash kernel's result against its plain version: max and mean
    |out - ref| and the gain
    error <out - ref, ref> / <ref, ref>, each beside its bound. max: bf16
    max|ref| / 64 (2 to 4 bf16 ulps of the largest output), fp32 1e-5
    (times max|ref| where that is above 1);
    mean: 1e-2 * mean|ref|; gain: 5e-4. Rounding noise averages out of the
    gain (~1e-5); a kernel that drops or adds a 64-row kv tile, or leaves
    the ragged tail's kv columns unmasked (their zero keys still enter the
    softmax sum and shrink every output by ~0.5% at 4000 tokens), does not."""
    diff = out - ref
    return {
        "max_abs_err": diff.abs().max().item(), "tolerance": ref.abs().max().item() / 64 if bf16 else 1e-5 * max(1.0, ref.abs().max().item()),
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
        check(errors_ok(e),
              f"K1 flash_fwd {case['dtype']} [2,8,{n},16] kernel vs plain: max {e['max_abs_err']:.3g} <= "
              f"{e['tolerance']:.3g}, mean {e['mean_abs_err']:.3g} <= {e['mean_tolerance']:.3g}, "
              f"gain {e['gain_err']:.3g} within {e['gain_tolerance']}")
        out.append(case)
    return out


def errors_ok(e: dict) -> bool:
    return (e["max_abs_err"] <= e["tolerance"] and e["mean_abs_err"] <= e["mean_tolerance"]
            and abs(e["gain_err"]) <= e["gain_tolerance"])


def flash_train_cases(torch):
    """K3, K4 and K5 against their plain versions at K1's four shapes, with
    a dO laid out as autograd hands it over (the head view of a [B, N, C]
    gradient). out, dq, dk and dv are held to the three bounds of
    ``k1_errors``, lse2 to max|d| <= 1e-4 (fp32 sums of the same terms in
    another order). K4 and K5 get the plain forward's out and lse2, so their
    errors are their own. ``library_ms`` of K3 is the forward of
    ``F.scaled_dot_product_attention``; of K4 and K5 it is its backward,
    which is one PyTorch call for both kernels together."""
    import torch.nn.functional as F

    from audioldm_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2)
    src = "audioldm_tpu_torch/csrc/"
    out = []
    for n, dtype, q, k, v in flash_inputs(torch):
        bf16 = dtype == torch.bfloat16
        tag = "bf16" if bf16 else "fp32"
        dout = torch.randn(2, n, 128, device="cuda", generator=gen).to(dtype).view(2, n, 8, 16).transpose(1, 2)
        ref_o, ref_lse = fa.flash_fwd_lse_plain(q, k, v)
        o, lse = fa.flash_fwd_lse(q, k, v)
        ref_dq, ref_dk, ref_dv = fa.flash_bwd_plain(q, k, v, ref_o, ref_lse, dout)
        delta = (dout.float() * ref_o.float()).sum(dim=-1).contiguous()
        dk, dv = fa.flash_bwd_dkv(q, k, v, dout, ref_lse, delta)
        dq = fa.flash_bwd_dq(q, k, v, dout, ref_lse, delta)
        torch.cuda.synchronize()
        lse_err = (lse - ref_lse).abs().max().item()
        errs = {name: k1_errors(a.double(), r.double(), bf16)
                for name, a, r in (("out", o, ref_o), ("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv))}
        for name, e in errs.items():
            check(errors_ok(e), f"K3-K5 {name} {tag} [2,8,{n},16] kernel vs plain: max {e['max_abs_err']:.3g} <= "
                                f"{e['tolerance']:.3g}, mean {e['mean_abs_err']:.3g} <= {e['mean_tolerance']:.3g}, "
                                f"gain {e['gain_err']:.3g} within {e['gain_tolerance']}")
        check(lse_err <= 1e-4, f"K3 lse2 {tag} [2,8,{n},16] kernel vs plain: max|d| {lse_err:.3g} <= 1e-4")
        if n != 4096:  # the ragged shapes: the differentiable call against autograd through plain attention
            function_vs_autograd(torch, fa, q, k, v, dout, bf16, f"{tag} [2,8,{n},16]")

        # SDPA's backward alone: time forward + backward, take the forward off
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        sdpa_fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v), 50)

        def sdpa_both():
            F.scaled_dot_product_attention(ql, kl, vl).backward(dout)
            ql.grad = kl.grad = vl.grad = None

        sdpa_bwd = cuda_ms(torch, sdpa_both, 20) - cuda_ms(torch, lambda: F.scaled_dot_product_attention(ql, kl, vl), 20)
        plain_bwd = cuda_ms(torch, lambda: fa.flash_bwd_plain(q, k, v, ref_o, ref_lse, dout), 5)
        bh, d, es = 16, 16, q.element_size()
        kind = "bf16" if bf16 else "fp32"
        io = bh * n * d * es  # one [B, H, N, D] tensor
        rows = bh * n * 4  # one fp32 [B, H, N] vector
        work = {
            "flash_fwd_lse": (4 * io + rows, 2, "out", "audioldm_tpu/kernels/flash_attention.py:86", src + "flash_attention.cu",
                              lambda: fa.flash_fwd_lse(q, k, v), lambda: fa.flash_fwd_lse_plain(q, k, v), sdpa_fwd),
            "flash_bwd_dkv": (6 * io + 2 * rows, 4, "dk", "audioldm_tpu/kernels/flash_attention.py:237", src + "flash_attention_bwd.cu",
                              lambda: fa.flash_bwd_dkv(q, k, v, dout, ref_lse, delta), None, sdpa_bwd),
            "flash_bwd_dq": (5 * io + 2 * rows, 3, "dq", "audioldm_tpu/kernels/flash_attention.py:264", src + "flash_attention_bwd.cu",
                             lambda: fa.flash_bwd_dq(q, k, v, dout, ref_lse, delta), None, sdpa_bwd),
        }
        for name, (nbytes, products, key, replaces, source, run, plain, lib_ms) in work.items():
            b_ms, b_by = bound(nbytes, products * 2 * bh * n * n * d, kind, exp2=bh * n * n)
            e = dict(errs[key])
            if name == "flash_bwd_dkv":  # the worse of dk and dv
                e = {f: max(abs(errs["dk"][f]), abs(errs["dv"][f])) for f in e}
            case = {
                "name": name, "route": "cuda", "source": source, "replaces": replaces, "shape": [2, 8, n, 16],
                "dtype": tag, **e, "ms": cuda_ms(torch, run, 50),
                # the plain backward computes dq, dk and dv in one pass: its time stands on both rows
                "plain_ms": cuda_ms(torch, plain, 10) if plain else plain_bwd,
                "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                "variant": (str(dtype).removeprefix("torch."), tuple(q.shape)),
            }
            if name == "flash_fwd_lse":
                case["lse_max_abs_err"] = lse_err
            out.append(case)
    return out


def function_vs_autograd(torch, fa, q, k, v, dout, bf16: bool, label: str) -> None:
    """``flash_attention`` with grad enabled (K3, then K4 + K5 in the
    backward) against autograd through ``sdpa_plain``: the output carries a
    ``grad_fn``, and out, dq, dk, dv agree. fp32: the bounds of
    ``k1_errors``. bf16: max <= max|ref| / 16, mean <= 5e-2 * mean|ref|, gain
    2e-3, wider than against the kernels' own plain versions because
    autograd rounds elsewhere: it rounds the normalised weights and dP to
    bf16, the kernels round the unnormalised P and dS."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves)
    check(out.grad_fn is not None, f"flash_attention {label} with grad enabled returns a tensor with a grad_fn")
    with torch.no_grad():
        check(fa.flash_attention(*leaves).grad_fn is None, f"flash_attention {label} under no_grad takes K1 (no graph)")
    got = (out,) + torch.autograd.grad(out, leaves, dout)
    ref_out = fa.sdpa_plain(*leaves)
    want = (ref_out,) + torch.autograd.grad(ref_out, leaves, dout)
    for name, a, r in zip(("out", "dq", "dk", "dv"), got, want):
        e = k1_errors(a.detach().double(), r.detach().double(), bf16)
        if bf16:
            r_abs = r.detach().double().abs()
            e.update(tolerance=r_abs.max().item() / 16, mean_tolerance=5e-2 * r_abs.mean().item(), gain_tolerance=2e-3)
        check(errors_ok(e), f"Function vs autograd {name} {label}: max {e['max_abs_err']:.3g} <= {e['tolerance']:.3g}, "
                            f"mean {e['mean_abs_err']:.3g} <= {e['mean_tolerance']:.3g}, gain {e['gain_err']:.3g} "
                            f"within {e['gain_tolerance']}")


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
    """Device time per denoise step by kernel, see ``profile_two_steps``."""
    from audioldm_tpu_torch.pipeline import generate as pg

    lat = pg.init_noise(mods, 1, 1, SECONDS)
    return profile_two_steps(torch, lambda: pg.denoise(mods, lat, cond, uncond, 2, 2.5, torch.bfloat16), step_s)


def profile_two_steps(torch, run_two_steps, step_s: float) -> dict:
    """Device time per step by kernel (torch.profiler over a call that
    takes 2 steps), against the unprofiled wall time per step: the device's
    busy share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_two_steps()
        torch.cuda.synchronize()
    # device activities only: a record_function range (Optimizer.step#AdamW.step)
    # also appears on the device's timeline, beside the kernels inside it
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")
               and not getattr(e, "is_user_annotation", False) and not e.key.startswith("Optimizer.")]
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


def train_batches(n: int, seed: int = 0):
    """A seeded iterator of ``n`` training batches at full size: log-mel
    ``[2, 1, 1024, 64]`` (a 10.24 s clip), 512 token ids and their mask."""
    import numpy as np

    rng = np.random.default_rng(seed)
    enc = byte_tokenizer()(["hip hop music with a heavy bass line", "a dog barking in the rain"])
    for _ in range(n):
        yield {"log_mel_spec": rng.standard_normal((2, 1, 1024, 64)).astype(np.float32),
               "input_ids": enc["input_ids"], "attention_mask": enc["attention_mask"]}


def train_path(torch) -> dict:
    """LoRA training at full width through ``Trainer.fit``."""
    import statistics
    import tempfile

    from audioldm_tpu_torch import config as cfg
    from audioldm_tpu_torch.kernels import launch_counts, reset_launches
    from audioldm_tpu_torch.lora import init_lora
    from audioldm_tpu_torch.pipeline import generate as pg
    from audioldm_tpu_torch.train import Trainer
    from audioldm_tpu_torch.train import trainer as tr

    lcfg, tcfg = cfg.LoRAConfig(), cfg.TrainConfig()
    mods = pg.random_modules(seed=0, device="cuda")
    with tempfile.TemporaryDirectory() as out_dir:
        trainer = Trainer(mods, lcfg, tcfg, out_dir, dtype=torch.bfloat16)
        state = trainer.init_state(init_lora(mods.unet, lcfg, torch.Generator().manual_seed(0)))
        models = (mods.unet, mods.vae, mods.text_encoder, mods.vocoder)
        base = [p.detach().clone() for m in models for p in m.parameters()]
        a0 = [a.detach().clone() for _, a, _ in state.lora.items()]
        gen = torch.Generator(device="cuda").manual_seed(tcfg.seed)

        state, warm = trainer.fit(state, train_batches(1, seed=1), gen, max_steps=1)  # warm-up, step 1
        torch.cuda.synchronize()
        b_moved = all(bool(b.any()) for _, _, b in state.lora.items())
        check(b_moved, "training: after step 1 every B is nonzero (at B = 0 the first step moves only B)")

        marks, losses = [], [float(warm["loss"])]

        def each_step(st, step):  # the trainer's validation hook, used as a clock
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if step == 2:
                moved = all(not torch.equal(a, old) for (_, a, _), old in zip(st.lora.items(), a0))
                check(moved, "training: after step 2 every A has moved")

        class Losses:
            def log(self, metrics, step):
                losses.append(metrics["train_loss"])

        trainer.logger = Losses()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        state, _ = trainer.fit(state, train_batches(TRAIN_STEPS, seed=2), gen, max_steps=1 + TRAIN_STEPS,
                               validate_every=1, validate_fn=each_step)
        torch.cuda.synchronize()
        counts = launch_counts()
        trainer.logger = None
        peak = torch.cuda.max_memory_allocated() / 2**30
        step_s = [b - a for a, b in zip([t0] + marks, marks)]
        step_med = statistics.median(step_s)

        check(state.step == 1 + TRAIN_STEPS and len(losses) == 1 + TRAIN_STEPS and all(math.isfinite(x) for x in losses),
              f"training: {TRAIN_STEPS} steps after the warm-up, every loss finite: {[round(x, 4) for x in losses]}")
        same = all(torch.equal(p, q) for p, q in zip((p for m in models for p in m.parameters()), base))
        check(same, "training: base weights unchanged")
        variant = ("bfloat16", (2, 8, 4096, 16))
        for name, label in (("flash_fwd_lse", "K3"), ("flash_bwd_dkv", "K4"), ("flash_bwd_dq", "K5")):
            check(counts[name] == {variant: 10 * TRAIN_STEPS},
                  f"{label} launched {counts[name].get(variant, 0)} times at {variant} in {TRAIN_STEPS} training "
                  f"steps (expect {10 * TRAIN_STEPS}, and no other shape)")
        k1 = sum(counts["flash_fwd"].values())
        check(k1 == 0, f"K1 launched {k1} times on the training path (expect 0)")

        # one more step, stage by stage, three times over, for the time split
        stages = {"encode_s": [], "unet_forward_s": [], "backward_s": [], "optimizer_s": []}
        for batch in train_batches(3, seed=3):
            for p_ in state.optimizer.params:
                p_.grad = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            noisy, t, prompt, noise = tr.prepare_inputs(mods, batch, torch.bfloat16, gen)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            eps = mods.unet(noisy, t, prompt, lora=state.lora, lora_scale=lcfg.scale)
            loss = torch.mean((eps.float() - noise) ** 2)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            loss.backward()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            state.optimizer.update(state.step)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                stages[key].append(dt)
        stages = {k: statistics.median(v) for k, v in stages.items()}

        two = list(train_batches(2, seed=4))
        prof = profile_two_steps(torch, lambda: [trainer.step_fn(state, b, gen) for b in two], step_med)
    return {"s_per_step": step_med, "step_s": step_s, "samples_per_s": tcfg.train_batch_size / step_med,
            "losses": losses, "launches": counts, "peak_mem_gib": peak, "stages": stages, "train_profile": prof,
            "adapters": len(state.lora.paths()), "adapter_params": sum(p.numel() for p in state.lora.parameters())}


def tiny_train_reference(torch) -> dict:
    """A tiny fp32 training step's loss and adapter gradients on the card
    (K3-K5 routed) against the same on the CPU (plain versions inside the
    autograd Function): loss to 1e-5 relative, every gradient to 1e-4 of
    the largest gradient entry (fp32 sums in another order; cuDNN's TF32 is
    off)."""
    import copy

    import numpy as np

    from audioldm_tpu_torch import config as cfg
    from audioldm_tpu_torch.kernels import flash_attention as fa
    from audioldm_tpu_torch.kernels import launch_counts, reset_launches
    from audioldm_tpu_torch.lora import init_lora
    from audioldm_tpu_torch.pipeline import generate as pg
    from audioldm_tpu_torch.train import trainer as tr

    lcfg = cfg.LoRAConfig()
    cpu_mods = pg.random_modules(
        3, cfg.UNetConfig(**TINY["unet"]), cfg.VAEConfig(**TINY["vae"]), cfg.ClapTextConfig(**TINY["text"]),
        cfg.VocoderConfig(**TINY["voc"]), device="cpu",
    )
    cpu_lora = init_lora(cpu_mods.unet, lcfg, torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for b in cpu_lora.b.values():  # nonzero B, else every gradient of A is zero
            b.copy_(0.1 * torch.randn(b.shape, generator=gen))
    rng = np.random.default_rng(7)
    enc = byte_tokenizer()(["hip hop music", "rain"], max_length=16)
    batch = {"log_mel_spec": rng.standard_normal((2, 1, 160, 8)).astype(np.float32),  # 320 level-0 tokens
             "input_ids": enc["input_ids"], "attention_mask": enc["attention_mask"]}
    draws = {"latent_eps": torch.randn(2, 4, 80, 4, generator=gen), "noise": torch.randn(2, 4, 80, 4, generator=gen),
             "t": torch.tensor([800, 50])}
    gpu_mods, gpu_lora = copy.deepcopy(cpu_mods).to("cuda"), copy.deepcopy(cpu_lora).to("cuda")
    out = {}
    saved = fa._MIN_TOKENS
    fa.set_min_tokens(256)
    try:
        reset_launches()
        for name, mods, lora in (("gpu", gpu_mods, gpu_lora), ("cpu", cpu_mods, cpu_lora)):
            for m in (mods.unet, mods.vae, mods.text_encoder):
                m.requires_grad_(False)
            loss, _ = tr.lora_loss_fn(lora, mods, batch, lcfg.scale, draws=draws)
            loss.backward()
            out[name] = (loss.item(), [p.grad.detach().cpu() for p in lora.parameters()])
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        fa.set_min_tokens(saved)
    routed = [sum(counts[k].values()) for k in ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq")]
    check(routed == [6, 6, 6], f"tiny training step routed {routed} calls through K3, K4, K5 (expect 6 each)")
    loss_err = abs(out["gpu"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    top = max(g.abs().max().item() for g in out["cpu"][1])
    grad_err = max((a - b).abs().max().item() for a, b in zip(*(out[n][1] for n in ("gpu", "cpu"))))
    check(loss_err <= 1e-5, f"tiny fp32 training step, card vs CPU: loss {out['gpu'][0]:.6g} vs {out['cpu'][0]:.6g}, "
                            f"relative {loss_err:.3g} <= 1e-5")
    check(grad_err <= 1e-4 * top and top > 0,
          f"tiny fp32 training step, card vs CPU: max adapter-gradient |d| {grad_err:.3g} <= {1e-4 * top:.3g} "
          f"(1e-4 of the largest entry)")
    return {"loss_rel_err": loss_err, "grad_max_abs_err": grad_err, "grad_max": top}


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
    for name, log in _build.logs.items():
        if log.strip():
            print(f"nvcc {name}:\n{log.strip()}", flush=True)

    phases = set(PHASES) if len(sys.argv) < 2 else set(sys.argv[1].split(","))
    if not phases <= set(PHASES):
        print(f"chip_smoke: phases are {','.join(PHASES)}", file=sys.stderr)
        return 2
    # references in full fp32: cuDNN's fp32 convolutions default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    serve_kernels = flash_cases(torch) + mrf_cases(torch) if "kernels" in phases else []
    train_kernels = flash_train_cases(torch) if "kernels" in phases else []
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True  # the main paths run PyTorch's defaults
    if "serve" in phases:
        path = main_path(torch)
        for case in serve_kernels:  # the serving path's launches at this entry's dtype and shape
            case["launches"] = path["launches"][case["name"]].get(case.pop("variant"), 0)
        print(f"s_per_clip {path['s_per_clip']:.4f} (median of 3 clips; {STEPS} DDIM steps, {SECONDS} s, bf16, CFG 2.5)",
              flush=True)
        path["launches"] = {name: [[list(key), n] for key, n in c.items()] for name, c in path["launches"].items()}
        print("main_path " + json.dumps(path), flush=True)
        del path
        torch.cuda.empty_cache()
    if "train" in phases:
        train = train_path(torch)
        for case in train_kernels:  # the training path's launches, over its TRAIN_STEPS steps
            case["launches"] = train["launches"][case["name"]].get(case.pop("variant"), 0)
            case["launches_per_step"] = case["launches"] / TRAIN_STEPS
        print(f"s_per_step {train['s_per_step']:.4f} ({train['samples_per_s']:.2f} samples/s; median of {TRAIN_STEPS} "
              f"steps, batch 2, bf16 frozen modules, fp32 rank-2 adapters on to_q and to_v)", flush=True)
        train["launches"] = {name: [[list(key), n] for key, n in c.items()] for name, c in train["launches"].items()}
        print("train_path " + json.dumps(train), flush=True)
        torch.cuda.empty_cache()
    if "tiny" in phases:
        torch.backends.cudnn.allow_tf32 = False
        tiny_reference(torch)
        print("tiny_train " + json.dumps(tiny_train_reference(torch)), flush=True)
    kernels = serve_kernels + train_kernels

    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
        return 1
    if phases != set(PHASES):
        print(f"chip_smoke: only {sorted(phases)} ran; the result lines come with a full run", file=sys.stderr)
        return 0
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
