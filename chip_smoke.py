#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (audioldm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # everything; the form that ends in the ``ok`` line
    python3 chip_smoke.py train,tiny  # some of the phases kernels,serve,train,train_cli,samplers,a2a,engine,eval,diag,
                                      # tools,distill,ckpt_drill,parallel,tiny; no result lines
    python3 chip_smoke.py ab          # not part of the default run: the DPM-Solver++ clip, one-pass flag off and on in turns
    python3 chip_smoke.py routes_fp32 # not part of the default run: the engine phase's route checks in fp32, B at 1.0 and 0.3 randn
    python3 chip_smoke.py levels      # the kernels phase's K1 and K3-K5 against sdpa_plain at the UNet's levels 1 and 2 alone

Launch counts are held per UNet call: ten self-attentions at each level whose
tokens and head dim the card's routing rule sends to the flash kernels
(``unet_calls``; "a routed level" below).

1. builds the hand-written CUDA kernels from audioldm_tpu_torch/csrc with nvcc
   and counts, with ``cuobjdump -sass``, the wgmma (HGMMA) and TMA (UTMALDG)
   instructions of every instance of the bf16 K1/K6/K3 kernel, of the bf16
   K4 and K5 kernels and of K7-K10 (on K1's loop), of the fp32 forward loop
   (fp32 K1, K3, K6 and K7-K10) and the fp32 K4 and K5, and the wgmma
   instructions of every instance of K2, with each instance's registers;
2. holds each kernel (K1 flash forward, K2 fused MRF stage, K3 flash forward
   with lse, K4 flash dK/dV, K5 flash dQ, K6 one-pass flash forward) against
   its plain PyTorch version on the card, at the shapes the main paths give
   it (K1 also at d = 32 and at a ragged length with d = 40), and times the
   kernel, the plain version and (for attention) PyTorch's own fused call
   as a yardstick, K3 also on K1's inputs (``k3_device_ms``: the lse
   variant of K1's kernel), K2 beside its 3xTF32 and fp32 FMA bounds; the
   differentiable ``flash_attention`` is also held against autograd through
   plain attention, and K6 against K1; K4 and K5 also at four more head
   dims (32, 40, 64, 128), twice on the same inputs for equal bits, with
   the device time of PyTorch's fused backward beside them; prints the host
   time of a ``flash_attention`` call; and K1 and K2 at the engine phase's
   serving batch (bucket 4): K1 at [8, 8, 4096, 16] bf16, K2 at
   [4, 64, 81936] and [4, 32, 163872]; and at the ``train_cli`` phase's
   validation batch of 2 clips: K1 at [4, 8, 4096, 16], K2 at batch 2;
3. drives the serving path once through ``pipeline.generate.generate``: full
   audioldm-s widths with random weights from a seed, a 10.24 s clip, 50 DDIM
   steps, CFG 2.5, bf16 UNet and VAE, fp32 vocoder. It checks the waveform
   and that every kernel of the path launched (K1 500 times a routed level, K2 twice),
   times two more clips (s/clip is the median of three), and profiles two
   denoise steps for the device's busy share;
4. drives the training path through ``train.Trainer.fit``: the same widths,
   batch 2, bf16 frozen modules, fp32 rank-2 adapters on to_q and to_v, one
   warm-up step and 5 timed steps. It checks the losses, that the adapters
   move and the base weights do not, and that K3, K4 and K5 each launched 10
   times a step at each routed level and K1 never; it times the step's stages and profiles two
   steps. Its batches are random log-mels: the step alone;
4b. drives fine-tuning from files (``train_cli``), the user's path: a
   full-width checkpoint written by ``save_audioldm_checkpoint``, a
   synthesized corpus of 8 captioned 12 s wavs at 22.05 kHz, then ``cli
   train`` in this process, 6 steps at batch 2 through the data pipeline
   (segment, native resample and normalise, log-mel on the card, tokenize,
   add-ons) with one validation (2 clips, 10 DDIM steps, with and without
   the adapters), then ``--resume`` to step 8. It checks the losses, the
   saved and resumed adapters, the base weights, K3-K5 10 launches a step a
   routed level and K1 none in the steps, validation's K1 and K2 launches, validation's
   CLAP and KAD scores (``--clap-dir``, a CLAP model of full geometry and
   random weights), and one ``make_batch`` on the card against the CPU's;
   times s a step, the first batch and the share of a step spent waiting on
   the data; then runs the batch data prep bench
   (``tools/bench_dataprep.py``, BASELINE config 3);
5. drives the other samplers at the same widths and clip (``samplers``):
   DPM-Solver++ 25 steps, LCM 4 steps and DDIM 50 with guidance limited to
   the interval (0.05, 0.65), each timed and held by mel correlation against
   the DDIM 50 clip of the same seed (the vocoder's gain calibrated first);
   then, with the one-pass flag on, the DPM-Solver++ clip again (K6 250
   launches a routed level, K1 none) and a 30 s clip in five MultiDiffusion
   windows (K6 100 a routed level at batch 10); last, ``generate`` in fp32
   (``cli generate --fp32``) on a 5.12 s clip at DDIM 10, with the flag off
   (fp32 K1 100 launches a routed level) and on (fp32 K6 the same), held to
   each other by mel correlation. Every variant's launch counts are held against
   what the timestep grids say they must be;
6. drives audio-to-audio (``a2a``): a synthetic 10.24 s clip through
   ``prepare_init_mel`` and ``generate_from_audio`` as style transfer
   (strength 0.75 of 20 steps) and as time-range inpainting, where the kept
   region of the final latents must equal the init latents;
7. drives the attention diagnostic tool (``diag``): every section of
   ``python -m audioldm_tpu_torch.tools.bench_attn_diag`` (v1-v5) with a few
   timed calls a kernel, so that K7 (five variants; exp2 at block_k 64,
   1024 and N), K8, K9 and K10 launch at [2, 8, 4096, 16] bf16 and K9 also
   at the v5 shapes, all four on K1's Hopper loop; then holds each against
   its plain version, twice for equal bits (K7 exp2 also on sharper logits;
   K9 also at the v5 shapes and at d = 128; K8 at d = 128; K10 at d = 40, 72
   and 120; K7 full, K8, K9 and K10 at a ragged length whose every third row
   has all its logits far below 0; K10 also against K9) and times it beside
   the plain version, K1 and PyTorch's fused call; then the tool's kernel
   functions on fp32 tensors, which reach the fp32 K7-K10
   (``csrc/attn_diag_f32.cu``, on the fp32 K1's loop), each held to its
   plain version the same way at [2, 8, 4096, 16] and at the ragged length;
7b. runs each of the system's tools that the port carries (``tools``):
   the UNet step ablation (K1 10, 20 and 30 launches a step as levels 0, 1
   and 2 route; none on ``sdpa_plain`` or ablated), the pipeline tail and
   the vocoder bench (K2 1 + 1 a clip), the a2a, guidance-interval and
   long-form curves, the proximity gauge, a profiled clip, a train and a
   distill step, ``check_perf`` (passing as the tree stands, failing with
   level-0 attention forced to ``sdpa_plain``), the matmul and narrow-conv
   probes and the cold start of two stages in fresh processes, with few
   steps and iterations;
8. drives multi-LoRA serving (``engine``) through ``serve.ServeEngine`` at
   the same widths: three random rank-2 adapters with a nonzero B, a
   composition, four requests a batch at 10.24 s, DDIM 50, CFG 2.5 on the
   merged route (one adapter), the split route (adapters a, b, a, base in
   sub-batches of 2, 1 and 1), the rank-r route and the hybrid route
   (dense to 256 channels), each timed, profiled and held to its K1 and K2
   launches by shape; then at DDIM 10 the routes against each other and
   against ``generate`` with the adapter merged, and the HTTP daemon on
   127.0.0.1: 8 concurrent requests, a PEFT hot-load and an unload;
8b. drives CLAP evaluation (``eval``) at the ``laion/clap-htsat-fused``
   geometry with random weights: ``cli score`` on two synthesized corpora
   (a clip over 10 s, two at 16 kHz), the same scorer on the CPU against
   it (embeddings, scores, KAD), ``cli generate --best-of 4 --clap`` at
   10.24 s and DDIM 50 (K1 500 launches a routed level at batch 8, K2 1 + 1
   at batch 4; the CPU's rescoring of the candidates picks the one written),
   and times ``embed_audio`` split into host features and the tower;
8c. drives LCM-LoRA consistency distillation (``distill``) at the same
   widths, the UNet and the VAE cast whole to bf16 as ``cli distill``
   casts them: 5 timed ``distill_step``s at batch 2 of random log-mels
   (K1 30 launches a step a routed level for the teacher's two calls and
   the EMA target's, K3-K5 10 each for the student; the EMA identity; the base weights), a
   tiny fp32 distill loss and its gradients on the card against the CPU,
   then ``cli distill`` from files (4 steps, ``--w 2.0,3.0``) and ``cli
   generate --scheduler lcm --steps 4 --lora OUT/model.safetensors`` at
   10.24 s (K1 40 a routed level at batch 1, K2 1 + 1);
8d. runs the checkpoint drill (``ckpt_drill``): a full-width checkpoint
   written by the port, ``cli generate`` as a subprocess in fp32 and in
   bf16, each held to the CPU fp32 replay of the same trajectory;
8e. drives parallelism (``parallel``) at world size 1 over NCCL: TP
   generation at tp 1 (DDIM 50, K1 500 a routed level on the local heads,
   K2 1 + 1) against ``pipeline.generate``, a ``train_step(mesh=)``
   against the plain step (equal bits; K3-K5 10 a routed level),
   ``ServeEngine(mesh=)`` on the engine phase's mixed batch against the
   engine without a mesh (K1 500 a routed level at batch 8, K2 1 + 1), the NCCL all-reduces of a step
   from the profiler, Griffin-Lim on the card against the CPU, and ``cli
   generate --tp 1``, ``train --dp 1``, ``distill --dp 1``, ``serve --dp 1``
   under torchrun; with two cards or more, the same commands at world
   size 2 held against world size 1;
9. holds a tiny fp32 generation (K1), a tiny fp32 DPM-Solver++ generation
   with the one-pass flag on (K6), a tiny fp32 training step (kernels
   routed) and a tiny fp32 HTSAT tower on the card against the same on the
   CPU (plain versions).

Prints the card's name and power limit, ``train_cli``, ``dataprep_*``, ``serving``, ``eval``, ``tools``, ``distill``,
``ckpt_drill`` and ``parallel`` lines, a
``{"kernels": [...]}`` line, and as
its last line ``{"ok": true, "device": {...}}``. Exits nonzero, without that
line, when there is no CUDA GPU or any phase fails.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

# least time the card could take (NVIDIA H100 SXM data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
# "3xtf32": fp32-accurate products as three TF32 tensor-core products (495 TFLOP/s each)
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "3xtf32": 495e12 / 3}
# exp2 runs on the SFU: 16 per SM per clock (CUDA programming guide,
# compute capability 9.0) x 132 SMs x 1.98 GHz boost clock
SFU_EXP2_PER_S = 16 * 132 * 1.98e9
MRF_KS, MRF_DILS = (3, 7, 11), ((1, 3, 5),) * 3

SECONDS = 10.24
STEPS = 50
# the samplers phase's fp32 clip: 5.12 s (2048 tokens at level 0, one kv block of the fp32 K6) at DDIM 10
FP32_ONE_SECONDS, FP32_ONE_STEPS = 5.12, 10
TRAIN_STEPS = 5
PHASES = ("kernels", "serve", "train", "train_cli", "samplers", "a2a", "engine", "eval", "diag", "tools", "distill",
          "ckpt_drill", "parallel", "tiny")  # all run by default; `chip_smoke.py train,tiny` runs some
# only when named: `chip_smoke.py ab` times the dpm++ clip with the one-pass flag off and on in turns;
# `chip_smoke.py routes_fp32` runs the engine phase's route checks in fp32 at B = 1.0 and 0.3 randn;
# `chip_smoke.py levels` runs the kernels phase's ``level_cases`` alone
EXTRA_PHASES = ("ab", "routes_fp32", "levels")
TINY = dict(
    text=dict(vocab_size=300, hidden_size=16, num_hidden_layers=1, num_attention_heads=2, intermediate_size=32,
              max_position_embeddings=514, projection_dim=8),
    unet=dict(in_channels=4, out_channels=4, block_out_channels=(8, 16),
              down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"), up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
              layers_per_block=1, norm_num_groups=4, attention_head_dim=2, projection_class_embeddings_input_dim=8),
    vae=dict(block_out_channels=(8, 16), layers_per_block=1, latent_channels=4, norm_num_groups=4, scaling_factor=0.9),
    voc=dict(model_in_dim=8, upsample_initial_channel=16, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4)),
)

ENGINE_BUCKET = 4  # requests a batch in the engine phase; its UNet batch is 8 under CFG
ENGINE_PROMPTS = ("hip hop music with a heavy bass line", "a dog barking in the rain", "smooth jazz piano in a bar",
                  "birds singing at dawn")
ENGINE_MIXED = ("a", "b", "a", "base")  # the mixed batch of the JAX package's tools/bench_serving.py:253
CHECK_STEPS = 10  # DDIM steps of the engine phase's correctness and daemon runs
CLI_STEPS, CLI_RESUME_STEPS = 6, 8  # cli train's --max-steps in the train_cli phase, then with --resume
CORPUS_CLIPS, CORPUS_SECONDS, CORPUS_SR = 8, 12.0, 22050  # the synthesized corpus: 4 steps an epoch at batch 2
VAL_CLIPS, VAL_STEPS = 2, 10  # the train_cli phase's validation: clips (K1's batch is twice this) and DDIM steps
CLI_ADD_ONS = ("extract_vits_phoneme_and_flant5_text", "calculate_relative_bandwidth")
# bounds of the card's make_batch (log-mel, STFT) against the CPU's and of the device resample against
# resample_np, about 7x what they measured first (H100; log-mel 1.0e-5, STFT 1.5e-5, resample 1.2e-7)
MEL_CARD_VS_CPU, RESAMPLE_CARD_VS_NP = 1e-4, 1e-6
DISTILL_STEPS = 5  # timed distill steps of the distill phase, after one warm-up step
CLI_DISTILL_STEPS, DISTILL_W = 4, "2.0,3.0"  # cli distill's --max-steps and --w in the distill phase
LCM_STEPS = 4  # the distilled adapter's generation: cli generate --scheduler lcm --steps 4
EVAL_CLIPS, EVAL_BEST_OF, EVAL_CHUNK = 8, ENGINE_BUCKET, 8  # clips a corpus, best-of's N, the clips a chunk of embed_audio's timing
EVAL_PROMPT = "hip hop music with a heavy bass line"
# the eval phase's card-vs-CPU bounds, both fp32: normalized embeddings and CLAP scores, KAD (x100 scale)
EVAL_EMB_CARD_VS_CPU, EVAL_SCORE_CARD_VS_CPU, EVAL_KAD_CARD_VS_CPU = 1e-4, 1e-4, 1e-3
# tests/test_clap_audio.py's tiny HTSAT: the tiny phase's card-vs-CPU tower
TINY_CLAP = dict(window_size=2, num_mel_bins=16, spec_size=32, patch_size=4, patch_stride=(4, 4), patch_embeds_hidden_size=8,
                 depths=(2, 2), num_attention_heads=(2, 4), hidden_size=16, projection_dim=8, enable_fusion=True, aff_block_r=4)

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


def device_ms(torch, fn, iters: int = 10, kernel: str | None = None) -> float | None:
    """Device time of one call of ``fn``, which launches each of its kernels
    once, from torch.profiler over ``iters`` calls after a warm-up call.
    Unlike ``cuda_ms`` it leaves out the host's time between launches, which
    sets the pace of back-to-back calls shorter than ~0.05 ms. With
    ``kernel`` (a part of the function name of the kernel under test) only
    that kernel's records count, and only when they are sound
    (``tools.devtime.kernel_ms``: enough of them, of one length, and within
    10% of a CUDA graph's replay of the same calls); None, with what the
    sessions held printed, when no session is. Without ``kernel``: the mean
    time of each kernel, summed over its kernels, from the first of up to
    three sessions that saw device activity."""
    from torch.profiler import ProfilerActivity, profile

    from audioldm_tpu_torch.tools import devtime

    if kernel is not None:
        ms, held = devtime.kernel_ms(fn, kernel, iters)
        if ms is None or not held.startswith(f"{iters} records"):
            print(f"device_ms: {kernel}: {'none' if ms is None else f'{ms:.5f} ms'} from {held}", flush=True)
        return ms
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        per_call = sum(dev_us(e) / e.count for e in prof.key_averages() if str(e.device_type).endswith("CUDA") and e.count)
        if per_call:
            return per_call / 1e3
    return None


def device_ms_per_call(torch, fn, iters: int = 3) -> tuple[float | None, float]:
    """Device time and kernel launches of one call of ``fn`` that launches
    many kernels, some more than once: the profiler's summed kernel time and
    count over ``iters`` calls, after a warm-up call, divided by ``iters``
    (record_function ranges left out). The time is None when it saw no
    device activity."""
    from torch.profiler import ProfilerActivity, profile

    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA") and not getattr(e, "is_user_annotation", False)]
    total = sum(dev_us(e) for e in rows)
    return (total / iters / 1e3 if total else None), sum(e.count for e in rows) / iters


def flash_inputs(torch, seed: int = 0, shapes=None):
    """K1's main-path inputs: [2, 8, 4096, 16] bf16 (10.24 s clip), the
    ragged 4000 tokens of a 10.0 s clip, and fp32 (``--fp32``) at 4096 and
    at the 4016 tokens of a 10.04 s clip (not a whole number of the fp32
    kernel's 64-row kv tiles); or the ``(batch, tokens, dtype)``
    or ``(batch, tokens, dtype, heads, head_dim)`` of ``shapes`` (8 heads of
    16 by default). q, k, v are head views of [B, N, C] projections, as the
    UNet hands them over. Yields ``(n, dtype, q, k, v)``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shapes = shapes or ((2, 4096, torch.bfloat16), (2, 4000, torch.bfloat16), (2, 4096, torch.float32), (2, 4016, torch.float32))
    for b, n, dtype, *hd in shapes:
        h, d = hd or (8, 16)
        q, k, v = (
            torch.randn(b, n, h * d, device="cuda", generator=gen).to(dtype).view(b, n, h, d).transpose(1, 2)
            for _ in range(3)
        )
        yield n, dtype, q, k, v


def mrf_inputs(torch, seed: int = 1, batch: int = 1):
    """K2's main-path inputs, the last two vocoder stages of a 10.24 s clip
    (the second fuses conv_post), ``batch`` clips. Yields ``(c, t, x,
    blocks, post)``."""
    from audioldm_tpu_torch.models.vocoder import HifiGanResidualBlock
    from audioldm_tpu_torch.pipeline.generate import init_random_

    gen = torch.Generator(device="cuda").manual_seed(seed)
    for c, t, with_post in ((64, 81936, False), (32, 163872, True)):
        with torch.device("cuda"):
            blocks = [init_random_(HifiGanResidualBlock(c, k, d), gen) for k, d in zip(MRF_KS, MRF_DILS)]
            post = init_random_(torch.nn.Conv1d(c, 1, 7, padding=3), gen) if with_post else None
        yield c, t, torch.randn(batch, c, t, device="cuda", generator=gen), blocks, post


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


SM90_SOURCE = "audioldm_tpu_torch/csrc/flash_fwd_sm90.cu"
DIAG_SOURCES = ("attn_diag_sm90", "attn_diag_grid3_sm90", "attn_diag_k8_k10_sm90")  # K7, K9, K8 and K10


def k1_source(dtype, torch, one: bool = False, lse: bool = False) -> tuple[str, str]:
    """The source and kernel function that run K1 (or K6, or K3 with
    ``lse``) in ``dtype``."""
    flag = lambda b: "true" if b else "false"
    if dtype == torch.bfloat16:
        return SM90_SOURCE, f"flash_fwd_sm90_kernel<D, {flag(one)}, {flag(lse)}>"
    return "audioldm_tpu_torch/csrc/flash_attention.cu", f"flash_fwd_f32<D, F32::{'K6' if one else 'K3' if lse else 'K1'}>"


def host_us(torch, fn, iters: int = 200) -> float:
    """Host time of one call of ``fn`` in µs: the time to enqueue ``iters``
    calls back to back (the device keeps up or queues them), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def wrapper_host_costs(torch) -> dict:
    """Host µs a ``flash_attention`` call (K1, the tensor maps' encoding
    included) at [1, 8, 4096, 16] and [2, 8, 512, 64] bf16, and the
    encoding of its two tensor maps alone (``flash_fwd_sm90_encode``, 1000
    encodings in one C call)."""
    import ctypes

    from audioldm_tpu_torch.kernels import _build
    from audioldm_tpu_torch.kernels import flash_attention as fa

    out = {}
    for b, n, h, d in ((1, 4096, 8, 16), (2, 512, 8, 64)):
        _, _, q, k, v = next(flash_inputs(torch, 9, ((b, n, torch.bfloat16, h, d),)))
        label = f"[{b},{h},{n},{d}]"
        out[f"flash_attention_host_us {label}"] = host_us(torch, lambda: fa.flash_attention(q, k, v))
        enc = _build.function("flash_fwd_sm90", "flash_fwd_sm90_encode",
                              [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int])
        strides = fa._strides(q, k, v, q)
        t0 = time.perf_counter()
        _build.check(enc(k.data_ptr(), v.data_ptr(), b, h, n, d, strides, 1000), "flash_fwd_sm90_encode")
        out[f"tensor_map_encode_us {label}"] = (time.perf_counter() - t0) / 1000 * 1e6
    return out


def flash_cases(torch):
    """K1 against ``flash_plain`` (its arithmetic: q pre-scaled and rounded,
    exp2 softmax, P rounded to bf16) at the shapes of the serving and
    sampler paths and of two other head dims, by the three bounds of
    ``k1_errors``; each timed beside the plain version, PyTorch's fused
    attention and, on the same inputs, K3 (``k3_device_ms``: the lse
    variant of the same kernel, handed q2 = ``prescale(q)``: K1 plus one
    lse store a row). The fp32 rows (3xTF32 wgmma) carry two bounds, three
    TF32 products a term at the tensor rate (``bound_ms``, ``bound_kind``
    "3xtf32") and fp32 FMA (``fma_bound_ms``); the last row is fp32 K1 at
    the ``serve --fp32`` batch of 4 requests. ``f32_head_dim_checks`` holds
    the fp32 K1 and K3 at the other head dims."""
    import torch.nn.functional as F

    from audioldm_tpu_torch.kernels import flash_attention as fa

    out = []
    # the four shapes of the serving path, then the batch of 1 that the
    # conditional-only steps of limited-interval guidance and lcm give it,
    # level 1 of a 20.48 s clip (d = 32), a ragged length with a head dim
    # that the kernel pads (40 -> 64), and fp32 K1 at the `serve --fp32` batch
    inputs = (list(flash_inputs(torch)) + list(flash_inputs(torch, 5, ((1, 4096, torch.bfloat16),)))
              + list(flash_inputs(torch, 8, ((2, 2048, torch.bfloat16, 8, 32), (1, 2100, torch.bfloat16, 2, 40))))
              + list(flash_inputs(torch, 15, ((8, 4096, torch.float32),))))
    for n, dtype, q, k, v in inputs:
        bf16 = dtype == torch.bfloat16
        e = k1_errors(fa.flash_attention(q, k, v).double(), fa.flash_plain(q, k, v).double(), bf16)
        b, h, _, d = q.shape
        bh = b * h
        b_ms, b_by = bound(4 * bh * n * d * q.element_size(), 4 * bh * n * n * d, "bf16" if bf16 else "3xtf32",
                           exp2=bh * n * n)
        source, function = k1_source(dtype, torch)
        q2 = fa.prescale(q)
        case = {
            "name": "flash_fwd", "route": "cuda", "source": source, "function": function,
            "replaces": "audioldm_tpu/kernels/flash_attention.py:128", "shape": list(q.shape),
            "dtype": "bf16" if bf16 else "fp32", **e,
            "ms": cuda_ms(torch, lambda: fa.flash_attention(q, k, v), 50),
            "device_ms": device_ms(torch, lambda: fa.flash_attention(q, k, v)),
            "k3_device_ms": device_ms(torch, lambda: fa.flash_fwd_lse(q2, k, v)),
            "plain_ms": cuda_ms(torch, lambda: fa.flash_plain(q, k, v), 10),
            "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v), 50),
            "library_device_ms": device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v)),
            "bound_ms": b_ms, "bound_by": b_by,
            "variant": (str(dtype).removeprefix("torch."), tuple(q.shape)),
        }
        if not bf16:
            case.update(bound_kind="3xtf32", fma_bound_ms=bound(4 * bh * n * d * 4, 4 * bh * n * n * d, "fp32")[0])
            check(torch.equal(fa.flash_attention(q, k, v), fa.flash_attention(q, k, v)),
                  f"K1 fp32 {case['shape']}: a second launch on the same inputs gives the same bits")
        check(errors_ok(e),
              f"K1 flash_fwd {case['dtype']} {case['shape']} kernel vs plain: max {e['max_abs_err']:.3g} <= "
              f"{e['tolerance']:.3g}, mean {e['mean_abs_err']:.3g} <= {e['mean_tolerance']:.3g}, "
              f"gain {e['gain_err']:.3g} within {e['gain_tolerance']}")
        # device_ms beside ms: at the batch of 1 the pace of back-to-back calls is the host's, not the kernel's
        print(f"K1 {case['dtype']} {case['shape']} ms {case['ms']:.4f} device_ms {case['device_ms']} k3_device_ms "
              f"{case['k3_device_ms']} library_ms {case['library_ms']:.4f} library_device_ms "
              f"{case['library_device_ms']} bound_ms {b_ms:.4f}"
              + (f" (3xtf32) fma_bound_ms {case['fma_bound_ms']:.4f}" if not bf16 else ""), flush=True)
        out.append(case)
    f32_head_dim_checks(torch, fa)
    costs = wrapper_host_costs(torch)
    print("wrapper_host " + json.dumps(costs), flush=True)
    out[4]["host_us"] = costs  # the batch-of-1 entry
    return out


# fp32 K1 and K3 at the kernel's other tile shapes: d = 32, a ragged length
# with a head dim padded to 64 (40), d = 64, and d = 128 (two CTAs a q tile,
# one stage), two of them ragged
F32_HEAD_DIMS = ((2, 8, 2048, 32), (1, 2, 2100, 40), (1, 4, 1000, 64), (1, 2, 777, 128), (2, 4, 2048, 128))


def f32_head_dim_checks(torch, fa) -> None:
    """fp32 K1 against ``flash_plain`` and K3 against ``flash_fwd_lse_plain``
    at ``F32_HEAD_DIMS`` by the bounds of ``k1_errors`` (lse2: 1e-4), each
    launched twice for equal bits."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    for b, h, n, d in F32_HEAD_DIMS:
        q, k, v = (torch.randn(b, n, h * d, device="cuda", generator=gen).view(b, n, h, d).transpose(1, 2) for _ in range(3))
        label = f"fp32 [{b},{h},{n},{d}]"
        out = fa.flash_attention(q, k, v)
        q2 = fa.prescale(q)
        o3, lse = fa.flash_fwd_lse(q2, k, v)
        ref_o, ref_lse = fa.flash_fwd_lse_plain(q2, k, v)
        for name, got, ref in (("K1", out, fa.flash_plain(q, k, v)), ("K3", o3, ref_o)):
            e = k1_errors(got.double(), ref.double(), False)
            check(errors_ok(e), f"{name} {label} kernel vs plain: max {e['max_abs_err']:.3g} <= {e['tolerance']:.3g}, "
                                f"mean {e['mean_abs_err']:.3g} <= {e['mean_tolerance']:.3g}, gain {e['gain_err']:.3g} "
                                f"within {e['gain_tolerance']}")
        lse_err = (lse - ref_lse).abs().max().item()
        check(lse_err <= 1e-4, f"K3 lse2 {label} kernel vs plain: max|d| {lse_err:.3g} <= 1e-4")
        again = fa.flash_fwd_lse(q2, k, v)
        check(torch.equal(out, fa.flash_attention(q, k, v)) and torch.equal(o3, again[0]) and torch.equal(lse, again[1]),
              f"K1, K3 {label}: a second launch on the same inputs gives the same bits")


def sass_of(source: str) -> dict:
    """Instructions by kernel function in the built library of ``source``
    (``cuobjdump``): the counts of ``_build.SASS_OPS``, all instructions
    (``ALL``) and the registers a thread (``REG``)."""
    import os

    from audioldm_tpu_torch.kernels import _build

    return _build.sass(_build._lib_path(os.path.join(_build.CSRC, f"{source}.cu")))


def sass_counts() -> dict:
    """The SASS of the wgmma kernels: every instance of the bf16 K1/K6/K3
    kernel (``flash_fwd_sm90_kernel<D, ONE, LSE>``: four head dims for K1,
    K6 and K3, 12), of the bf16 K4 and K5 kernels
    (``flash_bwd_dkv_sm90_kernel<D>``, ``flash_bwd_dq_sm90_kernel<D>``: 8)
    and of K7-K10 on K1's loop (``attn_diag_sm90_kernel<D, V, NWG>``: the
    six K7 loops, exp2 a tile and exp2 a block being two, at four head dims,
    24; K9 at one and two warpgroups, 8; K8 and K10, 8) runs on wgmma
    (HGMMA) and TMA (UTMALDG) and uses none of the old designs' mma.sync
    (HMMA) or ldmatrix (LDSM), and no function of a diag library has HMMA;
    every instance of the fp32 forward loop (``flash_fwd_f32<D, F32::V>``:
    K1, K3 and K6 at four head dims in ``flash_attention``, 12; K7's five
    kinds, K8, K9 and K10 at four head dims in ``attn_diag_f32``, 32) and of
    the fp32 K4 and K5 (``flash_bwd_dkv_f32<D>``, ``flash_bwd_dq_f32<D>``:
    8) runs on 3xTF32 wgmma (HGMMA) and TMA, with no HMMA;
    every instance of K2 (``mrf_stage_kernel<CP>``, CP = 16, 32, 64), whose
    tf32 pieces are sm90.cuh's as the fp32 K1's are,
    runs on wgmma (its bulk copies, UBLKCP, are reported). Registers (REG)
    and spills (LDL, STL) are reported, not gated: at d = 32 and d = 128 the
    flash instances spill a few words (the register cap of two CTAs an SM,
    d = 128's accumulators)."""
    wgmma = lambda c: c["HGMMA"] and c["UTMALDG"] and not (c["HMMA"] or c["LDSM"])
    flash = {f: c for f, c in sass_of("flash_fwd_sm90").items() if "flash_fwd_sm90_kernel" in f}
    check(len(flash) == 12 and all(wgmma(c) for c in flash.values()),
          f"flash_fwd_sm90: {len(flash)} kernel instances (expect 12), each with HGMMA and UTMALDG, no HMMA or LDSM")
    bwd = {f: c for f, c in sass_of("flash_bwd_sm90").items() if "_sm90_kernel" in f}
    check(len(bwd) == 8 and all(wgmma(c) for c in bwd.values()),
          f"flash_bwd_sm90: {len(bwd)} kernel instances (expect 8: K4 and K5 at four head dims), each with HGMMA and "
          f"UTMALDG, no HMMA or LDSM")
    diag = {f: c for f, c in sass_of("attn_diag_sm90").items() if "attn_diag_sm90_kernel" in f}
    check(len(diag) == 24 and all(wgmma(c) for c in diag.values()),
          f"attn_diag_sm90: {len(diag)} kernel instances (expect 24: K7's six loops at four head dims), each with HGMMA "
          f"and UTMALDG, no HMMA or LDSM")
    k9 = {f: c for f, c in sass_of("attn_diag_grid3_sm90").items() if "attn_diag_sm90_kernel" in f}
    check(len(k9) == 8 and all(wgmma(c) for c in k9.values()),
          f"attn_diag_grid3_sm90: {len(k9)} kernel instances (expect 8: K9 at one and two warpgroups, four head dims), "
          f"each with HGMMA and UTMALDG, no HMMA or LDSM")
    k8_k10 = {f: c for f, c in sass_of("attn_diag_k8_k10_sm90").items() if "attn_diag_sm90_kernel" in f}
    check(len(k8_k10) == 8 and all(wgmma(c) for c in k8_k10.values()),
          f"attn_diag_k8_k10_sm90: {len(k8_k10)} kernel instances (expect 8: K8 and K10, four head dims), each with "
          f"HGMMA and UTMALDG, no HMMA or LDSM")
    hmma = sum(c["HMMA"] for src in DIAG_SOURCES for c in sass_of(src).values())
    check(hmma == 0, f"{', '.join(DIAG_SOURCES)}: {hmma} HMMA in all their functions (expect 0)")
    tf32 = lambda c: c["HGMMA"] and c["UTMALDG"] and not c["HMMA"]
    f32 = {f: c for f, c in sass_of("attn_diag_f32").items() if "flash_fwd_f32" in f}
    check(len(f32) == 32 and all(tf32(c) for c in f32.values()),
          f"attn_diag_f32: {len(f32)} flash_fwd_f32 instances (expect 32: K7's five variants, K8, K9 and K10 at four "
          f"head dims), each with HGMMA and UTMALDG, no HMMA")
    f32_fwd = {f: c for f, c in sass_of("flash_attention").items() if "flash_fwd_f32" in f}
    check(len(f32_fwd) == 12 and all(tf32(c) for c in f32_fwd.values()),
          f"flash_attention: {len(f32_fwd)} flash_fwd_f32 instances (expect 12: fp32 K1, K3 and K6 at four head dims), "
          f"each with HGMMA and UTMALDG, no HMMA")
    f32_bwd = {f: c for f, c in sass_of("flash_attention_bwd").items() if "_f32" in f}
    check(len(f32_bwd) == 8 and all(tf32(c) for c in f32_bwd.values()),
          f"flash_attention_bwd: {len(f32_bwd)} flash_bwd_*_f32 instances (expect 8: fp32 K4 and K5 at four head "
          f"dims), each with HGMMA and UTMALDG, no HMMA")
    mrf = {f: c for f, c in sass_of("mrf_conv").items() if "mrf_stage_kernel" in f}
    check(len(mrf) == 3 and all(c["HGMMA"] for c in mrf.values()),
          f"mrf_conv: {len(mrf)} mrf_stage_kernel instances (expect 3), each with HGMMA")
    return {**flash, **bwd, **diag, **k9, **k8_k10, **f32, **f32_fwd, **f32_bwd, **mrf}


def errors_ok(e: dict) -> bool:
    return (e["max_abs_err"] <= e["tolerance"] and e["mean_abs_err"] <= e["mean_tolerance"]
            and abs(e["gain_err"]) <= e["gain_tolerance"])


def one_cases(torch):
    """K6 against ``flash_one_plain`` at the shapes the sampler paths give it
    with the one-pass flag on: [2, 8, 4096, 16] bf16 (a CFG step of a 10.24 s
    clip), the ragged 4000 tokens, [10, 8, 4096, 16] bf16 (five MultiDiffusion
    windows under CFG), [2, 8, 2048, 16] fp32 (a 5.12 s clip with ``--fp32``)
    and its ragged neighbour of 2008 tokens (5.02 s; not a whole number of the
    fp32 kernel's 64-row kv tiles), by the three bounds of ``k1_errors``; the
    fp32 rows also launched twice for equal bits, with the profiler's device
    time of the kernel alone (``device_ms``) and two bounds, three TF32
    products a term (``bound_ms``, ``bound_kind`` "3xtf32") and fp32 FMA
    (``fma_bound_ms``). K6 is also held
    against K1 on the same inputs: reported, and gated only at the max
    bound, since the two round differently (K6 sums the rounded P). Last,
    K1 and K6 at [2, 8, 4096, 16] bf16 with one key of every head set to 64
    in every column (kv row 3000, past the first 46 tiles), so that the row
    max of about 7% of the rows jumps by more than 128 (log2 units) late in
    the kv axis: exp2 against a max short of the true one overflows there,
    and K1 rescales by a factor that flushes to 0."""
    import torch.nn.functional as F

    from audioldm_tpu_torch.kernels import flash_attention as fa

    shapes = ((2, 4096, torch.bfloat16), (2, 4000, torch.bfloat16), (10, 4096, torch.bfloat16), (2, 2048, torch.float32),
              (2, 2008, torch.float32))
    out = []
    for n, dtype, q, k, v in flash_inputs(torch, 6, shapes):
        bf16 = dtype == torch.bfloat16
        tag, shape = "bf16" if bf16 else "fp32", list(q.shape)
        k1 = fa.flash_attention(q, k, v).double()
        fa.set_one_pass(True)
        try:
            before = sum(fa.flash_attention.launches_one.values())
            got = fa.flash_attention(q, k, v).double()
            check(sum(fa.flash_attention.launches_one.values()) == before + 1, f"K6 {tag} {shape}: the flag routes the call to K6")
            ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v), 50)
        finally:
            fa.set_one_pass(False)

        def plain():  # two rows of the batch a call: the fp32 logits of all ten at once are 5.4 GB
            return [fa.flash_one_plain(q[i : i + 2], k[i : i + 2], v[i : i + 2]) for i in range(0, q.shape[0], 2)]

        ref = torch.cat(plain()).double()
        e, e1 = k1_errors(got, ref, bf16), k1_errors(got, k1, bf16)
        bh, d = q.shape[0] * 8, 16
        b_ms, b_by = bound(4 * bh * n * d * q.element_size(), 4 * bh * n * n * d, tag if bf16 else "3xtf32", exp2=bh * n * n)
        source, function = k1_source(dtype, torch, one=True)
        extra = {}
        if not bf16:
            fa.set_one_pass(True)
            try:
                same = torch.equal(fa.flash_attention(q, k, v), fa.flash_attention(q, k, v))
                dev = device_ms(torch, lambda: fa.flash_attention(q, k, v), kernel="flash_fwd_f32")
            finally:
                fa.set_one_pass(False)
            check(same, f"K6 fp32 {shape}: a second launch on the same inputs gives the same bits")
            extra = {"same_bits": same, "device_ms": dev, "bound_kind": "3xtf32",
                     "fma_bound_ms": bound(4 * bh * n * d * 4, 4 * bh * n * n * d, "fp32")[0],
                     "k1_device_ms": device_ms(torch, lambda: fa.flash_attention(q, k, v), kernel="flash_fwd_f32")}
        out.append({
            "name": "flash_fwd_one", "route": "cuda", "source": source, "function": function,
            "replaces": "audioldm_tpu/kernels/flash_attention.py:133", "shape": shape, "dtype": tag, **e,
            "vs_k1_max_abs_err": e1["max_abs_err"], "vs_k1_mean_abs_err": e1["mean_abs_err"], "vs_k1_gain_err": e1["gain_err"],
            "ms": ms, "k1_ms": cuda_ms(torch, lambda: fa.flash_attention(q, k, v), 50),
            "plain_ms": cuda_ms(torch, plain, 5),
            "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v), 50),
            "bound_ms": b_ms, "bound_by": b_by, "variant": (str(dtype).removeprefix("torch."), tuple(q.shape)), **extra,
        })
        print(f"K6 {tag} {shape} ms {out[-1]['ms']:.4f} k1_ms {out[-1]['k1_ms']:.4f} plain_ms {out[-1]['plain_ms']:.3f} "
              f"library_ms {out[-1]['library_ms']:.4f} bound_ms {b_ms:.4f}"
              + (f" (3xtf32) fma_bound_ms {extra['fma_bound_ms']:.4f} device_ms {extra['device_ms']} k1_device_ms "
                 f"{extra['k1_device_ms']}" if extra else ""), flush=True)
        check(errors_ok(e), f"K6 flash_fwd_one {tag} {shape} kernel vs plain: max {e['max_abs_err']:.3g} <= {e['tolerance']:.3g}, "
                            f"mean {e['mean_abs_err']:.3g} <= {e['mean_tolerance']:.3g}, gain {e['gain_err']:.3g} within "
                            f"{e['gain_tolerance']}")
        check(e1["max_abs_err"] <= e1["tolerance"], f"K6 vs K1 {tag} {shape}: max {e1['max_abs_err']:.3g} <= {e1['tolerance']:.3g} "
                                                    f"(mean {e1['mean_abs_err']:.3g}, gain {e1['gain_err']:.3g})")
    _, _, q, k, v = next(flash_inputs(torch, 10, ((2, 4096, torch.bfloat16),)))
    k[:, :, 3000] = 64.0
    for one in (False, True):
        fa.set_one_pass(one)
        try:
            got = fa.flash_attention(q, k, v).double()
        finally:
            fa.set_one_pass(False)
        e = k1_errors(got, (fa.flash_one_plain if one else fa.flash_plain)(q, k, v).double(), True)
        check(errors_ok(e), f"{'K6' if one else 'K1'} bf16 [2, 8, 4096, 16] with a key of 64s at kv row 3000: max "
                            f"{e['max_abs_err']:.3g} <= {e['tolerance']:.3g}, mean {e['mean_abs_err']:.3g} <= "
                            f"{e['mean_tolerance']:.3g}, gain {e['gain_err']:.3g} within {e['gain_tolerance']}")
    return out


def flash_train_cases(torch):
    """K3, K4 and K5 against their plain versions at K1's four shapes, with
    a dO laid out as autograd hands it over (the head view of a [B, N, C]
    gradient), all handed q2 = ``prescale(q)`` as the autograd Function
    hands it over. out, dq, dk and dv are held to the three bounds of
    ``k1_errors``, lse2 to max|d| <= 1e-4 (fp32 sums of the same terms in
    another order). K4 and K5 get the plain forward's out and lse2, so their
    errors are their own. K3's device time stands beside the library
    forward's. ``library_ms`` of K3 is the forward of
    ``F.scaled_dot_product_attention``; of K4 and K5 it is its backward,
    which is one PyTorch call for both kernels together: the difference of
    two event timings (forward + backward, forward), and beside it
    ``library_device_ms``, the profiler's kernel time of the backward call
    alone (``torch.autograd.grad`` through a kept graph). K4 and K5 carry
    ``device_ms``; they run twice on the same inputs and must give the same
    bits (no atomics), and ``bwd_head_dim_cases`` holds them at other head
    dims. The fp32 rows' ``bound_ms`` is three TF32 products a term
    (``bound_kind`` "3xtf32"), with the fp32 FMA bound beside it
    (``fma_bound_ms``)."""
    import torch.nn.functional as F

    from audioldm_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2)
    src = "audioldm_tpu_torch/csrc/"
    out = []
    for n, dtype, q, k, v in flash_inputs(torch):
        bf16 = dtype == torch.bfloat16
        tag = "bf16" if bf16 else "fp32"
        dout = torch.randn(2, n, 128, device="cuda", generator=gen).to(dtype).view(2, n, 8, 16).transpose(1, 2)
        q2 = fa.prescale(q)
        ref_o, ref_lse = fa.flash_fwd_lse_plain(q2, k, v)
        o, lse = fa.flash_fwd_lse(q2, k, v)
        ref_dq, ref_dk, ref_dv = fa.flash_bwd_plain(q2, k, v, ref_o, ref_lse, dout)
        delta = (dout.float() * ref_o.float()).sum(dim=-1).contiguous()
        dk, dv = fa.flash_bwd_dkv(q2, k, v, dout, ref_lse, delta)
        dq = fa.flash_bwd_dq(q2, k, v, dout, ref_lse, delta)
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
        check(same_bits(torch, fa, q2, k, v, dout, ref_lse, delta, (dq, dk, dv)),
              f"K4, K5 {tag} [2,8,{n},16]: a second launch on the same inputs gives the same dq, dk, dv bits")

        # SDPA's backward alone: time forward + backward, take the forward off
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        sdpa_fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v), 50)

        def sdpa_both():
            F.scaled_dot_product_attention(ql, kl, vl).backward(dout)
            ql.grad = kl.grad = vl.grad = None

        sdpa_bwd = cuda_ms(torch, sdpa_both, 20) - cuda_ms(torch, lambda: F.scaled_dot_product_attention(ql, kl, vl), 20)
        sdpa_graph = F.scaled_dot_product_attention(ql, kl, vl)
        sdpa_bwd_device, _ = device_ms_per_call(
            torch, lambda: torch.autograd.grad(sdpa_graph, (ql, kl, vl), dout, retain_graph=True), 10)
        del sdpa_graph
        plain_bwd = cuda_ms(torch, lambda: fa.flash_bwd_plain(q2, k, v, ref_o, ref_lse, dout), 5)
        bh, d, es = 16, 16, q.element_size()
        kind = "bf16" if bf16 else "fp32"
        io = bh * n * d * es  # one [B, H, N, D] tensor
        rows = bh * n * 4  # one fp32 [B, H, N] vector
        k3_source, k3_function = k1_source(dtype, torch, lse=True)
        bwd_source = src + ("flash_bwd_sm90.cu" if bf16 else "flash_attention_bwd.cu")
        bwd_fn = "{}_sm90_kernel<D>" if bf16 else "{}_f32<D>"
        work = {
            "flash_fwd_lse": (4 * io + rows, 2, "out", "audioldm_tpu/kernels/flash_attention.py:86", k3_source,
                              lambda: fa.flash_fwd_lse(q2, k, v), lambda: fa.flash_fwd_lse_plain(q2, k, v), sdpa_fwd),
            "flash_bwd_dkv": (6 * io + 2 * rows, 4, "dk", "audioldm_tpu/kernels/flash_attention.py:237", bwd_source,
                              lambda: fa.flash_bwd_dkv(q2, k, v, dout, ref_lse, delta), None, sdpa_bwd),
            "flash_bwd_dq": (5 * io + 2 * rows, 3, "dq", "audioldm_tpu/kernels/flash_attention.py:264", bwd_source,
                             lambda: fa.flash_bwd_dq(q2, k, v, dout, ref_lse, delta), None, sdpa_bwd),
        }
        for name, (nbytes, products, key, replaces, source, run, plain, lib_ms) in work.items():
            tf32 = not bf16  # the fp32 K3, K4 and K5: 3xTF32 wgmma
            b_ms, b_by = bound(nbytes, products * 2 * bh * n * n * d, "3xtf32" if tf32 else kind, exp2=bh * n * n)
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
            if tf32:
                case.update(bound_kind="3xtf32", fma_bound_ms=bound(nbytes, products * 2 * bh * n * n * d, "fp32")[0])
            if name == "flash_fwd_lse":
                case.update(function=k3_function, lse_max_abs_err=lse_err, device_ms=device_ms(torch, run),
                            library_device_ms=device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v)))
                print(f"K3 {tag} {case['shape']} {k3_function} ms {case['ms']:.4f} device_ms {case['device_ms']} "
                      f"library_device_ms {case['library_device_ms']} bound_ms {b_ms:.4f}"
                      + (f" (3xtf32) fma_bound_ms {case['fma_bound_ms']:.4f}" if tf32 else ""), flush=True)
            else:
                case.update(function=bwd_fn.format(name), device_ms=device_ms(torch, run),
                            library_device_ms=sdpa_bwd_device)
                print(f"{'K4' if name == 'flash_bwd_dkv' else 'K5'} {tag} {case['shape']} {case['function']} ms "
                      f"{case['ms']:.4f} device_ms {case['device_ms']} library_ms (backward, both) {lib_ms:.4f} "
                      f"library_device_ms {sdpa_bwd_device} bound_ms {b_ms:.4f}"
                      + (f" (3xtf32) fma_bound_ms {case['fma_bound_ms']:.4f}" if tf32 else ""), flush=True)
            out.append(case)
    bwd_head_dim_cases(torch, fa, gen)
    return out


def same_bits(torch, fa, q2, k, v, dout, lse2, delta, first) -> bool:
    """K4 and K5 launched again on the same inputs give ``first``'s (dq,
    dk, dv) bit for bit."""
    dk, dv = fa.flash_bwd_dkv(q2, k, v, dout, lse2, delta)
    dq = fa.flash_bwd_dq(q2, k, v, dout, lse2, delta)
    return all(torch.equal(a, b) for a, b in zip((dq, dk, dv), first))


# K4 and K5 at other head dims: level 1 of a 20.48 s clip (d = 32), a
# ragged length with a head dim padded to 64 (40), and small shapes at d = 64
# and, ragged, d = 128 (the kernel's other tile widths)
BWD_SHAPES = ((2, 8, 2048, 32), (1, 2, 2100, 40), (1, 4, 1000, 64), (1, 2, 777, 128))


def bwd_head_dim_cases(torch, fa, gen) -> None:
    """K4 and K5 in bf16 and in fp32 against ``flash_bwd_plain`` at
    ``BWD_SHAPES`` by the three bounds of ``k1_errors`` (handed the plain
    forward's out and lse2), twice for equal bits, and the differentiable
    ``flash_attention`` there against autograd through plain attention."""
    for (b, h, n, d), dtype in ((shape, dtype) for dtype in (torch.bfloat16, torch.float32) for shape in BWD_SHAPES):
        bf16 = dtype == torch.bfloat16
        q, k, v, dout = (torch.randn(b, n, h * d, device="cuda", generator=gen).to(dtype).view(b, n, h, d).transpose(1, 2)
                         for _ in range(4))
        label = f"{'bf16' if bf16 else 'fp32'} [{b},{h},{n},{d}]"
        q2 = fa.prescale(q)
        ref_o, ref_lse = fa.flash_fwd_lse_plain(q2, k, v)
        delta = (dout.float() * ref_o.float()).sum(dim=-1).contiguous()
        dk, dv = fa.flash_bwd_dkv(q2, k, v, dout, ref_lse, delta)
        dq = fa.flash_bwd_dq(q2, k, v, dout, ref_lse, delta)
        refs = fa.flash_bwd_plain(q2, k, v, ref_o, ref_lse, dout)
        for name, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
            e = k1_errors(a.double(), r.double(), bf16)
            check(errors_ok(e), f"K4/K5 {name} {label} kernel vs plain: max {e['max_abs_err']:.3g} <= {e['tolerance']:.3g}, "
                                f"mean {e['mean_abs_err']:.3g} <= {e['mean_tolerance']:.3g}, gain {e['gain_err']:.3g} "
                                f"within {e['gain_tolerance']}")
        check(same_bits(torch, fa, q2, k, v, dout, ref_lse, delta, (dq, dk, dv)),
              f"K4, K5 {label}: a second launch on the same inputs gives the same dq, dk, dv bits")
        function_vs_autograd(torch, fa, q, k, v, dout, bf16, label)


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


# the UNet's self-attention at levels 1 and 2 of a batch of 16 clips of
# 10.24 s under CFG: 1024 tokens of d = 32 (down.1, up.2) and 256 of d = 48
# (down.2, up.1), the shapes that set the card's routing threshold
LEVEL_SHAPES = ((32, 8, 1024, 32), (32, 8, 256, 48))
# the kernels' function names in the profiler's records, by launch counter
SYMBOLS = {"flash_fwd": "flash_fwd", "flash_fwd_lse": "flash_fwd", "flash_bwd_dkv": "flash_bwd_dkv",
           "flash_bwd_dq": "flash_bwd_dq"}


def checked_device_ms(torch, fn, iters: int = 10) -> dict:
    """One profiler session of ``iters`` calls of ``fn`` after a warm-up
    call: every kernel's device ms and records a call, and for each flash
    kernel that launched, its records held against its launch counter's
    increase over the session (``checked``; the device ms of a kernel whose
    records do not match is None)."""
    from torch.profiler import ProfilerActivity, profile

    from audioldm_tpu_torch.kernels import launch_counts, reset_launches

    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    fn()
    torch.cuda.synchronize()
    reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    counts = launch_counts()
    rows = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA") and not getattr(e, "is_user_annotation", False)]
    out = {"device_ms": sum(dev_us(e) for e in rows) / iters / 1e3 or None, "kernels": sum(e.count for e in rows) / iters}
    for symbol in sorted({SYMBOLS[c] for c, v in counts.items() if c in SYMBOLS and v}):
        mine = [e for e in rows if symbol in e.key]
        launched = sum(sum(counts[c].values()) for c in SYMBOLS if SYMBOLS[c] == symbol)
        records = sum(e.count for e in mine)
        ok = records == launched and records > 0
        check(ok, f"{symbol}: {records} profiler records for {launched} counted launches")
        out[f"{symbol}_device_ms"] = sum(dev_us(e) for e in mine) / iters / 1e3 if ok else None
    return out


def level_cases(torch):
    """K1, and K3 + K4 + K5 under autograd, against ``sdpa_plain`` at the
    UNet's level-1 and level-2 shapes (``LEVEL_SHAPES``) in bf16 and fp32,
    by device time from the profiler's records checked against the launch
    counters (``checked_device_ms``); the numbers that set the card's
    routing threshold. K1 is held to ``flash_plain`` by ``k1_errors``, the
    differentiable call to autograd through ``sdpa_plain``
    (``function_vs_autograd``). Each K1 row: device ms, bound, the plain
    path's device ms and kernels a call, and the library's
    (``F.scaled_dot_product_attention``); each training row: the forward
    and backward of the flash route (K3, then K4 and K5, with their own
    device ms) against those of ``sdpa_plain``. One line ``levels`` with
    whether the kernels beat the plain path at each shape."""
    import torch.nn.functional as F

    from audioldm_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(21)
    out, wins = [], {}
    for (b, h, n, d), dtype in ((shape, dtype) for shape in LEVEL_SHAPES for dtype in (torch.bfloat16, torch.float32)):
        bf16 = dtype == torch.bfloat16
        tag, kind = ("bf16", "bf16") if bf16 else ("fp32", "3xtf32")
        q, k, v, dout = (torch.randn(b, n, h * d, device="cuda", generator=gen).to(dtype).view(b, n, h, d).transpose(1, 2)
                         for _ in range(4))
        label = f"{tag} [{b},{h},{n},{d}]"
        bh, es = b * h, q.element_size()
        e = k1_errors(fa.flash_attention(q, k, v).double(), fa.flash_plain(q, k, v).double(), bf16)
        check(errors_ok(e), f"K1 {label} kernel vs plain: max {e['max_abs_err']:.3g} <= {e['tolerance']:.3g}, mean "
                            f"{e['mean_abs_err']:.3g} <= {e['mean_tolerance']:.3g}, gain {e['gain_err']:.3g} within "
                            f"{e['gain_tolerance']}")
        function_vs_autograd(torch, fa, q, k, v, dout, bf16, label)
        k1 = checked_device_ms(torch, lambda: fa.flash_attention(q, k, v))
        plain = checked_device_ms(torch, lambda: fa.sdpa_plain(q, k, v))
        lib = checked_device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v))
        b_ms, b_by = bound(4 * bh * n * d * es, 4 * bh * n * n * d, kind, exp2=bh * n * n)
        source, function = k1_source(dtype, torch)
        case = {"name": "flash_fwd", "route": "cuda", "source": source, "function": function,
                "replaces": "audioldm_tpu/kernels/flash_attention.py:128", "shape": [b, h, n, d], "dtype": tag, **e,
                "device_ms": k1["flash_fwd_device_ms"], "plain_device_ms": plain["device_ms"],
                "plain_kernels": plain["kernels"], "library_device_ms": lib["device_ms"], "bound_ms": b_ms,
                "bound_by": b_by, "variant": (str(dtype).removeprefix("torch."), (b, h, n, d))}
        if not bf16:
            case.update(bound_kind="3xtf32", fma_bound_ms=bound(4 * bh * n * d * 4, 4 * bh * n * n * d, "fp32")[0])
        out.append(case)

        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        grads = lambda attend: lambda: torch.autograd.grad(attend(*leaves), leaves, dout)
        flash_fb = checked_device_ms(torch, grads(fa.flash_attention))
        plain_fb = checked_device_ms(torch, grads(fa.sdpa_plain))
        lib_fb = checked_device_ms(torch, grads(F.scaled_dot_product_attention))
        io, rows = bh * n * d * es, bh * n * 4
        for name, nbytes, products in (("flash_fwd_lse", 4 * io + rows, 2), ("flash_bwd_dkv", 6 * io + 2 * rows, 4),
                                       ("flash_bwd_dq", 5 * io + 2 * rows, 3)):
            ms = flash_fb[f"{SYMBOLS[name]}_device_ms"]
            if name == "flash_fwd_lse":  # K3 alone, on the forward's symbol
                ms = checked_device_ms(torch, lambda: fa.flash_fwd_lse(fa.prescale(q), k, v))["flash_fwd_device_ms"]
            b_ms, b_by = bound(nbytes, products * 2 * bh * n * n * d, kind, exp2=bh * n * n)
            out.append({"name": name, "route": "cuda", "shape": [b, h, n, d], "dtype": tag, "device_ms": ms,
                        "bound_ms": b_ms, "bound_by": b_by, "fwd_bwd_device_ms": flash_fb["device_ms"],
                        "fwd_bwd_kernels": flash_fb["kernels"], "plain_fwd_bwd_device_ms": plain_fb["device_ms"],
                        "plain_fwd_bwd_kernels": plain_fb["kernels"], "library_fwd_bwd_device_ms": lib_fb["device_ms"],
                        "variant": (str(dtype).removeprefix("torch."), (b, h, n, d))})
        wins[label] = {"k1": (k1["flash_fwd_device_ms"] or math.inf) < (plain["device_ms"] or 0),
                       "fwd_bwd": (flash_fb["device_ms"] or math.inf) < (plain_fb["device_ms"] or 0)}
        print(f"level {label}: K1 {k1['flash_fwd_device_ms']} device ms against sdpa_plain {plain['device_ms']} "
              f"({plain['kernels']:.0f} kernels) and the library {lib['device_ms']}, bound {out[-4]['bound_ms']:.4f}; "
              f"forward + backward: flash {flash_fb['device_ms']} ({flash_fb['kernels']:.0f} kernels; K4 "
              f"{flash_fb.get('flash_bwd_dkv_device_ms')}, K5 {flash_fb.get('flash_bwd_dq_device_ms')}) against "
              f"sdpa_plain {plain_fb['device_ms']} ({plain_fb['kernels']:.0f} kernels), library {lib_fb['device_ms']} "
              f"({card()})", flush=True)
        del leaves
        torch.cuda.empty_cache()
    print("levels " + json.dumps({"card": card(), "kernels_win": wins}), flush=True)
    return out


def mrf_cases(torch, batch: int = 1):
    """K2 against ``mrf_stage_plain`` (fp32 cuDNN convolutions, TF32 off) at
    the two main-path stages, ``batch`` clips: max|d| <= 1e-4 max|ref| and mean|d| <= 2e-5
    mean|ref|. The kernel's 3xTF32 products keep fp32 accuracy (~1e-6 of
    the mean); TF32 alone is off by ~2^-10 a term, which the mean bound
    catches at every shape, the max bound not always at the main shapes. Each timed (CUDA events and the profiler's
    device time) beside the plain version, with two bounds: three TF32
    products a term at the tensor rate (``bound_ms``) and fp32 FMA
    (``fma_bound_ms``); and the plan the kernel took (tile, ring, CTAs)."""
    from audioldm_tpu_torch.kernels import mrf_conv

    ks, dils = MRF_KS, MRF_DILS
    out = []
    for c, t, x, blocks, post in mrf_inputs(torch, batch=batch):
        post_k = 7 if post is not None else 0
        run = lambda: mrf_conv.mrf_stage(x, blocks, ks, dils, 0.1, post)
        with torch.no_grad():
            ref = mrf_conv.mrf_stage_plain(x, blocks, ks, dils, 0.1, post)
            diff = (run() - ref).abs()
            err = diff.max().item()
            tol = 1e-4 * ref.abs().max().item()
            flops = batch * (2 * c * c * t * 6 * sum(ks) + (2 * c * 7 * t if post is not None else 0))
            nbytes = 4 * (batch * (c * t + (t if post is not None else c * t)) + c * c * 6 * sum(ks))
            b_ms, b_by = bound(nbytes, flops, "3xtf32")
            fma_ms, _ = bound(nbytes, flops, "fp32")
            case = {
                "name": "mrf_stage", "route": "cuda", "source": "audioldm_tpu_torch/csrc/mrf_conv.cu",
                "function": "mrf_stage_kernel<CP>", "replaces": "audioldm_tpu/kernels/mrf_conv.py:120",
                "shape": [batch, c, t], "dtype": "fp32", "post": post is not None, "max_abs_err": err, "tolerance": tol,
                "mean_abs_err": diff.mean().item(), "mean_abs_ref": ref.abs().mean().item(),
                "ms": cuda_ms(torch, run, 5), "device_ms": device_ms(torch, run, 5),
                "plain_ms": cuda_ms(torch, lambda: mrf_conv.mrf_stage_plain(x, blocks, ks, dils, 0.1, post), 5),
                "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "bound_kind": "3xtf32", "fma_bound_ms": fma_ms,
                "plan": mrf_conv.plan(x, ks, dils, 0.1, post_k), "variant": (tuple(x.shape), post_k),
            }
        mean_tol = 2e-5 * case["mean_abs_ref"]
        check(err <= tol and case["mean_abs_err"] <= mean_tol,
              f"K2 mrf_stage [{batch},{c},{t}] post={post is not None}: max|kernel-plain| {err:.3g} <= {tol:.3g}, "
              f"mean {case['mean_abs_err']:.3g} <= {mean_tol:.3g}")
        print(f"K2 [{batch},{c},{t}] ms {case['ms']:.4f} device_ms {case['device_ms']} plain_ms {case['plain_ms']:.4f} "
              f"bound_ms (3xtf32) {b_ms:.4f} fma_bound_ms {fma_ms:.4f} max_abs_err {err:.3g} mean_abs_err "
              f"{case['mean_abs_err']:.3g} plan {json.dumps(case['plan'])}", flush=True)
        out.append(case)
    return out


def k2_inference_mode(torch) -> dict:
    """A full-width vocoder made under ``torch.inference_mode()``: its
    parameters have no version counter, so K2's wrapper keeps no packed
    weights for it and repacks them every call. A 10.24 s mel through it
    with both late stages on K2 (2 launches) against the same vocoder with
    every stage plain (1e-4 max|ref|), and the host µs of the repack a
    vocoder call (``_pack`` of both late stages between synchronisations,
    median of 20) beside the cached lookup of weights made outside
    inference mode."""
    import statistics

    from audioldm_tpu_torch.config import VocoderConfig
    from audioldm_tpu_torch.kernels import mrf_conv
    from audioldm_tpu_torch.models.vocoder import SpeechT5HifiGan
    from audioldm_tpu_torch.pipeline.generate import init_random_
    from audioldm_tpu_torch.tools.bench_vocoder_mrf import FRAMES, k2_launches, late_stages, plain_stages

    def pack_us(voc) -> float:
        nk, dils = len(voc.cfg.resblock_kernel_sizes), voc.cfg.resblock_dilation_sizes
        times = []
        for _ in range(22):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i, c, _ in late_stages(voc):
                mrf_conv._pack(list(voc.resblocks[i * nk : (i + 1) * nk]), dils, c, mrf_conv.kernel_channels(c), "cuda")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times[2:]) * 1e6

    gen = torch.Generator(device="cuda").manual_seed(17)
    with torch.inference_mode():
        with torch.device("cuda"):
            voc = init_random_(SpeechT5HifiGan(VocoderConfig()), gen).eval()
        mel = torch.randn(1, FRAMES, voc.cfg.model_in_dim, device="cuda", generator=gen)
        before = k2_launches()
        wav = voc(mel)
        launched = k2_launches() - before
        with plain_stages(voc):
            ref = voc(mel)
        err = ((wav - ref).abs().max() / ref.abs().max()).item()
        repack_us = pack_us(voc)
    with torch.device("cuda"):
        cached_us = pack_us(init_random_(SpeechT5HifiGan(VocoderConfig()), gen).eval())
    check(launched == 2 and bool(torch.isfinite(wav).all()) and err <= 1e-4,
          f"K2 on a vocoder made under inference_mode: {launched} launches (expect 2), max|kernel-plain| / max|plain| "
          f"{err:.3g} <= 1e-4")
    return {"launches": launched, "max_rel_err": err, "repack_host_us": repack_us, "cached_host_us": cached_us}


def serving_batch_cases(torch, requests: int = ENGINE_BUCKET, seed: int = 12, label: str = "serving batch"):
    """K1 and K2 at a batch of ``requests`` clips: the engine phase's
    serving batch (``ENGINE_BUCKET``) or the ``train_cli`` phase's
    validation clips (``VAL_CLIPS``). K1 at [2 x requests, 8, 4096, 16]
    bf16, the CFG-folded level-0 self-attention, by ``k1_errors``' bounds,
    its device time read from its own profiler records (``tools/devtime.py
    kernel_ms``), beside PyTorch's fused attention; K2 at [requests, 64,
    81936] and [requests, 32, 163872] by ``mrf_cases``' bounds."""
    import torch.nn.functional as F

    from audioldm_tpu_torch.kernels import flash_attention as fa

    n, dtype, q, k, v = next(flash_inputs(torch, seed, ((2 * requests, 4096, torch.bfloat16),)))
    e = k1_errors(fa.flash_attention(q, k, v).double(), fa.flash_plain(q, k, v).double(), True)
    b, h, _, d = q.shape
    b_ms, b_by = bound(4 * b * h * n * d * q.element_size(), 4 * b * h * n * n * d, "bf16", exp2=b * h * n * n)
    source, function = k1_source(dtype, torch)
    run, lib = (lambda: fa.flash_attention(q, k, v)), (lambda: F.scaled_dot_product_attention(q, k, v))
    case = {
        "name": "flash_fwd", "route": "cuda", "source": source, "function": function,
        "replaces": "audioldm_tpu/kernels/flash_attention.py:128", "shape": list(q.shape), "dtype": "bf16", **e,
        "ms": cuda_ms(torch, run, 50), "device_ms": device_ms(torch, run, kernel="flash_fwd_sm90_kernel"),
        "plain_ms": cuda_ms(torch, lambda: fa.flash_plain(q, k, v), 5),
        "library_ms": cuda_ms(torch, lib, 50), "library_device_ms": device_ms(torch, lib),
        "bound_ms": b_ms, "bound_by": b_by, "variant": ("bfloat16", tuple(q.shape)),
    }
    check(errors_ok(e),
          f"K1 flash_fwd bf16 {case['shape']} ({label}) kernel vs plain: max {e['max_abs_err']:.3g} <= "
          f"{e['tolerance']:.3g}, mean {e['mean_abs_err']:.3g} <= {e['mean_tolerance']:.3g}, gain {e['gain_err']:.3g} "
          f"within {e['gain_tolerance']}")
    print(f"K1 bf16 {case['shape']} ms {case['ms']:.4f} device_ms {case['device_ms']} library_ms {case['library_ms']:.4f} "
          f"library_device_ms {case['library_device_ms']} bound_ms {b_ms:.4f}", flush=True)
    return [case] + mrf_cases(torch, batch=requests)


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output"


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
    k2 = sum(counts["mrf_stage"].values())
    count_checks(counts, {"flash_fwd": unet_calls(2, STEPS)}, "main path")
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
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    denoise_profile = profile_denoise(torch, mods, cond, uncond, stages["denoise_s"] / STEPS)
    # two `cli generate --fp32` steps: the UNet cast back to fp32 (generate cast it to bf16 in place)
    from audioldm_tpu_torch.tools import fp32_step

    mods.to("cuda", torch.float32)
    fp32 = fp32_step.step_profile(mods, cond, uncond)
    want = sum(unet_calls(2, 1, dtype="float32").values())
    check(fp32["k1_launches_per_step"] == want and fp32["k1_records_per_step"] == want,
          f"fp32 denoise step: fp32 K1 launched {fp32['k1_launches_per_step']} times a step, "
          f"{fp32['k1_records_per_step']} profiler records (expect {want})")
    print(f"denoise_fp32 device_ms_per_step {fp32['device_ms_per_step']} k1_device_ms_per_step "
          f"{fp32['k1_device_ms_per_step']:.4f} k1_share {fp32['k1_share']} wall_ms_per_step "
          f"{fp32['wall_ms_per_step']:.2f} ({card()})", flush=True)
    return {"s_per_clip": s_per_clip, "clip_s": clip_s, "launches": counts, "stages": stages, "init_s": init_s,
            "peak_mem_gib": peak_gib, "denoise_profile": denoise_profile, "denoise_profile_fp32": fp32}


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
    """LoRA training at full width through ``Trainer.fit``, fed with random
    log-mels (``train_batches``): the training step alone. ``train_cli`` is
    the path fed by real data, through ``cli train`` and the data pipeline;
    its s a step is a different measurement. Then two fp32 training steps
    (``tools/fp32_step.py train_profile``: ``Trainer`` in fp32, as ``cli
    train`` with a ``mixed_precision`` other than bf16 runs it), with the
    fp32 K3, K4 and K5 launched at every routed level (``unet_calls``)."""
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
        count_checks(counts, {k: unet_calls(2, TRAIN_STEPS) for k in ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq")},
                     f"{TRAIN_STEPS} training steps")

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
        with torch.no_grad():  # the text tower alone (bf16 under the trainer's cast, as in JAX)
            prof["text_tower_device_ms"], _ = device_ms_per_call(
                torch, lambda: pg.encode_prompt(mods, two[0]["input_ids"], two[0]["attention_mask"]))
    adapters, adapter_params = len(state.lora.paths()), sum(p.numel() for p in state.lora.parameters())
    del trainer, state, mods
    torch.cuda.empty_cache()

    from audioldm_tpu_torch.tools import fp32_step

    fp32 = fp32_step.train_profile(pg.random_modules(seed=0, device="cuda"), steps=2)
    fp32_counts = {name: {(dtype, tuple(shape)): n for (dtype, shape), n in c} for name, c in fp32["launches"].items()}
    want = unet_calls(2, fp32["steps"], dtype="float32")
    for name, label in (("flash_fwd_lse", "K3"), ("flash_bwd_dkv", "K4"), ("flash_bwd_dq", "K5")):
        per_step, records = fp32[f"{label.lower()}_launches_per_step"], fp32[f"{label.lower()}_records_per_step"]
        check(fp32_counts.get(name) == want and per_step == records == sum(want.values()) / fp32["steps"],
              f"fp32 training step: {label} launched {fp32_counts.get(name)}, {per_step} a step, {records} profiler "
              f"records a step (expect {want})")
    print(f"train_fp32 device_ms_per_step {fp32['device_ms_per_step']} k4_device_ms_per_step "
          f"{fp32['k4_device_ms_per_step']:.4f} k5_device_ms_per_step {fp32['k5_device_ms_per_step']:.4f} k4_share "
          f"{fp32['k4_share']} k5_share {fp32['k5_share']} wall_ms_per_step {fp32['wall_ms_per_step']:.2f} ({card()})",
          flush=True)
    return {"s_per_step": step_med, "step_s": step_s, "samples_per_s": tcfg.train_batch_size / step_med,
            "losses": losses, "launches": counts, "peak_mem_gib": peak, "stages": stages, "train_profile": prof,
            "adapters": adapters, "adapter_params": adapter_params, "fp32_step": fp32, "fp32_launches": fp32_counts}


def write_corpus(folder: str) -> None:
    """``CORPUS_CLIPS`` captioned clips of ``CORPUS_SECONDS`` at
    ``CORPUS_SR``: seeded sums of three tones under a slow swell, and noise,
    so that no segment is silent; clip 0 has a ``.json`` sidecar with
    phonemes (a TTS item for the phoneme add-on)."""
    import numpy as np

    from audioldm_tpu_torch.data.wavio import write_wav

    rng = np.random.default_rng(21)
    t = np.arange(int(CORPUS_SECONDS * CORPUS_SR)) / CORPUS_SR
    for i in range(CORPUS_CLIPS):
        freqs = rng.uniform(60.0, 4000.0, 3)
        wav = sum(rng.uniform(0.1, 0.3) * np.sin(2 * np.pi * f * t + rng.uniform(0, 6.3)) for f in freqs)
        wav = wav * (0.6 + 0.4 * np.sin(2 * np.pi * t / rng.uniform(2.0, 5.0))) + 0.02 * rng.standard_normal(t.shape)
        write_wav(os.path.join(folder, f"clip{i:02d}.wav"), (0.9 * wav / np.abs(wav).max()).astype(np.float32), CORPUS_SR)
        with open(os.path.join(folder, f"clip{i:02d}.txt"), "w") as f:
            f.write(f"synthetic clip {i}: tones at {', '.join(f'{x:.0f}' for x in freqs)} Hz")
    with open(os.path.join(folder, "clip00.json"), "w") as f:
        json.dump({"phonemes": "hɛloʊ wɜːld"}, f)


def write_checkpoint(torch, folder: str, calibrate: bool = False) -> None:
    """A full-width audioldm-s checkpoint of random weights (seed 0) in the
    HF layout, written by the port's ``save_audioldm_checkpoint``, with the
    byte-level vocabulary of ``byte_tokenizer`` in ``tokenizer/``; with
    ``calibrate`` the vocoder's gain is calibrated first (a 10.24 s probe,
    as the samplers phase does), so that a clip survives int16."""
    from audioldm_tpu_torch.ckpt import save_audioldm_checkpoint
    from audioldm_tpu_torch.eval.proximity import calibrate_vocoder_gain
    from audioldm_tpu_torch.pipeline import generate as pg

    mods = pg.random_modules(seed=0, device="cuda")
    if calibrate:
        calibrate_vocoder_gain(mods, (1, int(SECONDS * 100), mods.vocoder.cfg.model_in_dim))
    save_audioldm_checkpoint(folder, mods)
    write_byte_tokenizer(os.path.join(folder, "tokenizer"))
    torch.cuda.empty_cache()


def write_byte_tokenizer(folder: str) -> None:
    """``byte_tokenizer``'s vocabulary as ``vocab.json`` and ``merges.txt``."""
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "vocab.json"), "w") as f:
        json.dump(byte_tokenizer().vocab, f)
    with open(os.path.join(folder, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")


def randomize_clap_(torch, model, generator):
    """Random relative position bias tables (zero in a fresh tower) and
    BatchNorm weights and statistics (identity), so that a check of the
    tower cannot pass over a dropped key or a wrong axis."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("relative_position_bias_table"):
                p.copy_(0.5 * torch.randn(p.shape, generator=generator))
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(torch.rand(m.weight.shape, generator=generator) + 0.5)
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=generator))
                m.running_mean.copy_(0.5 * torch.randn(m.running_mean.shape, generator=generator))
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=generator) + 0.5)
    return model


def write_clap_checkpoint(torch, folder: str) -> None:
    """A CLAP model directory at the ``laion/clap-htsat-fused`` geometry
    (the port's config defaults: RoBERTa 12 x 768, HTSAT 96 -> 768, fusion
    on, projection 512) of random weights from seed 0, written from the
    port's two towers as transformers lays a ``ClapModel`` out:
    ``model.safetensors`` (``text_model.*``, ``text_projection.*``,
    ``audio_model.*``, ``audio_projection.*``), ``config.json`` with
    ``text_config`` and ``audio_config``, and ``byte_tokenizer``'s files
    (the GPU machine has neither transformers nor safetensors)."""
    import dataclasses

    from audioldm_tpu_torch.ckpt import write_safetensors
    from audioldm_tpu_torch.config import ClapAudioConfig, ClapTextConfig
    from audioldm_tpu_torch.models.clap_audio import ClapAudioModelWithProjection
    from audioldm_tpu_torch.models.clap_text import ClapTextModelWithProjection
    from audioldm_tpu_torch.pipeline.generate import init_random_

    gen = torch.Generator().manual_seed(0)
    text = init_random_(ClapTextModelWithProjection(ClapTextConfig()), gen)
    audio = randomize_clap_(torch, init_random_(ClapAudioModelWithProjection(ClapAudioConfig()), gen), gen)
    os.makedirs(folder, exist_ok=True)
    write_safetensors(os.path.join(folder, "model.safetensors"), {**text.state_dict(), **audio.state_dict()})
    with open(os.path.join(folder, "config.json"), "w") as f:
        json.dump({"text_config": dataclasses.asdict(text.cfg), "audio_config": dataclasses.asdict(audio.cfg)}, f)
    write_byte_tokenizer(folder)


def write_eval_corpus(folder: str, seed: int, rates: tuple) -> None:
    """One seeded clip a rate of ``rates``: three tones under a slow swell,
    and noise, 0.5 peak; clip 0 lasts 12 s (over CLAP's 10 s: three crops and
    an overview), the others 3-7 s."""
    import numpy as np

    from audioldm_tpu_torch.data.wavio import write_wav

    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    for i, sr in enumerate(rates):
        t = np.arange(int((12.0 if i == 0 else rng.uniform(3.0, 7.0)) * sr)) / sr
        freqs = rng.uniform(60.0, min(8000.0, 0.4 * sr), 3)
        wav = sum(rng.uniform(0.1, 0.3) * np.sin(2 * np.pi * f * t + rng.uniform(0, 6.3)) for f in freqs)
        wav = wav * (0.6 + 0.4 * np.sin(2 * np.pi * t / rng.uniform(1.0, 4.0))) + 0.03 * rng.standard_normal(t.shape)
        write_wav(os.path.join(folder, f"clip{i:02d}.wav"), (0.5 * wav / np.abs(wav).max()).astype(np.float32), sr)


def train_cli_path(torch) -> dict:
    """LoRA fine-tuning from files through ``cli train``, the user's path:
    a full-width checkpoint written by ``save_audioldm_checkpoint``, a
    synthesized corpus of wavs and captions (``write_corpus``), then
    ``cli.main(["train", ...])`` in this process (so that the launch counts
    can be read), batch 2, ``CLI_STEPS`` steps with validation once (4 steps
    an epoch: ``VAL_CLIPS`` clips at 10.24 s, ``VAL_STEPS`` DDIM steps, with
    the adapters and without), then ``--resume`` to ``CLI_RESUME_STEPS``
    without validation; validation scores CLAP and KAD (``--clap-dir``, a
    full-geometry CLAP directory from ``write_clap_checkpoint``; the KAD
    reference is the first ``VAL_CLIPS`` prepared clips of the corpus).
    The run yaml (add-ons ``CLI_ADD_ONS``, prefetch 2)
    and ``--tensorboard`` go in only where PyYAML and tensorboard import;
    ``--wandb`` never (wandb would reach for the network).

    Checks: every loss finite, one ``train_loss`` line a step; the
    adapters saved and resumed; the base weights as loaded; K3, K4 and K5
    10 launches a step at each routed level (``unet_calls``) in bf16 and K1
    none in the steps; validation's K1 10 x VAL_STEPS x 2 passes at each
    routed level of the batch 2 x VAL_CLIPS and K2 2 x 2; the four scores in ``metrics.jsonl``, finite, once;
    ``native.available()``; one ``make_batch`` on the card
    against the same on the CPU (waveforms, starts and token ids equal,
    log-mel and STFT within ``MEL_CARD_VS_CPU``) and the device ``resample``
    against ``resample_np`` within ``RESAMPLE_CARD_VS_NP``.

    Times (host clock, the loss fetched every step): s a step, the median
    of the steps after the first that ran no validation; the time to the
    first batch (from the iterator's first ``next``); a step's share spent
    in ``next`` on the data iterator; validation's s; peak memory."""
    import contextlib
    import importlib.util
    import io
    import statistics
    import tempfile

    import numpy as np

    from audioldm_tpu_torch import cli
    from audioldm_tpu_torch.ckpt import read_safetensors
    from audioldm_tpu_torch.config import MelConfig
    from audioldm_tpu_torch.data import AudioCaptionDataset, DataPipeline, load_tokenizer, native
    from audioldm_tpu_torch.data.wavio import read_wav
    from audioldm_tpu_torch.kernels import launch_counts, reset_launches
    from audioldm_tpu_torch.lora import import_peft_state_dict
    from audioldm_tpu_torch.ops.resample import resample, resample_np
    from audioldm_tpu_torch.pipeline import generate as pg

    t_phase = time.perf_counter()
    have = {m: importlib.util.find_spec(m) is not None for m in ("yaml", "tensorboard", "matplotlib", "datasets", "tokenizers")}
    print(f"train_cli: packages {json.dumps(have)}; left out: --wandb (network)"
          + ("" if have["yaml"] else ", --config (no PyYAML)") + ("" if have["tensorboard"] else ", --tensorboard")
          + ("" if have["matplotlib"] else ", validation's mel images (no matplotlib)"), flush=True)
    check(native.available(), f"train_cli: the native host library is built and loaded ({native.SO})")
    out = {"packages": have, "native": native.available()}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, corpus, run_dir, clap = (os.path.join(tmp, n) for n in ("ckpt", "corpus", "run", "clap"))
        os.makedirs(corpus)
        t0 = time.perf_counter()
        write_checkpoint(torch, ckpt)
        write_corpus(corpus)
        write_clap_checkpoint(torch, clap)
        out["setup_s"] = time.perf_counter() - t0

        args = ["train", "--checkpoint", ckpt, "--dataset", corpus, "--output", run_dir, "--batch-size", "2",
                "--log-every", "1", "--val-clips", str(VAL_CLIPS), "--val-steps", str(VAL_STEPS),
                "--val-seconds", str(SECONDS), "--val-prompt", "hip hop music with a heavy bass line", "--clap-dir", clap]
        if have["yaml"]:
            import yaml

            with open(os.path.join(tmp, "run.yaml"), "w") as f:
                yaml.safe_dump({"data": {"add_ons": list(CLI_ADD_ONS), "prefetch": 2}}, f)
            args += ["--config", os.path.join(tmp, "run.yaml")]
        if have["tensorboard"]:
            args += ["--tensorboard"]

        # the data iterator, timed from outside: each next() the trainer makes
        timing = []
        real_batches = DataPipeline.batches

        def timed_batches(self, *a, **k):
            it, rec = real_batches(self, *a, **k), {"start": [], "end": []}
            timing.append(rec)
            try:
                while True:
                    rec["start"].append(time.perf_counter())
                    try:
                        b = next(it)
                    except StopIteration:
                        return
                    rec["end"].append(time.perf_counter())
                    yield b
            finally:
                it.close()

        def train(extra):
            printed = io.StringIO()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            DataPipeline.batches = timed_batches
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(printed):
                    trainer, state = cli.main(args + extra)
            finally:
                DataPipeline.batches = real_batches
            torch.cuda.synchronize()
            print(printed.getvalue(), end="", flush=True)
            return trainer, state, printed.getvalue(), launch_counts(), time.perf_counter() - t0, \
                torch.cuda.max_memory_allocated() / 2**30

        trainer, state, printed, counts, run_s, peak = train(["--max-steps", str(CLI_STEPS), "--validate-every", "1"])
        rec = timing[-1]
        steps_s = [b - a for a, b in zip(rec["start"], rec["start"][1:])]  # step k: next() k to next() k + 1
        waits = [e - s_ for s_, e in zip(rec["start"], rec["end"])]
        val_step = 4  # the end of epoch 1 (8 clips, batch 2)
        plain = [dt for k, dt in enumerate(steps_s, 1) if k not in (1, val_step)]
        check(state.step == CLI_STEPS and f"done at step {CLI_STEPS}; final loss" in printed,
              f"train_cli: cli train ran {state.step} steps and says so (expect {CLI_STEPS})")
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        losses = [r["train_loss"] for r in recs if "train_loss" in r]
        scored = [r for r in recs if "clap_score" in r]
        val_keys = ("clap_score", "original_clap_score", "kad_score_lora", "kad_score_original")
        check(len(scored) == 1 and all(isinstance(scored[0].get(k), float) and math.isfinite(scored[0][k]) for k in val_keys),
              f"train_cli: validation logged {({k: scored[0].get(k) for k in val_keys} if scored else 'no scores')} "
              f"(--clap-dir: four finite values, once)")
        out["validation_scores"] = {k: scored[0].get(k) for k in val_keys} if scored else None
        check([r["step"] for r in recs if "train_loss" in r] == list(range(1, CLI_STEPS + 1))
              and all(x is not None and math.isfinite(x) for x in losses),
              f"train_cli: one finite train_loss a step in metrics.jsonl: {losses}")
        count_checks(counts, {"flash_fwd": unet_calls(2 * VAL_CLIPS, VAL_STEPS * 2),
                              **{k: unet_calls(2, CLI_STEPS) for k in ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq")}},
                     f"train_cli: {CLI_STEPS} steps (K3-K5 10 a routed level a step) and a validation (K1 10 a routed "
                     f"level a DDIM step, 2 passes)")
        k2_want = {((VAL_CLIPS, c, t), post): 2 for c, t, post in ((64, 81936, 0), (32, 163872, 7))}
        check(counts["mrf_stage"] == k2_want, f"train_cli: K2 launched {counts['mrf_stage']} (expect {k2_want})")
        val_files = sorted(n for n in os.listdir(run_dir) if n.endswith(".wav"))
        check(len(val_files) == 2 * VAL_CLIPS and all(read_wav(os.path.join(run_dir, n))[0].shape == (int(SECONDS * 16000),)
                                                      for n in val_files),
              f"train_cli: validation wrote {len(val_files)} clips of {SECONDS} s (expect {2 * VAL_CLIPS})")
        saved, rank = import_peft_state_dict(read_safetensors(os.path.join(run_dir, f"checkpoint-{CLI_STEPS}", "model.safetensors")))
        check(rank == 2 and all(torch.equal(saved.get(p_)[0], a.cpu()) and torch.equal(saved.get(p_)[1], b.cpu())
                                for p_, a, b in state.lora.items()) and any(bool(b.any()) for _, _, b in state.lora.items()),
              f"train_cli: the adapters after step {CLI_STEPS} are saved in PEFT form, B moved")
        ref = pg.AudioLDMModules.from_checkpoint(ckpt, device="cuda")
        for m in (ref.unet, ref.vae, ref.text_encoder):
            m.to(torch.bfloat16)  # the trainer's cast
        same = all(torch.equal(x, y) for name in ("unet", "vae", "text_encoder", "vocoder")
                   for x, y in zip(getattr(ref, name).state_dict().values(), getattr(trainer.modules, name).state_dict().values()))
        check(same, "train_cli: base weights as loaded (bf16 cast), after training and validation")
        del ref, trainer, state
        torch.cuda.empty_cache()
        out.update({
            "s_per_step": statistics.median(plain), "step_s": steps_s, "samples_per_s": 2 / statistics.median(plain),
            "first_batch_s": waits[0], "data_wait_s": waits,
            "data_wait_share": [w / dt for w, dt in zip(waits[1:], steps_s[1:])],
            "validation_s": steps_s[val_step - 1] - statistics.median(plain), "run_s": run_s, "peak_mem_gib": peak,
            "losses": losses, "launches": counts,
        })

        trainer, state, printed, counts, run_s, _ = train(["--max-steps", str(CLI_RESUME_STEPS), "--resume", "--validate-every", "0"])
        rec = timing[-1]
        steps_s = [b - a for a, b in zip(rec["start"], rec["start"][1:])]
        check(f"resumed at step {CLI_STEPS}" in printed and state.step == CLI_RESUME_STEPS
              and f"done at step {CLI_RESUME_STEPS}" in printed,
              f"train_cli: --resume from step {CLI_STEPS} ran to step {state.step} (expect {CLI_RESUME_STEPS})")
        n = CLI_RESUME_STEPS - CLI_STEPS
        count_checks(counts, {k: unet_calls(2, n) for k in ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq")},
                     f"train_cli: {n} resumed steps")
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            steps = [json.loads(line)["step"] for line in f if "train_loss" in line]
        check(steps == list(range(1, CLI_RESUME_STEPS + 1)), f"train_cli: train_loss lines for steps {steps}")
        out["resume"] = {"step_s": steps_s, "run_s": run_s, "launches": counts}
        del trainer, state
        torch.cuda.empty_cache()

        # one make_batch on the card against the same on the CPU
        tok = load_tokenizer(os.path.join(ckpt, "tokenizer"))
        got = {dev: DataPipeline(AudioCaptionDataset(corpus), tok, MelConfig(), add_ons=CLI_ADD_ONS, device=dev)
               .make_batch([0, 5], np.random.default_rng(3)) for dev in ("cuda", "cpu")}
        card_b, cpu_b = got["cuda"], got["cpu"]
        equal = (np.array_equal(card_b["waveform"], cpu_b["waveform"]) and np.array_equal(card_b["random_start"], cpu_b["random_start"])
                 and all(torch.equal(card_b[k].cpu(), cpu_b[k]) for k in ("input_ids", "attention_mask"))
                 and np.array_equal(card_b["phoneme_idx"], cpu_b["phoneme_idx"]))
        check(equal and card_b["log_mel_spec"].is_cuda and card_b["input_ids"].is_cuda,
              "train_cli: make_batch on the card and on the CPU: waveforms, starts, token ids, phoneme ids equal; "
              "log-mel and token ids on the card")
        diffs = {k: (card_b[k].cpu() - cpu_b[k]).abs().max().item() for k in ("log_mel_spec", "stft")}
        check(max(diffs.values()) <= MEL_CARD_VS_CPU,
              f"train_cli: make_batch card vs CPU, max|d| {json.dumps(diffs)} <= {MEL_CARD_VS_CPU}")
        wav, sr = read_wav(os.path.join(corpus, "clip03.wav"))
        want = resample_np(wav, sr, 16000)
        on_card = resample(torch.from_numpy(wav).cuda(), sr, 16000).cpu().numpy()
        r_err = float(np.abs(on_card - want).max())
        n_err = float(np.abs(native.resample_native(wav, sr, 16000) - want).max())
        check(on_card.shape == want.shape and r_err <= RESAMPLE_CARD_VS_NP,
              f"train_cli: device resample {sr} -> 16000 vs resample_np, max|d| {r_err:.3g} <= {RESAMPLE_CARD_VS_NP}"
              f" (native vs resample_np {n_err:.3g})")
        out["card_vs_cpu"] = {**diffs, "resample_vs_np": r_err, "native_resample_vs_np": n_err}
    out["train_cli_s"] = time.perf_counter() - t_phase
    return out


def tower_flops(torch, model, feats, longer) -> float:
    """The tower's FLOPs on ``feats`` (``torch.utils.flop_counter``: the
    matmuls and attention products, two a multiply-add; no elementwise op),
    counted on the CPU."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(feats, longer)
    return float(counter.get_total_flops())


def eval_path(torch) -> dict:
    """CLAP evaluation at the ``laion/clap-htsat-fused`` geometry, random
    weights from seed 0 (``write_clap_checkpoint``), the user's entry points:

    - ``cli score`` in this process on two corpora of ``EVAL_CLIPS`` clips
      (``write_eval_corpus``: one of 12 s, two of the generated ones at 16
      kHz for the resample): its JSON, scores in [0, 1], a finite KAD;
    - the same ``ClapScorer`` on the CPU, fp32: normalised audio and text
      embeddings, CLAP scores and KAD within ``EVAL_*_CARD_VS_CPU`` of the
      card's; the KAD bandwidth off its 1.0 fallback and an embedding spread
      above 1e-3, so that the agreement is not vacuous;
    - ``cli generate --best-of EVAL_BEST_OF --clap`` on a full-width
      checkpoint (``write_checkpoint``), 10.24 s, DDIM 50: K1 500 launches
      at [2 x N, 8, 4096, 16] bf16 and K2 1 + 1 at batch N; the CPU rescores
      the candidates (caught on their way to ``ClapScorer.to_48k``) and
      must pick the one the card wrote; the whole call timed.

    Times: ``embed_audio`` of ``EVAL_CHUNK`` clips in one chunk (host clock,
    median of 3), split into the host features (``batch_fused_features``)
    and the tower on the card (CUDA events over back-to-back calls; the
    profiler's summed kernel time a call, "unchecked": not held against a
    graph replay); the tower's FLOPs a clip counted on the CPU and its fp32
    bound a chunk."""
    import contextlib
    import io
    import re
    import statistics
    import tempfile

    import numpy as np

    from audioldm_tpu_torch import cli
    from audioldm_tpu_torch.data.wavio import read_wav, write_wav
    from audioldm_tpu_torch.eval import clap_features, metrics
    from audioldm_tpu_torch.eval.scoring import ClapScorer, _load_dir_48k
    from audioldm_tpu_torch.kernels import launch_counts, reset_launches

    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        clap, gen_dir, ref_dir, ckpt = (os.path.join(tmp, n) for n in ("clap", "gen", "ref", "ckpt"))
        t0 = time.perf_counter()
        write_clap_checkpoint(torch, clap)
        write_eval_corpus(gen_dir, 31, (48000,) * (EVAL_CLIPS - 2) + (16000,) * 2)
        write_eval_corpus(ref_dir, 32, (48000,) * EVAL_CLIPS)
        out["setup_s"] = time.perf_counter() - t0

        # cli score, the user's surface
        printed = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            results = cli.main(["score", "--checkpoint", clap, "--generated", gen_dir, "--reference", ref_dir,
                                "--prompt", EVAL_PROMPT, "--output", os.path.join(tmp, "scores.json")])
        torch.cuda.synchronize()
        out["score_cli_s"] = time.perf_counter() - t0
        with open(os.path.join(tmp, "scores.json")) as f:
            written = json.load(f)
        keys = {"num_generated", "clap_scores", "clap_score_mean", "num_reference", "kad"}
        check(written == results and set(results) == keys and results["num_generated"] == results["num_reference"] == EVAL_CLIPS,
              f"eval: cli score wrote {sorted(written)} for {written.get('num_generated')} / {written.get('num_reference')} clips")
        scores = np.asarray(results["clap_scores"])
        check(bool(((scores >= 0) & (scores <= 1)).all()) and math.isfinite(results["kad"]),
              f"eval: cli score's CLAP scores in [0, 1] ({scores.min():.4f}-{scores.max():.4f}), KAD {results['kad']:.6g} finite")
        out["cli_score"] = results

        # the same scorer on the CPU
        scorers = {dev: ClapScorer.from_checkpoint(clap, device=dev) for dev in ("cuda", "cpu")}
        wavs = {dev: (_load_dir_48k(s, gen_dir), _load_dir_48k(s, ref_dir)) for dev, s in scorers.items()}
        emb = {dev: [s.embed_audio(w).cpu() for w in wavs[dev]] for dev, s in scorers.items()}
        text = {dev: s.embed_text([EVAL_PROMPT, "rain on a tin roof"]).cpu() for dev, s in scorers.items()}
        cpu_scores = scorers["cpu"].clap_scores(wavs["cpu"][0], EVAL_PROMPT)
        cpu_kad = scorers["cpu"].kad(*wavs["cpu"][::-1])
        diffs = {
            "resample_48k": max(float(np.abs(a - b).max()) for a, b in zip(wavs["cuda"][0], wavs["cpu"][0])),
            "audio_embeds": max((a - b).abs().max().item() for a, b in zip(emb["cuda"], emb["cpu"])),
            "text_embeds": (text["cuda"] - text["cpu"]).abs().max().item(),
            "clap_scores": float(np.abs(scores - cpu_scores).max()), "kad": abs(results["kad"] - cpu_kad),
        }
        bandwidth = metrics.median_pairwise_distance(emb["cpu"][0]).item()
        spread = metrics.median_pairwise_distance(torch.cat(emb["cpu"])).item()
        check(diffs["audio_embeds"] <= EVAL_EMB_CARD_VS_CPU and diffs["text_embeds"] <= EVAL_EMB_CARD_VS_CPU,
              f"eval: normalised embeddings card vs CPU, audio {diffs['audio_embeds']:.3g} text {diffs['text_embeds']:.3g} "
              f"<= {EVAL_EMB_CARD_VS_CPU}")
        check(diffs["clap_scores"] <= EVAL_SCORE_CARD_VS_CPU and diffs["kad"] <= EVAL_KAD_CARD_VS_CPU,
              f"eval: cli score vs the CPU's scorer, CLAP scores {diffs['clap_scores']:.3g} <= {EVAL_SCORE_CARD_VS_CPU}, "
              f"KAD {diffs['kad']:.3g} <= {EVAL_KAD_CARD_VS_CPU} (KAD {results['kad']:.6g} / {cpu_kad:.6g})")
        check(bandwidth > 1e-6 and spread > 1e-3,
              f"eval: not vacuous: KAD bandwidth {bandwidth:.4g} off the 1.0 fallback's 1e-6, embedding spread {spread:.4g} > 1e-3")
        out["card_vs_cpu"] = {**diffs, "kad_cpu": cpu_kad, "bandwidth": bandwidth, "embed_spread": spread}

        # embed_audio of a chunk: host features, then the tower on the card
        card = scorers["cuda"]
        chunk = wavs["cuda"][0][:EVAL_CHUNK]
        embed_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            card.embed_audio(chunk, batch_size=EVAL_CHUNK)
            torch.cuda.synchronize()
            embed_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        feats, longer = clap_features.batch_fused_features(chunk)
        features_s = time.perf_counter() - t0
        feats_d, longer_d = feats.cuda(), longer.cuda()
        with torch.no_grad():
            tower = lambda: card.audio_model(feats_d, longer_d)
            tower_ms = cuda_ms(torch, tower, 5)
            tower_dev_ms, tower_kernels = device_ms_per_call(torch, tower)
        flops = tower_flops(torch, scorers["cpu"].audio_model, feats[:1], longer[:1])
        weights = sum(p.numel() * p.element_size() for p in card.audio_model.parameters())
        b_ms, b_by = bound(weights + feats.numel() * 4 + EVAL_CHUNK * 512 * 4, EVAL_CHUNK * flops, "fp32")
        out["embed_audio"] = {
            "chunk": EVAL_CHUNK, "ms_per_clip": 1e3 * statistics.median(embed_s) / EVAL_CHUNK, "embed_s": embed_s,
            "host_features_ms_per_clip": 1e3 * features_s / EVAL_CHUNK, "tower_ms_per_chunk": tower_ms,
            "tower_device_ms_per_chunk": tower_dev_ms, "tower_device_ms_checked": False, "tower_kernels": tower_kernels,
            "tower_gflop_per_clip": flops / 1e9, "tower_bound_ms_per_chunk": b_ms, "tower_bound_by": b_by,
        }
        del feats_d, longer_d, scorers, emb, wavs
        torch.cuda.empty_cache()

        # generate --best-of N on a full-width checkpoint
        write_checkpoint(torch, ckpt)
        caught = {"candidates": [], "scores": []}
        real_to_48k, real_scores = ClapScorer.to_48k, ClapScorer.clap_scores

        def to_48k(self, waveforms, sample_rate):
            caught["candidates"].append(np.array(waveforms))
            return real_to_48k(self, waveforms, sample_rate)

        def clap_scores(self, waveforms_48k, prompt):
            caught["scores"].append(real_scores(self, waveforms_48k, prompt))
            return caught["scores"][-1]

        best_wav = os.path.join(tmp, "best.wav")
        printed = io.StringIO()
        ClapScorer.to_48k, ClapScorer.clap_scores = to_48k, clap_scores
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(printed):
                cli.main(["generate", "--checkpoint", ckpt, "--prompt", EVAL_PROMPT, "--steps", str(STEPS), "--seconds",
                          str(SECONDS), "--best-of", str(EVAL_BEST_OF), "--clap", clap, "--output", best_wav])
        finally:
            ClapScorer.to_48k, ClapScorer.clap_scores = real_to_48k, real_scores
        torch.cuda.synchronize()
        best_of_s = time.perf_counter() - t0
        counts = launch_counts()
        print(printed.getvalue(), end="", flush=True)
        n = EVAL_BEST_OF
        count_checks(counts, {"flash_fwd": unet_calls(2 * n, STEPS)},
                     f"eval: generate --best-of {n} (K1 10 a routed level a DDIM step at the batch of {n} under CFG)")
        k2_want = {((n, c, t), post): 1 for c, t, post in ((64, 81936, 0), (32, 163872, 7))}
        check(counts["mrf_stage"] == k2_want, f"eval: best-of's K2 launched {counts['mrf_stage']} (expect {k2_want})")
        m = re.search(r"kept candidate (\d+)", printed.getvalue())
        cands, card_scores = caught["candidates"][0], caught["scores"][0]
        rescored = ClapScorer.from_checkpoint(clap, device="cpu")
        cpu_scores = rescored.clap_scores(rescored.to_48k(cands, 16000), EVAL_PROMPT)
        pick = int(np.argmax(cpu_scores))
        write_wav(os.path.join(tmp, "pick.wav"), cands[pick], 16000)
        same = np.array_equal(read_wav(best_wav)[0], read_wav(os.path.join(tmp, "pick.wav"))[0])
        margin = float(np.sort(cpu_scores)[-1] - np.sort(cpu_scores)[-2])
        check(m is not None and int(m[1]) == pick and same and cands.shape == (n, int(SECONDS * 16000)),
              f"eval: best-of kept candidate {m and m[1]}, the CPU's rescoring picks {pick} (margin {margin:.3g}); "
              f"the written wav is that candidate: {same}")
        check(float(np.abs(card_scores - cpu_scores).max()) <= EVAL_SCORE_CARD_VS_CPU,
              f"eval: best-of's card scores vs the CPU's, max|d| {float(np.abs(card_scores - cpu_scores).max()):.3g} "
              f"<= {EVAL_SCORE_CARD_VS_CPU}")
        out["best_of"] = {"n": n, "s": best_of_s, "kept": pick, "card_scores": card_scores.tolist(),
                          "cpu_scores": cpu_scores.tolist(), "margin": margin, "launches": counts}
    out["eval_s"] = time.perf_counter() - t_phase
    return out


def tiny_clap_reference(torch) -> float:
    """A tiny fp32 HTSAT (``TINY_CLAP``, random bias tables and BatchNorm)
    on the card against the same on the CPU, at the CPU tests' 1e-4: a clip
    that is not longer at T = 63 (the bicubic resize) beside one that is."""
    from audioldm_tpu_torch.config import ClapAudioConfig
    from audioldm_tpu_torch.models.clap_audio import ClapAudioModelWithProjection
    from audioldm_tpu_torch.pipeline.generate import init_random_

    gen = torch.Generator().manual_seed(8)
    cpu = randomize_clap_(torch, init_random_(ClapAudioModelWithProjection(ClapAudioConfig.from_hf(TINY_CLAP)), gen), gen).eval()
    feats = torch.randn(2, 4, 63, 16, generator=gen)
    longer = torch.tensor([False, True])
    with torch.no_grad():
        want = cpu(feats, longer)["audio_embeds"]
        got = cpu.to("cuda")(feats.cuda(), longer.cuda())["audio_embeds"].cpu()
    err = (got - want).abs().max().item()
    check(err <= 1e-4 and want.abs().max().item() > 1e-3,
          f"tiny fp32 HTSAT, card vs CPU: max|d| {err:.3g} <= 1e-4 (embeddings to {want.abs().max().item():.3g})")
    return err


def routes_fp32_path(torch) -> dict:
    """The engine phase's route checks (``route_checks``) with the UNet and
    VAE in fp32 (``ServeEngine(dtype=torch.float32)``, ``generate`` in fp32
    for the references), adapters drawn as the engine phase draws them but
    with B at 1.0 randn and at 0.3 randn, at DDIM 10. Says whether the
    routes' distance from their own merge at 1.0 randn in bf16 is bf16's
    rounding: in fp32 a merged weight and an unmerged product differ only
    in the order of fp32 sums. TF32 is off for the phase (cuDNN's fp32
    convolutions and matmuls), which the other phases leave on."""
    from audioldm_tpu_torch import config as cfg
    from audioldm_tpu_torch.eval.proximity import calibrate_vocoder_gain
    from audioldm_tpu_torch.lora import init_lora
    from audioldm_tpu_torch.pipeline import generate as pg
    from audioldm_tpu_torch.serve import AdapterBank, ServeEngine

    t_phase = time.perf_counter()
    mods = pg.random_modules(seed=0, device="cuda")
    calibrate_vocoder_gain(mods, (1, int(SECONDS * 100), 64))
    lcfg, tok, fp32 = cfg.LoRAConfig(), byte_tokenizer(), torch.float32
    names = {"merged": ["a"] * ENGINE_BUCKET, "split": list(ENGINE_MIXED), "rank_r": list(ENGINE_MIXED),
             "hybrid": list(ENGINE_MIXED)}
    out = {}
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    for scale in (1.0, 0.3):
        gen = torch.Generator().manual_seed(0)

        def draw():
            lora = init_lora(mods.unet, lcfg, gen)
            with torch.no_grad():
                for b in lora.b.values():
                    b.copy_(scale * torch.randn(b.shape, generator=gen))
            return lora

        adapters = {name: draw() for name in ("a", "b", "c")}  # c keeps the engine phase's draws
        bank = AdapterBank.from_adapters({n: adapters[n] for n in ("a", "b")}, lcfg, device="cuda")
        fine = ServeEngine(mods, tok, lcfg, bank=bank, bucket_sizes=(1, 2, ENGINE_BUCKET), dtype=fp32)
        fine.add_composed("ab", {"a": 0.5, "b": 0.5})
        engines = {"merged": fine, "split": fine,
                   "rank_r": ServeEngine(mods, tok, lcfg, bank=bank, bucket_sizes=(ENGINE_BUCKET,), dtype=fp32),
                   "hybrid": ServeEngine(mods, tok, lcfg, bank=bank, bucket_sizes=(ENGINE_BUCKET,), dense_lora_max_dim=256,
                                         dtype=fp32)}
        out[f"B={scale} randn"] = route_checks(torch, mods, engines, names, adapters, lcfg, tok, fp32, f"routes_fp32 B={scale}")
        del engines, fine, bank
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    out["routes_fp32_s"] = time.perf_counter() - t_phase
    return out


def wave_checks(torch, wav, seconds: float, label: str) -> None:
    n = int(seconds * 16000)
    check(tuple(wav.shape) == (1, n), f"{label}: waveform shape {tuple(wav.shape)} == (1, {n})")
    peak = wav.abs().max().item()
    check(bool(torch.isfinite(wav).all()) and 1e-3 < peak <= 1.0, f"{label}: waveform finite, 1e-3 < peak {peak:.3g} <= 1")


# the audioldm-s UNet's self-attention levels as (head dim, downsampling of both latent axes): ten calls a UNet call
# at each, two in each of a down block's two transformers and an up block's three
UNET_LEVELS = ((16, 1), (32, 2), (48, 4))


def unet_calls(rows: int, calls: int, seconds: float = SECONDS, dtype: str = "bfloat16", heads: int = 8) -> dict:
    """The self-attention launches of ``calls`` UNet calls at a batch of
    ``rows`` on a clip of ``seconds`` that the card sends to a flash kernel,
    by variant ``(dtype, (rows, heads, n, d))``: ten a call at each level
    whose tokens and head dim pass ``flash_attention.routes`` on CUDA."""
    import torch

    from audioldm_tpu_torch.kernels import flash_attention as fa

    frames = -(-int(seconds * 16000 / 160) // 4)  # the latent's frames: mel frames over the VAE's 4, rounded up
    out = {}
    for d, f in UNET_LEVELS:
        n = -(-frames // f) * (16 // f)
        if fa.routes(torch.device("cuda"), n, n, d):
            out[(dtype, (rows, heads, n, d))] = 10 * calls
    return out


def count_checks(counts: dict, expect: dict, label: str) -> None:
    """Every flash kernel's launches by variant against ``expect`` (kernel
    name -> {variant: launches}); a kernel that ``expect`` leaves out must
    not have launched."""
    for name in ("flash_fwd", "flash_fwd_one", "flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq"):
        want = expect.get(name, {})
        check(counts[name] == want, f"{label}: {name} launched {counts[name]} (expect {want})")


def samplers_path(torch) -> dict:
    """The other samplers at full width: one 512-token prompt, seed 0, bf16,
    batch 1, the vocoder's gain calibrated so that the proximity numbers are
    neither silence nor a square wave; last, ``generate`` in fp32 (as ``cli
    generate --fp32`` runs it) on a 5.12 s clip at DDIM 10 with the one-pass
    flag off (the fp32 K1) and on (the fp32 K6 at every routed level), held
    to each other by mel correlation."""
    import statistics

    from audioldm_tpu_torch.eval.proximity import calibrate_vocoder_gain, mel_correlation
    from audioldm_tpu_torch.kernels import flash_attention as fa
    from audioldm_tpu_torch.kernels import launch_counts, reset_launches
    from audioldm_tpu_torch.models.lcm import lcm_inference_timesteps
    from audioldm_tpu_torch.models.scheduler import inference_timesteps
    from audioldm_tpu_torch.pipeline import generate as pg

    mods = pg.random_modules(seed=0, device="cuda")
    gain = calibrate_vocoder_gain(mods, (1, int(SECONDS * 100), 64))
    tok = byte_tokenizer()
    enc, unc = tok(["hip hop music"]), tok([""])
    args = (mods, enc["input_ids"], enc["attention_mask"], unc["input_ids"], unc["attention_mask"])
    interval, long_s, win_s = (0.05, 0.65), 30.0, 10.24
    base = dict(seed=0, audio_length_in_s=SECONDS, guidance_scale=2.5)
    fp32 = base | dict(num_inference_steps=FP32_ONE_STEPS, audio_length_in_s=FP32_ONE_SECONDS, dtype=torch.float32)
    variants = {  # name -> (one-pass flag, generate's options)
        "ddim50": (False, base | dict(num_inference_steps=STEPS)),
        "dpmpp25": (False, base | dict(num_inference_steps=25, scheduler="dpm++")),
        "lcm4": (False, base | dict(num_inference_steps=4, scheduler="lcm")),
        "gi50": (False, base | dict(num_inference_steps=STEPS, guidance_interval=interval)),
        "dpmpp25_one": (True, base | dict(num_inference_steps=25, scheduler="dpm++")),
        "window30s_one": (True, base | dict(num_inference_steps=10, audio_length_in_s=long_s, window_seconds=win_s, window_overlap=0.5)),
        # `cli generate --fp32` (the UNet and VAE cast to fp32) on a 5.12 s clip, whose 2048 tokens K6 takes in fp32
        "fp32_ddim10": (False, fp32),
        "fp32_ddim10_one": (True, fp32),
    }

    # what the timestep grids and the window geometry say the launches must be: ten attentions a UNet call at each
    # routed level (with the one-pass flag every routed level's kv axis is one block: K6 takes them all)
    ts = inference_timesteps(mods.ddim_cfg, STEPS)
    inside = int(((ts >= interval[0] * 999) & (ts <= interval[1] * 999)).sum())
    frames, stride = pg.window_params(mods, win_s, 0.5)
    n_win = len(pg.window_starts(pg.latent_shape(mods, 1, long_s)[2], frames, stride))
    fp32_clip = dict(seconds=FP32_ONE_SECONDS, dtype="float32")  # 128 x 16 latent tokens at level 0
    expect = {
        "ddim50": {"flash_fwd": unet_calls(2, STEPS)},
        "dpmpp25": {"flash_fwd": unet_calls(2, 25)},
        "lcm4": {"flash_fwd": unet_calls(1, len(lcm_inference_timesteps(mods.ddim_cfg, 4)))},
        "gi50": {"flash_fwd": unet_calls(2, inside) | unet_calls(1, STEPS - inside)},
        "dpmpp25_one": {"flash_fwd_one": unet_calls(2, 25)},
        "window30s_one": {"flash_fwd_one": unet_calls(2 * n_win, 10)},
        "fp32_ddim10": {"flash_fwd": unet_calls(2, FP32_ONE_STEPS, **fp32_clip)},
        "fp32_ddim10_one": {"flash_fwd_one": unet_calls(2, FP32_ONE_STEPS, **fp32_clip)},
    }
    check(0 < inside < STEPS and n_win == 5 and frames == 256, f"interval holds {inside} of {STEPS} steps; {n_win} windows of {frames} frames")

    def clip(name, **override):
        """One clip of a variant, synchronised: ``(waveform, seconds)``."""
        one, kw = variants[name]
        fa.set_one_pass(one)
        try:
            t0 = time.perf_counter()
            wav = pg.generate(*args, **(kw | override))
            torch.cuda.synchronize()
            return wav, time.perf_counter() - t0
        finally:
            fa.set_one_pass(False)

    out, wavs = {"vocoder_gain": gain}, {}
    for name, (_, kw) in variants.items():
        clip(name, num_inference_steps=2)  # warm-up
        reset_launches()
        wav, s0 = clip(name)
        counts = launch_counts()
        clip_s = [s0] + [clip(name)[1] for _ in range(2)]
        wave_checks(torch, wav, kw["audio_length_in_s"], f"samplers {name}")
        count_checks(counts, expect[name], f"samplers {name}")
        wavs[name] = wav[0].cpu().numpy()
        out[name] = {"s_per_clip": statistics.median(clip_s), "clip_s": clip_s, "launches": counts}
    for name in ("dpmpp25", "lcm4", "gi50", "dpmpp25_one"):
        out[name]["mel_correlation_vs_ddim50"] = mel_correlation(wavs[name], wavs["ddim50"])
    out["dpmpp25_one"]["mel_correlation_vs_dpmpp25"] = mel_correlation(wavs["dpmpp25_one"], wavs["dpmpp25"])
    check(out["dpmpp25_one"]["mel_correlation_vs_dpmpp25"] >= 0.9,
          f"samplers: the dpm++ clip through K6 stays at the clip through K1, mel correlation "
          f"{out['dpmpp25_one']['mel_correlation_vs_dpmpp25']:.4f} >= 0.9")
    corr = out["fp32_ddim10_one"]["mel_correlation_vs_fp32_ddim10"] = mel_correlation(wavs["fp32_ddim10_one"], wavs["fp32_ddim10"])
    check(corr >= 0.9, f"samplers: the fp32 {FP32_ONE_SECONDS} s clip through the fp32 K6 stays at the clip through the "
                       f"fp32 K1, mel correlation {corr:.4f} >= 0.9")
    return out


def one_pass_ab(torch) -> dict:
    """The full-width dpm++ 25 clip with the one-pass flag off and on in
    turns (off, on, on, off, off, on): does K6 move s/clip beyond the spread
    between runs? Reported only."""
    from audioldm_tpu_torch.kernels import flash_attention as fa
    from audioldm_tpu_torch.pipeline import generate as pg

    mods = pg.random_modules(seed=0, device="cuda")
    tok = byte_tokenizer()
    enc, unc = tok(["hip hop music"]), tok([""])
    args = (mods, enc["input_ids"], enc["attention_mask"], unc["input_ids"], unc["attention_mask"])
    kw = dict(seed=0, audio_length_in_s=SECONDS, guidance_scale=2.5, scheduler="dpm++")

    def clip(flag: bool, steps: int) -> float:
        fa.set_one_pass(flag)
        try:
            t0 = time.perf_counter()
            pg.generate(*args, num_inference_steps=steps, **kw)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        finally:
            fa.set_one_pass(False)

    clip(False, 2), clip(True, 2)  # warm-up
    out = {"off": [], "on": []}
    for flag in (False, True, True, False, False, True):
        out["on" if flag else "off"].append(clip(flag, 25))
    return out


def synthetic_clip(seconds: float, seed: int = 0):
    """A seeded synthetic waveform at 16 kHz: a few sines plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    wav = sum(a * np.sin(2 * np.pi * f * t + p) for f, a, p in ((220.0, 0.5, 0.0), (440.0, 0.3, 1.0), (1760.0, 0.2, 2.0)))
    return (wav + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)


def a2a_path(torch) -> dict:
    """Audio-to-audio at full width: style transfer (strength 0.75 of 20
    steps: 15 steps run) and inpainting of seconds 3 to 7."""
    from audioldm_tpu_torch.eval.proximity import calibrate_vocoder_gain, mel_correlation
    from audioldm_tpu_torch.kernels import launch_counts, reset_launches
    from audioldm_tpu_torch.pipeline import audio2audio as a2a
    from audioldm_tpu_torch.pipeline import generate as pg

    mods = pg.random_modules(seed=0, device="cuda")
    calibrate_vocoder_gain(mods, (1, int(SECONDS * 100), 64))
    tok = byte_tokenizer()
    enc, unc = tok(["hip hop music"]), tok([""])
    prompts = (enc["input_ids"], enc["attention_mask"], unc["input_ids"], unc["attention_mask"])
    src = synthetic_clip(SECONDS)
    mods.to("cuda", torch.bfloat16)
    mel = a2a.prepare_init_mel(src, mods, SECONDS)
    check(tuple(mel.shape) == (1, 1, 1024, 64) and bool(torch.isfinite(mel).all()), f"a2a: init mel {tuple(mel.shape)} == (1, 1, 1024, 64), finite")
    steps, strength = 20, 0.75
    ran = steps - a2a.a2a_start_index(steps, strength)
    mask = a2a.latent_mask(mods, SECONDS, regenerate_times=[(3.0, 7.0)])
    kw = dict(seed=0, audio_length_in_s=SECONDS, num_inference_steps=steps, strength=strength, guidance_scale=2.5)
    a2a.generate_from_audio(mods, mel, *prompts, **(kw | dict(num_inference_steps=4)))  # warm-up
    out = {"steps_run": ran}
    for name, extra in (("style_transfer", {}), ("inpaint", {"inpaint_mask": mask})):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        wav = a2a.generate_from_audio(mods, mel, *prompts, **kw, **extra)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launch_counts()
        wave_checks(torch, wav, SECONDS, f"a2a {name}")
        count_checks(counts, {"flash_fwd": unet_calls(2, ran)}, f"a2a {name}")
        k2 = sum(counts["mrf_stage"].values())
        check(k2 == 2, f"a2a {name}: K2 launched {k2} times (expect 2)")
        out[name] = {"s_per_clip": secs, "launches": counts,
                     "mel_correlation_vs_source": mel_correlation(wav[0].cpu().numpy(), src)}
    # the same inpainting request again, down to the latents: the kept region is the init's
    lat = a2a.latents_from_audio(mods, mel, *prompts, pg.loop_generator(0), num_inference_steps=steps, strength=strength,
                                 guidance_scale=2.5, dtype=torch.bfloat16, inpaint_mask=mask)
    init = a2a.encode_init_latents(mods, mel, dtype=torch.bfloat16)
    keep = (mask == 0).to(lat.device).expand_as(lat)
    kept, regen = int(keep.sum()), int((~keep).sum())
    check(kept > 0 and regen > 0 and torch.equal(lat[keep], init[keep]),
          f"a2a inpaint: the {kept} kept latent values equal the init latents ({regen} regenerated)")
    check(not torch.equal(lat[~keep], init[~keep]), "a2a inpaint: the regenerated region moved away from the init latents")
    return out


def engine_path(torch) -> dict:
    """Multi-LoRA serving at full width through ``serve.ServeEngine`` and the
    HTTP daemon: random weights from seed 0, bf16 UNet and VAE, fp32
    vocoder, the byte tokenizer, three rank-2 adapters (``LoRAConfig``
    defaults) with B drawn nonzero, and the composition ab = a:0.5, b:0.5.

    Routes, ``ENGINE_BUCKET`` requests a batch at 10.24 s, DDIM 50, CFG 2.5,
    after a warm-up batch each: merged (a, a, a, a on the merged cache),
    split (``ENGINE_MIXED`` with buckets (1, 2, 4): groups 2 + 1 + 1 cost 4,
    under rank-r's 4 x 1.5, so the gate splits), rank-r (the same batch with
    buckets (4,)) and hybrid (rank-r, projections up to 256 channels dense).
    Each: s a batch (median of 3) and clips/s, device ms and kernels a
    denoise step ((3 steps - 1 step) / 2 from the profiler), busy share
    against the wall time a step ((50 steps - 1 step) / 49), peak memory,
    and K1 and K2 launches by shape against what the route implies.

    Correctness at DDIM 10, the bounds with each check, set against the
    adapter's effect (one request through ``generate`` at batch 1 under "a"
    merged by hand against the same under "b", B drawn as 0.3 randn so that
    the effect stands far above bf16's rounding, and each adapter's against
    base above the routes' bound): a seeded split row and a
    seeded "base" row against ``generate`` on the adapter merged by hand
    (the same function at the same shapes), ab against a merge of
    ``compose_adapters``, each route's rows under "a" and "b" against their
    own merge (bf16 rounds a merged weight and an unmerged product
    differently) and nearer it than the other's, and the request under "a"
    and "b" on the rank-r route, which must differ. Then the daemon
    on 127.0.0.1 at DDIM 10: 8 concurrent requests of mixed adapters, a
    PEFT hot-load of "c" exported by the port and a request on it, its
    unload and a request on it (a 4xx)."""
    import base64
    import io
    import os
    import statistics
    import tempfile
    import threading
    import urllib.error
    import urllib.request
    import wave
    from collections import Counter

    import numpy as np

    from audioldm_tpu_torch import config as cfg
    from audioldm_tpu_torch.ckpt import write_safetensors
    from audioldm_tpu_torch.eval.proximity import calibrate_vocoder_gain
    from audioldm_tpu_torch.kernels import launch_counts, reset_launches
    from audioldm_tpu_torch.lora import export_peft_state_dict, init_lora
    from audioldm_tpu_torch.pipeline import generate as pg
    from audioldm_tpu_torch.serve import AdapterBank, GenParams, Microbatcher, ServeEngine, make_server

    t_phase = time.perf_counter()
    mods = pg.random_modules(seed=0, device="cuda")
    calibrate_vocoder_gain(mods, (1, int(SECONDS * 100), 64))
    lcfg = cfg.LoRAConfig()
    gen = torch.Generator().manual_seed(0)

    def draw():
        lora = init_lora(mods.unet, lcfg, gen)
        # a nonzero B: PEFT's B = 0 would make every route agree trivially. At 1.0 randn the UNet turns so
        # sensitive that bf16's rounding parts the routes by half the adapter's effect; 0.3 keeps it far under
        # (`routes_fp32`, the same checks in fp32: every route within 3.3e-7 of its own merge at 0.3 randn,
        # 1.9e-4 at 1.0, against an effect of 1.9e-3 and 2.4e-3)
        with torch.no_grad():
            for b in lora.b.values():
                b.copy_(0.3 * torch.randn(b.shape, generator=gen))
        return lora

    adapters = {name: draw() for name in ("a", "b", "c")}
    tok = byte_tokenizer()
    bank = AdapterBank.from_adapters({n: adapters[n] for n in ("a", "b")}, lcfg, device="cuda")
    fine = ServeEngine(mods, tok, lcfg, bank=bank, bucket_sizes=(1, 2, ENGINE_BUCKET))  # merged, split, the daemon
    engines = {"merged": fine, "split": fine,
               "rank_r": ServeEngine(mods, tok, lcfg, bank=bank, bucket_sizes=(ENGINE_BUCKET,)),
               "hybrid": ServeEngine(mods, tok, lcfg, bank=bank, bucket_sizes=(ENGINE_BUCKET,), dense_lora_max_dim=256)}
    names = {"merged": ["a"] * ENGINE_BUCKET, "split": list(ENGINE_MIXED), "rank_r": list(ENGINE_MIXED),
             "hybrid": list(ENGINE_MIXED)}

    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    fine.merged_modules("a")
    torch.cuda.synchronize()
    m1 = torch.cuda.memory_allocated()
    fine.merged_modules("b")
    fine.add_composed("ab", {"a": 0.5, "b": 0.5})
    torch.cuda.synchronize()
    out = {"memory_gib": {"before_cache": m0 / 2**30, "merged_cache_1": (m1 - m0) / 2**30,
                          "merged_cache_3": (torch.cuda.memory_allocated() - m0) / 2**30}, "routes": {}}

    # what each route implies: its sub-batches (route taken, bucket); each runs K1 ten times a UNet call a routed
    # level at the batch 2 x bucket and K2 once a vocoder stage at [bucket, C, T]
    subs = {"merged": (("merged", 4),), "split": (("merged", 2), ("merged", 1), ("base", 1)),
            "rank_r": (("rank_r", 4),), "hybrid": (("rank_r", 4),)}
    kw = dict(audio_length_in_s=SECONDS, guidance_scale=2.5)

    def clip_checks(wav, label):  # the samplers phase's waveform checks, a row at a time
        for i, row in enumerate(np.atleast_2d(wav)):
            wave_checks(torch, torch.from_numpy(np.ascontiguousarray(row))[None], SECONDS, f"{label} row {i}")

    for route, eng in engines.items():
        run = lambda steps, _e=eng, _n=names[route]: _e.generate(list(ENGINE_PROMPTS), adapters=_n, num_inference_steps=steps, **kw)
        run(2)  # warm-up: the route's buckets and merges
        t0 = time.perf_counter()
        run(1)
        one_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        before = Counter(eng.batches)
        reset_launches()
        t0 = time.perf_counter()
        wav = run(STEPS)  # a host array: the batch is done
        batch_s = [time.perf_counter() - t0]
        counts = launch_counts()
        batches = Counter(eng.batches) - before
        for _ in range(2):
            t0 = time.perf_counter()
            run(STEPS)
            batch_s.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        d1, n1 = device_ms_per_call(torch, lambda: run(1), iters=1)
        d3, n3 = device_ms_per_call(torch, lambda: run(3), iters=1)
        check(d1 is not None and d3 is not None, f"engine {route}: the profiler saw the device work")
        s_batch = statistics.median(batch_s)
        dev_step, wall_step = ((d3 or 0.0) - (d1 or 0.0)) / 2, (s_batch - one_s) / (STEPS - 1) * 1e3
        clip_checks(wav, f"engine {route}")
        want, per_bucket = Counter(subs[route]), Counter(b for _, b in subs[route])
        k1_want = {key: count for b, n in per_bucket.items() for key, count in unet_calls(2 * b, STEPS * n).items()}
        k2_want = {((b, c, t), post): n for b, n in per_bucket.items() for c, t, post in ((64, 81936, 0), (32, 163872, 7))}
        count_checks(counts, {"flash_fwd": k1_want}, f"engine {route}")
        check(counts["mrf_stage"] == k2_want, f"engine {route}: K2 launched {counts['mrf_stage']} (expect {k2_want})")
        check(batches == want, f"engine {route}: sub-batches {dict(batches)} (expect {dict(want)})")
        out["routes"][route] = {
            "s_per_batch": s_batch, "batch_s": batch_s, "clips_per_s": ENGINE_BUCKET / s_batch, "one_step_batch_s": one_s,
            "device_ms_per_step": dev_step, "kernels_per_step": (n3 - n1) / 2, "wall_ms_per_step": wall_step,
            "device_busy_share": dev_step / wall_step if wall_step > 0 else "not measured", "peak_mem_gib": peak,
            "launches": counts,
            "sub_batches": {f"{k}:{b}": n for (k, b), n in batches.items()},
        }
        print(f"engine {route}: s_per_batch {s_batch:.4f} clips_per_s {ENGINE_BUCKET / s_batch:.3f} device_ms_per_step "
              f"{dev_step:.3f} kernels_per_step {(n3 - n1) / 2:.0f} wall_ms_per_step {wall_step:.2f} peak {peak:.2f} GiB",
              flush=True)
    r, m = out["routes"]["rank_r"], out["routes"]["merged"]
    out["rank_r_to_merged"] = {"s_per_batch": r["s_per_batch"] / m["s_per_batch"],
                               "device_ms_per_step": r["device_ms_per_step"] / m["device_ms_per_step"]
                               if m["device_ms_per_step"] else "not measured",
                               "RANK_R_OVERHEAD": ServeEngine.RANK_R_OVERHEAD}

    out["checks"] = route_checks(torch, mods, engines, names, adapters, lcfg, tok, torch.bfloat16, "engine")
    p = list(ENGINE_PROMPTS)

    # the daemon
    def call(method, path, body=None):
        req = urllib.request.Request(base_url + path, method=method, data=None if body is None else json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=300) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def wav_of(resp, label):
        with wave.open(io.BytesIO(base64.b64decode(resp["audio_b64"]))) as w:
            check(w.getframerate() == 16000, f"{label}: 16 kHz wav ({w.getframerate()})")
            pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float32) / 32767.0
        clip_checks(pcm, label)

    batcher = Microbatcher(fine, max_batch=ENGINE_BUCKET, max_delay_ms=200.0,
                           defaults=GenParams(num_inference_steps=CHECK_STEPS, audio_length_in_s=SECONDS, guidance_scale=2.5))
    server = make_server(batcher, 16000, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base_url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            mix = ["a", "b", None, "ab", "a", "b", "a", None]
            results = [None] * len(mix)

            def one(i):
                results[i] = call("POST", "/v1/generate", {"prompt": p[i % 4], "adapter": mix[i], "seed": 100 + i if i % 2 else None})

            t0 = time.perf_counter()
            threads = [threading.Thread(target=one, args=(i,)) for i in range(len(mix))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            burst_s = time.perf_counter() - t0
            check(all(r is not None and r[0] == 200 for r in results), f"daemon: 8 concurrent requests answered 200 "
                                                                       f"({[r and r[0] for r in results]})")
            for i, r in enumerate(results):
                if r is not None and r[0] == 200:
                    wav_of(r[1], f"daemon request {i} ({mix[i]})")
            path = os.path.join(tmp, "c.safetensors")
            write_safetensors(path, export_peft_state_dict(adapters["c"]))
            code, resp = call("POST", "/v1/adapters", {"name": "c", "path": path})
            check(code == 200 and "c" in resp.get("adapters", []), f"daemon: hot-load of c from a PEFT file: {code} {resp}")
            code, resp = call("POST", "/v1/generate", {"prompt": p[0], "adapter": "c", "seed": 5})
            check(code == 200, f"daemon: a request on the hot-loaded c: {code}")
            if code == 200:
                wav_of(resp, "daemon request on c")
            code, resp = call("DELETE", "/v1/adapters/c")
            check(code == 200 and "c" not in resp.get("adapters", ["c"]), f"daemon: DELETE c: {code} {resp}")
            code, resp = call("POST", "/v1/generate", {"prompt": p[0], "adapter": "c"})
            check(400 <= code < 500, f"daemon: a request on the unloaded c gets a 4xx: {code} {resp.get('error')}")
            _, stats = call("GET", "/v1/stats")
            check(stats["served"] > stats["batches"], f"daemon: /v1/stats shows a batch of more than one request "
                                                      f"({stats['served']} served in {stats['batches']} batches)")
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(timeout=30)
    out["daemon"] = {"burst_8_s": burst_s, "batch_sizes": batcher.batch_sizes, "stats": stats}
    out["engine_s"] = time.perf_counter() - t_phase
    return out


def route_checks(torch, mods, engines, names, adapters, lcfg, tok, dtype, label: str) -> dict:
    """The serving routes on one request at DDIM 10, in ``dtype``, each
    bound a share of the adapter's effect (``generate`` at batch 1 on "a"
    merged by hand against the same on "b"): a seeded split row and a
    seeded "base" row against ``generate`` on the adapter merged by hand
    (the same function at the same shapes: effect / 50), ab against a merge
    of ``compose_adapters``, each route's rows under "a" and "b" against
    their own merge (effect / 4) and nearer it than the other's, the
    request under "a" and "b" on the rank-r route (differ by more than
    effect / 2), and each adapter against base (more than effect / 4).
    ``engines``: the engine phase's, by route, "merged" also serving the
    split route and the composition "ab". Returns the readings."""
    import copy
    import dataclasses

    import numpy as np

    from audioldm_tpu_torch.eval.proximity import mel_correlation
    from audioldm_tpu_torch.lora import compose_adapters, merge_lora
    from audioldm_tpu_torch.pipeline import generate as pg

    def clip_checks(wav, what):
        for i, row in enumerate(np.atleast_2d(wav)):
            wave_checks(torch, torch.from_numpy(np.ascontiguousarray(row))[None], SECONDS, f"{what} row {i}")

    # correctness at DDIM 10: rows 0 and 1 are one prompt and one seed under "a" and "b"
    p = list(ENGINE_PROMPTS)
    same, seeds = [p[0], p[0], p[2], p[3]], [13, 13, None, 12]
    ck = dict(num_inference_steps=CHECK_STEPS, audio_length_in_s=SECONDS, guidance_scale=2.5)
    fine = engines["merged"]
    got = {route: engines[route].generate(same, adapters=names[route], seeds=seeds, **ck) for route in engines}
    got["ab"] = fine.generate([p[0]], adapters=["ab"], seeds=[13], **ck)

    def solo(m, prompt, seed):
        enc, unc = tok([prompt]), tok([""])
        return pg.generate(m, enc["input_ids"], enc["attention_mask"], unc["input_ids"], unc["attention_mask"], seed=seed,
                           dtype=dtype, **ck)[0].cpu().numpy()

    def merged(lora, c):
        return dataclasses.replace(mods, unet=merge_lora(copy.deepcopy(mods.unet), lora, c))

    refs = {"a": solo(merged(adapters["a"], lcfg), p[0], 13), "b": solo(merged(adapters["b"], lcfg), p[0], 13),
            "base": solo(mods, p[3], 12), "base_a": solo(mods, p[0], 13),
            "ab": solo(merged(*compose_adapters([(adapters["a"], lcfg, 0.5), (adapters["b"], lcfg, 0.5)])), p[0], 13)}
    torch.cuda.empty_cache()
    agree = lambda x, y: (mel_correlation(x, y), float(np.abs(x - y).max()))
    checks = {}
    # the yardstick: the adapter's whole effect, one request through generate at batch 1 under "a" merged by
    # hand against the same under "b"
    ref_a, ref_b = refs["a"], refs["b"]
    corr, effect = agree(ref_a, ref_b)
    checks["merged a vs merged b"] = {"mel_correlation": corr, "max_abs_diff": effect}
    # the routes' bound below (effect / 4) must part each adapter from base, or a route that serves base passes
    felt = {n: float(np.abs(refs[n] - refs["base_a"]).max()) for n in ("a", "b")}
    checks["merged a, b vs base"] = {"max_abs_diff": felt}
    check(min(felt.values()) > effect / 4, f"{label}: each adapter is felt, max|d| to base {felt} > {effect / 4:.3g}")
    # the same function at the same shapes (a sub-batch of 1 is generate's batch of 1): bf16 may differ only in
    # the order of a sum, so max|d| <= effect / 50 and mel correlation >= 0.999
    for what, x, y in (("split row b vs generate, b merged", got["split"][1], ref_b),
                        ("split row base vs generate", got["split"][3], refs["base"]),
                        ("ab vs generate, compose_adapters merged", got["ab"][0], refs["ab"])):
        corr, diff = agree(x, y)
        checks[what] = {"mel_correlation": corr, "max_abs_diff": diff}
        clip_checks(x, f"{label} check {what}")
        check(corr >= 0.999 and diff <= effect / 50,
              f"{label} {what}: mel correlation {corr:.5f} >= 0.999, max|d| {diff:.3g} <= {effect / 50:.3g}")
    # the routes on one request: a merged weight and an unmerged product round differently in bf16, over 10
    # steps, so each row is held to a quarter of the adapter's effect of its own merge, and must lie nearer
    # it than the other adapter's (a route that serves base, or swaps a and b, fails both)
    # (rows 0 and 1 are the request under "a" and under "b"; the merged route serves "a" on both, the split
    # route's row 1 is held above)
    for route, rows in (("merged", (0,)), ("split", (0,)), ("rank_r", (0, 1)), ("hybrid", (0, 1))):
        for row in rows:
            name, own, other = ("a", ref_a, ref_b) if row == 0 else ("b", ref_b, ref_a)
            x = got[route][row]
            corr, diff = agree(x, own)
            far = float(np.abs(x - other).max())
            checks[f"{route} row {name} vs merged {name}"] = {"mel_correlation": corr, "max_abs_diff": diff,
                                                             "max_abs_diff_other": far}
            check(corr >= 0.999 and diff <= effect / 4 and diff < far,
                  f"{label} {route} row {name}: mel correlation {corr:.5f} >= 0.999, max|d| to merged {name} {diff:.3g} "
                  f"<= {effect / 4:.3g} and < {far:.3g} to the other")
    corr, diff = agree(got["rank_r"][0], got["rank_r"][1])
    checks["rank_r a vs b"] = {"mel_correlation": corr, "max_abs_diff": diff}
    check(diff > effect / 2, f"{label}: one request under a and under b on the rank-r route differs, max|d| {diff:.3g} "
                             f"> {effect / 2:.3g} (mel correlation {corr:.4f})")
    return checks


DIAG_SHAPE = (2, 8, 4096, 16)  # the tool's shape: the UNet's level-0 self-attention of a 10.24 s clip
DIAG_ITERS = 5  # timed calls a kernel in the tool's sections


def diag_path(torch) -> dict:
    """The attention diagnostic tool's sections v1-v5 through
    ``tools.bench_attn_diag``, then its kernel functions on fp32 CUDA
    tensors (``diag_f32_tool_calls``), with the launch counts set to 0 just
    before and read just after. Checks that every exact-softmax kernel agrees with
    ``sdpa_reference`` at ``k1_errors``' max bound, max|ref| / 64, that
    exp2 at 64-row blocks (max committed a block, no rescale) does not, and
    that exp2 at 1024-row blocks is finite. The
    sections report max |d| only; the three bounds that catch a skipped kv
    tile are ``diag_cases``'."""
    from audioldm_tpu_torch.kernels import launch_counts, reset_launches
    from audioldm_tpu_torch.tools import bench_attn_diag as bd

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    sections = {name: fn(iters=DIAG_ITERS) for name, fn in bd.SECTIONS.items()}
    f32 = diag_f32_tool_calls(torch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    n = DIAG_SHAPE[2]
    for name, sec in sections.items():
        for r in sec["results"]:
            label, err = r["name"], r["max_abs_err_vs_reference"]
            if label.startswith(("no_exp", "matmul_only")):
                continue  # not softmax: held against their plain versions in diag_cases
            if label.startswith("exp2") and f"bk={n}" not in label:
                if "bk=64" in label:
                    check(err > 0.1, f"diag {name} {label}: the max committed per 64-row block without a rescale is "
                                     f"not softmax: max |d| vs reference {err:.3g} > 0.1")
                else:  # not softmax either, but nearer: held against its plain version in diag_cases
                    check(math.isfinite(err), f"diag {name} {label}: max |d| vs reference {err:.3g} is finite")
            else:
                tol = r["reference_max_abs"] / 64
                check(math.isfinite(err) and err <= tol, f"diag {name} {label}: max |d| vs reference {err:.3g} <= {tol:.3g}")
    return {"seconds": seconds, "launches": counts, "sections": sections, "f32_tool_calls": f32}


def rowwise_errors(out, ref, keep, bf16: bool = True, cond=None) -> dict:
    """``k1_errors`` of ``out`` and ``ref`` divided by the reference's max
    |.| of each row, over the rows ``keep``: the bounds of a softmax output,
    relative to the reference's own magnitude (no_exp and matmul_only reach
    1e22). In fp32 each row is also divided by ``cond``, its signed sum's
    condition number (``attn_diag.row_condition``): fp32 rounding of a sum
    of signed terms grows with it, where a softmax row sums weights of one
    sign (condition 1), so the fp32 bound 1e-5 holds a row to 1e-5 times its
    condition (no_exp at [2, 8, 4096, 16]: row-relative 1.6e-4 without it,
    the two orders of summation of a row whose logits sum to about 1)."""
    scale = ref.abs().amax(dim=-1, keepdim=True)
    if cond is not None:
        scale = scale * cond
    return k1_errors((out / scale)[keep], (ref / scale)[keep], bf16)


DIAG_EXTRA = ((2, 8, 2048, 128), (1, 8, 512, 128))  # K9 at d = 128, in 128-row and in 64-row tiles (K8 at the first)
DIAG_RAGGED = (2, 8, 4032, 16)  # a half-full last q tile of 128 rows (N % 128 == 64)
# K10 at d = 40 (padded to 64: the ones as 8 more columns of P V) and at d =
# 72 and 120 (padded to 128: the ones as a product of their own)
DIAG_K10 = ((2, 8, 2048, 40), (2, 8, 2048, 72), (2, 8, 2048, 120))
_FWD = {"fori_exp2": "K8", "grid3": "K9", "grid3b": "K10", "exp2": "EXP2"}  # the Fwd:: of a kernel or K7 variant
DIAG_F32 = (DIAG_SHAPE, DIAG_RAGGED)  # the fp32 kernels' shapes, run by the tool's functions in diag_path
_F32_KIND = {"full": "FULL", "exp2": "EXP2", "no_max": "NO_MAX", "no_exp": "NO_EXP", "matmul_only": "MATMUL_ONLY",
             "fori_exp2": "K8", "grid3": "K9", "grid3b": "K10"}  # the Kind of csrc/attn_diag_f32.cu


def diag_f32_calls(n: int) -> list:
    """The fp32 calls at ``n`` kv rows: ``(name, block_k)`` of each K7
    variant at 64-row blocks, exp2 also at 1024 (where it divides ``n``) and
    ``n``, and K8, K9 and K10 at 64."""
    calls = []
    from audioldm_tpu_torch.kernels.attn_diag import VARIANTS

    for variant in VARIANTS:
        calls += [(variant, bk) for bk in ((64,) + ((1024,) if n % 1024 == 0 else ()) + (n,) if variant == "exp2" else (64,))]
    return calls + [(name, 64) for name in ("fori_exp2", "grid3", "grid3b")]


def diag_f32_inputs(torch, shape, gen):
    """fp32 q, k, v of ``shape``; at ``DIAG_RAGGED`` every third q row's
    logits near -370 (base 2), as the bf16 ragged case."""
    q, k, v = (torch.randn(shape, device="cuda", generator=gen) for _ in range(3))
    if shape == DIAG_RAGGED:
        k[..., 0] += 32
        q[:, :, ::3, 0] = -32
    return q, k, v


def diag_f32_tool_calls(torch) -> dict:
    """The tool's kernel functions (``run``, ``run_fori_exp2``,
    ``run_grid3``, ``run_grid3b``) on fp32 CUDA tensors at ``DIAG_F32``,
    once each of ``diag_f32_calls``: the fp32 path, which the JAX tool's
    functions take too (its sections, like the port's, run bf16). Returns
    each call's max |out| (finite is checked)."""
    from audioldm_tpu_torch.tools import bench_attn_diag as bd

    gen = torch.Generator(device="cuda").manual_seed(11)
    fns = {"fori_exp2": bd.run_fori_exp2, "grid3": bd.run_grid3, "grid3b": bd.run_grid3b}
    out = {}
    for shape in DIAG_F32:
        q, k, v = diag_f32_inputs(torch, shape, gen)
        for name, bk in diag_f32_calls(shape[2]):
            o = fns[name](q, k, v, 64, bk) if name in fns else bd.run(q, k, v, name, 64, bk)
            top = o.abs().max().item()
            check(math.isfinite(top), f"diag fp32 tool call {name} bk={bk} {list(shape)}: finite (max |out| {top:.3g})")
            out[f"{name} bk={bk} {list(shape)}"] = top
    return out


def diag_cases(torch):
    """K7 (each variant at 64-row blocks, exp2 also at block_k 1024 and N),
    K8, K9 and K10, all on K1's loop, against their plain versions at [2, 8,
    4096, 16] bf16; K7 exp2 at block_k 1024 also on sharper logits (q times
    3), where a block's max moves its weight further; K9 also at the v5
    shapes and at d = 128 in 128-row and 64-row tiles; K8 also at d = 128
    (its 2-stage ring at d = 128's tile); K10 also at d = 40, 72 and 120
    (``DIAG_K10``: the ones columns and the ones product); K7 full, K8, K9
    and K10 at a ragged [2, 8, 4032, 16] whose every third q row has all its
    logits near -370 (base 2): a running max that starts at 0 instead of
    -1e30 underflows every weight of those rows. The softmax kernels are
    held to ``k1_errors``' three bounds; no_exp and matmul_only to the same
    bounds row by row, relative to each reference row's max, no_exp without
    the rows whose float64 sum of scaled logits lies within 1 of 0 (there
    the sign of the fp32 sum decides between acc / l and acc * 1e20). Each
    kernel is launched twice into memory just filled with NaN, and the two
    results must have equal bits. K10 is also held to K9 at the max bound:
    they differ only in how l is rounded. Each case carries the time of the
    kernel (``device_ms``: the profiler's records of its function alone),
    of its plain version, of K1 and of PyTorch's fused attention (for the
    kernels that compute softmax) on the same inputs; K1 and the library are
    timed once an input set. Cases at shapes the tool's sections do not run
    are marked ``tool_shape`` False.

    Then the fp32 kernels, ``diag_f32_cases``."""
    return _diag_cases(torch, fp32=False) + diag_f32_cases(torch)


def diag_f32_cases(torch):
    """The fp32 kernels (``csrc/attn_diag_f32.cu``, on the fp32 K1's loop) at
    ``DIAG_F32``, each of ``diag_f32_calls`` against its plain version at
    the fp32 bounds of ``k1_errors`` (1e-5 times max(1, max|ref|)), no_exp
    and matmul_only row by row by each row's condition (``rowwise_errors``),
    the softmax kinds with each row's max error divided by its logits'
    ``attn_diag.logit_condition`` (1 for every row whose logits stay under
    32 in magnitude; the ragged input's every third row reaches about 370),
    twice into NaN for equal bits, timed beside the plain version, fp32 K1
    and the library's fp32 call, with two bounds: three TF32 products a
    term (``bound_ms``, ``bound_kind`` "3xtf32") and fp32 FMA
    (``fma_bound_ms``); K8 and K10 also against K9 (one function in fp32).
    The tool's fp32 calls in ``diag_path`` launch each of them."""
    return _diag_cases(torch, fp32=True)


def _diag_cases(torch, fp32: bool):
    """The bf16 cases of ``diag_cases`` or, with ``fp32``, ``diag_f32_cases``."""
    import torch.nn.functional as F

    from audioldm_tpu_torch.kernels import attn_diag as ad
    from audioldm_tpu_torch.kernels import flash_attention as fa
    from audioldm_tpu_torch.tools.bench_attn_diag import V5_SHAPES

    csrc, tool = "audioldm_tpu_torch/csrc/", "tools/bench_attn_diag.py"
    sm90, k9, k8_k10 = (f"{csrc}{src}.cu" for src in DIAG_SOURCES)
    f32_src = f"{csrc}attn_diag_f32.cu"
    out = []

    def yardsticks(q, k, v) -> dict:
        """K1 and PyTorch's fused attention on one input set."""
        k1 = lambda: fa.flash_attention(q, k, v)
        lib = lambda: F.scaled_dot_product_attention(q, k, v)
        k1_fn = "flash_fwd_sm90_kernel" if q.dtype == torch.bfloat16 else "flash_fwd_f32"
        return {"k1_ms": cuda_ms(torch, k1, 50), "k1_device_ms": device_ms(torch, k1, kernel=k1_fn),
                "library_ms": cuda_ms(torch, lib, 50), "library_device_ms": device_ms(torch, lib)}

    def launch(run, like):
        """``run()`` into memory the caching allocator has just held NaN in, so
        that rows a kernel leaves unwritten read as NaN."""
        poison = torch.full_like(like, float("nan"))
        del poison
        return run()

    def case(name, key, replaces, q, k, v, yard, run, plain, softmax: bool, library: bool, keep=None, extra=None,
             source=sm90, tool_shape=True, tag="", cond=None, logit_cond=None):
        b, h, n, d = q.shape
        bf16 = q.dtype == torch.bfloat16
        label = f"{name}{'' if extra is None else ' bk=%d' % extra['block_k']} {list(q.shape)}{'' if bf16 else ' fp32'}{tag}"
        first, again = launch(run, q), launch(run, q)
        same = torch.equal(first, again)
        got, ref = first.double(), plain().double()
        e = (k1_errors(got, ref, bf16) if softmax
             else rowwise_errors(got, ref, keep if keep is not None else slice(None), bf16, cond))
        if logit_cond is not None:  # a row's max error by the fp32 resolution of its logits
            e["max_abs_err"] = ((got - ref).abs() / logit_cond).max().item()
            e["logit_condition_max"] = logit_cond.max().item()
        exp2 = b * h * n * n if softmax else 0
        b_ms, b_by = bound(4 * b * h * n * d * q.element_size(), 4 * b * h * n * n * d, "bf16" if bf16 else "3xtf32",
                           exp2=exp2)
        kind = name.removeprefix("diag_loop.")
        if bf16:
            fwd = "EXP2_BLOCKS" if kind == "exp2" and extra["block_k"] > 64 else _FWD.get(kind, kind.upper())
            nwg = ad.q_rows(b, h, n, d, torch.cuda.get_device_properties(0).multi_processor_count) // 64 if name == "grid3" else 2
            function, kernel = f"attn_diag_sm90_kernel<D, Fwd::{fwd}, {nwg}>", "attn_diag_sm90_kernel"
        else:
            source, function, kernel = f32_src, f"flash_fwd_f32<D, F32::{_F32_KIND[kind]}>", "flash_fwd_f32"
        entry = {
            "name": name, "route": "cuda", "source": source, "function": function,
            "replaces": f"{tool}:{replaces}", "shape": list(q.shape), "dtype": "bf16" if bf16 else "fp32",
            "loop": "sm90" if bf16 else "sm90_3xtf32", **e,
            **(extra or {}), "same_bits": same, "tool_shape": tool_shape, "ms": cuda_ms(torch, run, 50),
            "device_ms": device_ms(torch, run, kernel=kernel), "plain_ms": cuda_ms(torch, plain, 5),
            "k1_ms": yard["k1_ms"], "k1_device_ms": yard["k1_device_ms"],
            "library_ms": yard["library_ms"] if library else None,
            "library_device_ms": yard["library_device_ms"] if library else None,
            "bound_ms": b_ms, "bound_by": b_by, "counter": key[0], "variant": key[1],
        }
        if not bf16:
            entry.update(bound_kind="3xtf32", fma_bound_ms=bound(4 * b * h * n * d * 4, 4 * b * h * n * n * d, "fp32")[0])
        if tag:
            entry["inputs"] = tag.strip()
        if name == "grid3" and bf16:
            entry["q_rows"] = 64 * nwg
        check(errors_ok(e), f"{label} kernel vs plain: max {e['max_abs_err']:.3g} <= {e['tolerance']:.3g}, "
                            f"mean {e['mean_abs_err']:.3g} <= {e['mean_tolerance']:.3g}, gain {e['gain_err']:.3g} within "
                            f"{e['gain_tolerance']}" + ("" if softmax and bf16 else
                                                        " (by the rows' logit condition, at most "
                                                        f"{e['logit_condition_max']:g})" if softmax else
                                                        " (row-relative)" if bf16 else
                                                        " (row-relative, by the row's condition)"))
        check(same, f"{label}: a second launch gives the same bits")
        print(f"{label} ms {entry['ms']:.4f} device_ms {entry['device_ms']} k1_ms {entry['k1_ms']:.4f} k1_device_ms "
              f"{entry['k1_device_ms']} plain_ms {entry['plain_ms']:.3f} library_ms {entry['library_ms']} library_device_ms "
              f"{entry['library_device_ms']} bound_ms {b_ms:.4f}", flush=True)
        out.append(entry)
        return got

    # K8, K9 and K10: name, the TPU kernel's line, wrapper, source
    flash = {"fori_exp2": (124, ad.fori_exp2, k8_k10), "grid3": (178, ad.grid3, k9), "grid3b": (274, ad.grid3b, k8_k10)}

    def flash_case(name, q, k, v, yard, tool_shape=True, tag=""):
        line, fn, source = flash[name]
        return case(name, (name, ("bfloat16", tuple(q.shape))), line, q, k, v, yard, lambda: fn(q, k, v, 64, 64),
                    lambda: ad.flash_exp2_plain(q, k, v, 64, ones=name == "grid3b"), True, True, source=source,
                    tool_shape=tool_shape, tag=tag)

    gen = torch.Generator(device="cuda").manual_seed(7)
    tag = " (every third q row's logits near -370)"
    if fp32:
        # fp32 (csrc/attn_diag_f32.cu): every call of diag_f32_calls at DIAG_F32, each shape's K8-K10 also against K9
        for shape in DIAG_F32:
            q, k, v = diag_f32_inputs(torch, shape, gen)
            yard, key, n = yardsticks(q, k, v), ("float32", shape), shape[2]
            lsum = torch.matmul(q.double(), k.double().transpose(-1, -2)).sum(dim=-1) / math.sqrt(shape[3])
            keep = lsum.abs() > 1.0
            # the rows' logit conditions: K7's logits in natural units, K8-K10's in base 2
            conde, cond2 = (ad.logit_condition(q, k, c / math.sqrt(shape[3])) for c in (1.0, ad.LOG2E))
            got = {}
            for name, bk in diag_f32_calls(n):
                softmax = name not in ("no_exp", "matmul_only")
                if name in flash:
                    line, fn, _ = flash[name]
                    got[name] = case(name, (name, key), line, q, k, v, yard, lambda: fn(q, k, v, 64, bk),
                                     lambda: ad.flash_exp2_plain(q, k, v, bk, ones=name == "grid3b"), True, True,
                                     tag=tag if shape == DIAG_RAGGED else "", logit_cond=cond2)
                    continue
                case(f"diag_loop.{name}", ("diag_loop", key + (name, bk)), 20, q, k, v, yard,
                     lambda: ad.diag_loop(q, k, v, name, bk), lambda: ad.diag_loop_plain(q, k, v, name, bk), softmax,
                     library=softmax and (name != "exp2" or bk == n), keep=keep if name == "no_exp" else None,
                     extra={"block_k": bk, **({"rows_left_out": int((~keep).sum())} if name == "no_exp" else {})},
                     cond=None if softmax else ad.row_condition(q, k, v, name), tag=tag if shape == DIAG_RAGGED else "",
                     logit_cond=conde if softmax else None)
            for name in ("fori_exp2", "grid3b"):  # one function in fp32: P rounds to itself, l sums the same weights
                e = k1_errors(got[name], got["grid3"], False)
                same = torch.equal(got[name], got["grid3"])
                check(e["max_abs_err"] <= e["tolerance"], f"{name} vs grid3 {list(shape)} fp32: max {e['max_abs_err']:.3g} "
                                                          f"<= {e['tolerance']:.3g} (equal bits: {same})")
                next(c for c in reversed(out) if c["name"] == name).update(vs_k9_max_abs_err=e["max_abs_err"], vs_k9_same_bits=same)
            del q, k, v, lsum
        return out
    q, k, v = (torch.randn(DIAG_SHAPE, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3))
    n, d = DIAG_SHAPE[2], DIAG_SHAPE[3]
    shape, yard = ("bfloat16", DIAG_SHAPE), yardsticks(q, k, v)
    lsum = torch.matmul(q.double(), k.double().transpose(-1, -2)).sum(dim=-1) / math.sqrt(d)
    keep = lsum.abs() > 1.0
    print(f"diag no_exp: {int((~keep).sum())} of {keep.numel()} rows left out (|sum of scaled logits| <= 1)", flush=True)
    for variant in ad.VARIANTS:
        for bk in (64, 1024, n) if variant == "exp2" else (64,):
            softmax = variant not in ("no_exp", "matmul_only")
            case(f"diag_loop.{variant}", ("diag_loop", shape + (variant, bk)), 20, q, k, v, yard,
                 lambda: ad.diag_loop(q, k, v, variant, bk), lambda: ad.diag_loop_plain(q, k, v, variant, bk),
                 softmax, library=softmax and (variant != "exp2" or bk == n),
                 keep=keep if variant == "no_exp" else None,
                 extra={"block_k": bk, **({"rows_left_out": int((~keep).sum())} if variant == "no_exp" else {})})
    qs = (q.float() * 3).to(torch.bfloat16)
    case("diag_loop.exp2", ("diag_loop", shape + ("exp2", 1024)), 20, qs, k, v, yard,
         lambda: ad.diag_loop(qs, k, v, "exp2", 1024), lambda: ad.diag_loop_plain(qs, k, v, "exp2", 1024), True,
         library=False, extra={"block_k": 1024}, tag=" sharp (q x 3)")
    got = {name: flash_case(name, q, k, v, yard) for name in flash}
    e = k1_errors(got["grid3b"], got["grid3"], True)
    out[-1].update(vs_k9_max_abs_err=e["max_abs_err"], vs_k9_mean_abs_err=e["mean_abs_err"], vs_k9_gain_err=e["gain_err"])
    check(e["max_abs_err"] <= e["tolerance"], f"K10 grid3b vs K9 grid3 {list(DIAG_SHAPE)}: max {e['max_abs_err']:.3g} <= "
                                              f"{e['tolerance']:.3g} (mean {e['mean_abs_err']:.3g}, gain {e['gain_err']:.3g})")
    for s in V5_SHAPES + DIAG_EXTRA:
        q5, k5, v5 = (torch.randn(s, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3))
        y5 = yardsticks(q5, k5, v5)
        flash_case("grid3", q5, k5, v5, y5, tool_shape=s in V5_SHAPES)
        if s == DIAG_EXTRA[0]:
            flash_case("fori_exp2", q5, k5, v5, y5, tool_shape=False)
    for s in DIAG_K10:
        q5, k5, v5 = (torch.randn(s, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3))
        flash_case("grid3b", q5, k5, v5, yardsticks(q5, k5, v5), tool_shape=False)
    qr, kr, vr = (torch.randn(DIAG_RAGGED, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3))
    kr[..., 0] += 32
    qr[:, :, ::3, 0] = -32
    yr, sr = yardsticks(qr, kr, vr), ("bfloat16", DIAG_RAGGED)
    for name in flash:
        flash_case(name, qr, kr, vr, yr, tool_shape=False, tag=tag)
    case("diag_loop.full", ("diag_loop", sr + ("full", 64)), 20, qr, kr, vr, yr, lambda: ad.diag_loop(qr, kr, vr, "full", 64),
         lambda: ad.diag_loop_plain(qr, kr, vr, "full", 64), True, True, extra={"block_k": 64}, tool_shape=False, tag=tag)
    return out


TOOLS_STEPS = 10  # DDIM steps of the tools phase's clips (a2a, interval, long form, proximity, profile, cold start)


def tools_path(torch) -> dict:
    """Each of the system's tools that the port carries
    (``audioldm_tpu_torch/tools``) once at full width, with the fewest
    iterations and steps that still exercise it, the launch counts set to 0
    just before and read just after. Checks finite results; K1 10 launches a
    UNet step with flash on level 0, 20 and 30 with levels 1 and 2 routed too,
    none with every call on ``sdpa_plain`` or with attention ablated; K2 1 + 1
    a clip in the vocoder tools; ``check_perf`` exits 0 as the tree stands,
    and nonzero with level-0 attention forced to ``sdpa_plain``."""
    from audioldm_tpu_torch.kernels import flash_attention as fa
    from audioldm_tpu_torch.kernels import launch_counts, reset_launches
    from audioldm_tpu_torch.pipeline import generate as pg
    from audioldm_tpu_torch.tools import (bench_a2a, bench_compile, bench_conv1d_smallc, bench_guidance_interval,
                                          bench_longform, bench_matmul, bench_pipeline_tail, bench_train_step,
                                          bench_unet_step, bench_vocoder_mrf, check_perf, profile_pipeline,
                                          quality_proximity)
    import tempfile

    finite = lambda *xs: all(x is not None and math.isfinite(x) for x in xs)
    out = {}
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    mods = pg.random_modules(seed=0, device="cuda")
    u = out["bench_unet_step"] = bench_unet_step.ablation(mods, "cuda", iters=5, warm=2)
    want = {"flash_l0": 10, "flash_l0_l1": 20, "flash_l0_l1_l2": 30, "flash_off": 0, "sdpa_ablated": 0}
    for run, n in want.items():
        r = u["runs"][run]
        check(r["k1_launches_per_step"] == n and finite(r["ms"]),
              f"tools bench_unet_step {run}: K1 {r['k1_launches_per_step']} launches a step (expect {n}), {r['ms']:.3f} ms")
    tail = out["bench_pipeline_tail"] = bench_pipeline_tail.bench(mods, "cuda", warm=1, timed=3)
    v = tail["stages"]["vocoder_fp32"]
    check(v["k2_launches_per_call"] == 2 and v["finite"] and finite(*(x["ms"] for x in tail["stages"].values())),
          f"tools bench_pipeline_tail: K2 {v['k2_launches_per_call']} launches a clip (expect 1 + 1), finite")
    voc = out["bench_vocoder_mrf"] = bench_vocoder_mrf.bench(batch=1, device="cuda", warm=1, timed=3)
    check([r["routed_stages"] for r in voc[:2]] == [0, 2] and all(r["finite"] for r in voc[:2]) and len(voc) == 6
          and finite(*(r["ms"] for r in voc)),
          f"tools bench_vocoder_mrf: K2 {[r['routed_stages'] for r in voc[:2]]} launches (plain, fused; expect 0, 1 + 1), "
          f"{len(voc) - 2} stage records (expect 4)")
    clip = dict(steps=TOOLS_STEPS, iters=2)
    for name, fn in (("bench_a2a", lambda: bench_a2a.bench(mods, "cuda", strengths=(1.0, 0.5), **clip)),
                     ("bench_guidance_interval", lambda: bench_guidance_interval.bench(
                         mods, "cuda", intervals=(None, (0.05, 0.65)), **clip)),
                     ("bench_longform", lambda: bench_longform.bench(mods, "cuda", seconds=30.0, steps=TOOLS_STEPS,
                                                                     iters=1))):
        r = out[name] = fn()
        check(all(x["finite"] and finite(x["s_per_clip"]) for x in r["results"]) and len(r["results"]) == 2,
              f"tools {name}: {[round(x['s_per_clip'], 3) for x in r['results']]} s/clip, finite")
    clap = quality_proximity.clap_tower(quality_proximity.ClapAudioConfig(), 1, "cuda")
    prox = out["quality_proximity"] = quality_proximity.proximity(mods, clap, "cuda", steps=TOOLS_STEPS, dpm_steps=5,
                                                                  lcm_steps=4)
    check(finite(*(x for k, x in prox.items() if k.startswith(("clap_cos", "mel_corr")))),
          f"tools quality_proximity: cosines and correlations finite (mel_corr_anchor {prox['mel_corr_anchor_diffseed']:.3f})")
    with tempfile.TemporaryDirectory() as d:
        prof = out["profile_pipeline"] = profile_pipeline.profile(mods, "cuda", d, steps=TOOLS_STEPS, top=200)
    names = " ".join(r["name"] for r in prof["device_kernels"])
    check(prof["device_events"] > 0 and prof["finite"] and "flash_fwd_sm90_kernel" in names,
          f"tools profile_pipeline: {prof['device_events']} device events, K1 among the kernels, "
          f"busy share {prof['device_busy_share']}")
    del mods, clap
    torch.cuda.empty_cache()
    tr = out["bench_train_step"] = bench_train_step.bench_one(pg.random_modules(seed=0, device="cuda"), warm=1, timed=2)
    ds = out["bench_train_step_distill"] = bench_train_step.bench_distill(pg.random_modules(seed=0, device="cuda"),
                                                                          warm=1, timed=2)
    check(finite(tr["s"], tr["loss"], ds["s"], ds["loss"]),
          f"tools bench_train_step: {tr['s']:.4f} s a step, {tr['mfu']:.4f} MFU; distill {ds['s']:.4f} s; finite losses")
    torch.cuda.empty_cache()
    perf = out["check_perf"] = check_perf.check(None, "cuda", serving=True)
    check(perf["ok"], f"tools check_perf passes as the tree stands: {perf['failures']} {perf['results']}")
    with fa.min_tokens(1 << 30):  # every attention forced to sdpa_plain
        forced = out["check_perf_forced_plain"] = check_perf.check(None, "cuda", pipeline=False, train=False)
    check(not forced["ok"] and any(f.startswith("unet_step_device_ms") for f in forced["failures"]),
          f"tools check_perf fails with level-0 attention on sdpa_plain: {forced['failures']}")
    mm = out["bench_matmul"] = bench_matmul.bench(iters=10)
    check(finite(*(r["tflops"] for r in mm["results"])), f"tools bench_matmul: {[round(r['tflops'], 1) for r in mm['results']]} "
                                                         f"TFLOP/s, finite")
    conv = out["bench_conv1d_smallc"] = bench_conv1d_smallc.bench(iters=5)
    check(all(finite(r["direct_ms"], r["im2col_ms"]) and r["max_abs_err"] < 1e-4 for r in conv),
          f"tools bench_conv1d_smallc: direct and im2col agree (max |d| {max(r['max_abs_err'] for r in conv):.3g} < 1e-4 "
          f"in fp32), times finite")
    torch.cuda.synchronize()
    out["launches"] = launch_counts()
    cold = out["bench_compile"] = bench_compile.bench("full", "cuda", steps=TOOLS_STEPS, build=False,
                                                      stages=("unet_step", "generate"))
    check(all(finite(r["first_s"], r["second_s"]) for r in cold["stages"].values()),
          f"tools bench_compile: first calls {[round(r['first_s'], 3) for r in cold['stages'].values()]} s")
    out["tools_s"] = time.perf_counter() - t0
    return out


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
    with fa.min_tokens(256):  # both devices route the tiny level 0 (320 tokens) alone
        reset_launches()
        for name, mods, lora in (("gpu", gpu_mods, gpu_lora), ("cpu", cpu_mods, cpu_lora)):
            for m in (mods.unet, mods.vae, mods.text_encoder):
                m.requires_grad_(False)
            loss, _ = tr.lora_loss_fn(lora, mods, batch, lcfg.scale, draws=draws)
            loss.backward()
            out[name] = (loss.item(), [p.grad.detach().cpu() for p in lora.parameters()])
        torch.cuda.synchronize()
        counts = launch_counts()
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
    against the same generation on the CPU (plain versions), 2e-3; then a
    tiny fp32 DPM-Solver++ generation with the one-pass flag on (K6 on the
    card, ``flash_one_plain`` on the CPU), 2e-3."""
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
    with fa.min_tokens(256):  # the tiny level 0 has 320 tokens, level 1 80
        before = sum(fa.flash_attention.launches.values())
        gpu = pg.generate(build(), *args, device="cuda", **kw).cpu()
        routed = sum(fa.flash_attention.launches.values()) - before
        cpu = pg.generate(build(), *args, device="cpu", **kw)
        fa.set_one_pass(True)
        try:
            before_one = sum(fa.flash_attention.launches_one.values())
            before_k1 = sum(fa.flash_attention.launches.values())
            gpu_one = pg.generate(build(), *args, device="cuda", scheduler="dpm++", **kw).cpu()
            routed_one = sum(fa.flash_attention.launches_one.values()) - before_one
            routed_k1 = sum(fa.flash_attention.launches.values()) - before_k1
            cpu_one = pg.generate(build(), *args, device="cpu", scheduler="dpm++", **kw)
        finally:
            fa.set_one_pass(False)
    err = (gpu - cpu).abs().max().item()
    check(routed == 18, f"tiny reference routed {routed} attention calls through K1 (expect 18)")
    check(err <= 2e-3, f"tiny fp32 generation, card vs CPU: max|d| {err:.3g} <= 2e-3")
    err_one = (gpu_one - cpu_one).abs().max().item()
    check(routed_one == 18 and routed_k1 == 0,
          f"tiny one-pass reference routed {routed_one} attention calls through K6 (expect 18) and {routed_k1} through K1 (expect 0)")
    check(err_one <= 2e-3 and gpu_one.abs().max().item() > 0,
          f"tiny fp32 dpm++ generation with the one-pass flag, card vs CPU: max|d| {err_one:.3g} <= 2e-3")
    return err


def distill_path(torch) -> dict:
    """LCM-LoRA consistency distillation at full width, the UNet and the VAE
    cast whole to bf16 as ``cli distill`` casts them (the text tower, the
    vocoder and the rank-2 adapters fp32): one warm-up and
    ``DISTILL_STEPS`` timed ``distill_step``s at batch 2 of random log-mels
    (``train_batches``) with w drawn from U[2, 3). Checks: every loss
    finite; K1 30 launches a step a routed level (the teacher's two calls
    and the target's, under no_grad) and K3, K4 and K5 10 each (the
    student's forward and backward), all at batch 2 in bf16; the EMA after each step equal
    to d e + (1 - d) p of the updated student (fp32 rounding); the base
    weights bit for bit. Times s a step (host clock, the loss fetched each
    step), the device's kernel time and launches a step (profiler,
    unchecked: a whole step is no single kernel for ``tools/devtime.py``),
    peak memory. Then ``tiny_distill_reference`` and ``distill_cli``."""
    import statistics

    from audioldm_tpu_torch import config as cfg
    from audioldm_tpu_torch.kernels import launch_counts, reset_launches
    from audioldm_tpu_torch.lora import init_lora
    from audioldm_tpu_torch.pipeline import generate as pg
    from audioldm_tpu_torch.train import distill as ds
    from audioldm_tpu_torch.utils import flops as fl

    t_phase = time.perf_counter()
    lcfg, tcfg = cfg.LoRAConfig(), cfg.TrainConfig()
    w, decay = (2.0, 3.0), 0.95
    mods = ds.distill_modules(pg.random_modules(seed=0, device="cuda"), torch.bfloat16)
    models = (mods.unet, mods.vae, mods.text_encoder, mods.vocoder)
    base = [p.detach().clone() for m in models for p in m.parameters()]
    tok = byte_tokenizer()
    batches = [ds.add_uncond_tokens(b, tok) for b in train_batches(1 + DISTILL_STEPS + 2, seed=5)]
    state = ds.init_distill_state(init_lora(mods.unet, lcfg, torch.Generator().manual_seed(0)), tcfg)
    gen = torch.Generator(device="cuda").manual_seed(1)

    def step(st, batch):
        return ds.distill_step(st, mods, batch, lcfg, torch.bfloat16, w=w, ema_decay=decay, generator=gen)

    state, warm = step(state, batches[0])
    losses = [warm["loss"].item()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    step_s, ema_err = [], 0.0
    for batch in batches[1 : 1 + DISTILL_STEPS]:
        ema0 = [p.detach().clone() for p in state.ema_lora.parameters()]
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
        step_s.append(time.perf_counter() - t0)
        for e, e0, p in zip(state.ema_lora.parameters(), ema0, state.lora.parameters()):
            ema_err = max(ema_err, ((e - (decay * e0 + (1 - decay) * p)).abs().max() / p.abs().max().clamp_min(1e-30)).item())
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_med = statistics.median(step_s)

    check(state.step == 1 + DISTILL_STEPS and all(math.isfinite(x) for x in losses),
          f"distill: {DISTILL_STEPS} steps after the warm-up, every loss finite: {[round(x, 5) for x in losses]}")
    count_checks(counts, {"flash_fwd": unet_calls(2, 3 * DISTILL_STEPS),
                          **{k: unet_calls(2, DISTILL_STEPS) for k in ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq")}},
                 f"distill: {DISTILL_STEPS} steps (K1 30 a step a routed level: teacher x2 + target; K3-K5 10: the student)")
    check(ema_err <= 1e-6, f"distill: EMA after each step is d e + (1 - d) p of the updated student, max |d| {ema_err:.3g} "
                           f"of the largest entry <= 1e-6")
    same = all(torch.equal(p, q) for p, q in zip((p for m in models for p in m.parameters()), base))
    check(same, "distill: base weights unchanged")
    del base

    two = batches[1 + DISTILL_STEPS :]
    prof = profile_two_steps(torch, lambda: [step(state, b) for b in two], step_med)
    # a step's useful FLOPs: the training step's (VAE encode, a text encode, the student forward and backward)
    # plus the uncond text encode and three forwards (teacher x2, target)
    unet_fwd = fl.unet_step_flops(mods.unet.cfg, 2, 256, 16).useful
    step_flops = (fl.train_step_flops(mods.unet.cfg, mods.vae.cfg, mods.text_encoder.cfg, batch=2)["total"].useful
                  + fl.clap_text_flops(mods.text_encoder.cfg, 1, 512).useful + 3 * unet_fwd)
    out = {"s_per_step": step_med, "step_s": step_s, "losses": losses, "launches": counts, "peak_mem_gib": peak,
           "ema_rel_err": ema_err, "step_profile": prof, "step_tflop": step_flops / 1e12,
           "mfu_of_step_s": fl.mfu(step_flops, step_med)}
    del mods, state, batches, two
    torch.cuda.empty_cache()
    out["tiny"] = tiny_distill_reference(torch)
    out["cli"] = distill_cli(torch)
    out["distill_s"] = time.perf_counter() - t_phase
    return out


def tiny_distill_reference(torch) -> dict:
    """A tiny fp32 distillation loss and its adapter gradients on the card
    (level 0 routed: the student through K3-K5, the teacher and the target
    through K1) against the same on the CPU (plain versions), from the same
    draws: grid indices 49 and 0 (the top of the grid and the row whose
    target is the identity) and w 2.2 and 2.9. Loss to 1e-5 relative, every
    gradient to 1e-4 of the largest entry, the training step's bounds
    (``tiny_train_reference``; cuDNN's TF32 off)."""
    import copy

    import numpy as np

    from audioldm_tpu_torch import config as cfg
    from audioldm_tpu_torch.kernels import flash_attention as fa
    from audioldm_tpu_torch.kernels import launch_counts, reset_launches
    from audioldm_tpu_torch.lora import init_lora
    from audioldm_tpu_torch.pipeline import generate as pg
    from audioldm_tpu_torch.train import distill as ds

    lcfg = cfg.LoRAConfig()
    cpu_mods = ds.distill_modules(pg.random_modules(
        3, cfg.UNetConfig(**TINY["unet"]), cfg.VAEConfig(**TINY["vae"]), cfg.ClapTextConfig(**TINY["text"]),
        cfg.VocoderConfig(**TINY["voc"]), device="cpu"))
    gen = torch.Generator().manual_seed(8)
    lora, ema = (init_lora(cpu_mods.unet, lcfg, gen) for _ in range(2))
    with torch.no_grad():
        for b in (*lora.b.values(), *ema.b.values()):  # nonzero B, else every gradient of A is zero
            b.copy_(0.1 * torch.randn(b.shape, generator=gen))
    ema.requires_grad_(False)
    rng = np.random.default_rng(9)
    tok = byte_tokenizer()
    enc = tok(["hip hop music", "rain"], max_length=16)
    unc = tok([""], max_length=16)
    batch = {"log_mel_spec": rng.standard_normal((2, 1, 160, 8)).astype(np.float32),  # 320 level-0 tokens
             "input_ids": enc["input_ids"], "attention_mask": enc["attention_mask"],
             "uncond_ids": unc["input_ids"], "uncond_mask": unc["attention_mask"]}
    draws = {"latent_eps": torch.randn(2, 4, 80, 4, generator=gen), "noise": torch.randn(2, 4, 80, 4, generator=gen),
             "idx": torch.tensor([49, 0]), "w": torch.tensor([2.2, 2.9])}
    gpu_mods, gpu_lora, gpu_ema = (copy.deepcopy(x).to("cuda") for x in (cpu_mods, lora, ema))
    out = {}
    saved_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with fa.min_tokens(256):  # both devices route the tiny level 0 (320 tokens) alone
            reset_launches()
            for name, mods, student, target in (("gpu", gpu_mods, gpu_lora, gpu_ema), ("cpu", cpu_mods, lora, ema)):
                loss, _ = ds.distill_loss_fn(student, target, mods, batch, lcfg.scale, w=(2.0, 3.0), draws=draws)
                loss.backward()
                out[name] = (loss.item(), [p.grad.detach().cpu() for p in student.parameters()])
            torch.cuda.synchronize()
            counts = launch_counts()
    finally:
        torch.backends.cudnn.allow_tf32 = saved_tf32
    routed = [sum(counts[k].values()) for k in ("flash_fwd", "flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq")]
    check(routed == [18, 6, 6, 6], f"tiny distill loss routed {routed} calls through K1, K3, K4, K5 (expect 18, 6, 6, 6)")
    loss_err = abs(out["gpu"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    top = max(g.abs().max().item() for g in out["cpu"][1])
    grad_err = max((a - b).abs().max().item() for a, b in zip(*(out[n][1] for n in ("gpu", "cpu"))))
    check(loss_err <= 1e-5, f"tiny fp32 distill loss, card vs CPU: {out['gpu'][0]:.6g} vs {out['cpu'][0]:.6g}, "
                            f"relative {loss_err:.3g} <= 1e-5")
    check(grad_err <= 1e-4 * top and top > 0,
          f"tiny fp32 distill loss, card vs CPU: max adapter-gradient |d| {grad_err:.3g} <= {1e-4 * top:.3g} "
          f"(1e-4 of the largest entry)")
    return {"loss_rel_err": loss_err, "grad_max_abs_err": grad_err, "grad_max": top}


def distill_cli(torch) -> dict:
    """The user's path: a full-width checkpoint (``write_checkpoint``, the
    vocoder's gain calibrated) and
    the synthesized corpus (``write_corpus``), ``cli distill`` in this
    process for ``CLI_DISTILL_STEPS`` steps at batch 2 with ``--w
    DISTILL_W`` (bf16, the run config's default), then ``cli generate
    --scheduler lcm --steps LCM_STEPS --lora OUT/model.safetensors`` at
    10.24 s. Checks: the steps ran and printed the JAX CLI's last line;
    ``model.safetensors`` and ``student.safetensors`` hold the EMA and the
    student under the adapter's keys; K1 30 and K3-K5 10 launches a step a
    routed level; the clip's waveform; K1 ``10 * LCM_STEPS`` a routed level
    at batch 1 and K2 1 + 1. Times cli distill's run and, with the adapter merged by hand,
    s/clip of the lcm clip (median of 3)."""
    import contextlib
    import io
    import statistics
    import tempfile

    from audioldm_tpu_torch import cli
    from audioldm_tpu_torch.ckpt import read_safetensors
    from audioldm_tpu_torch.data.wavio import read_wav
    from audioldm_tpu_torch.kernels import launch_counts, reset_launches
    from audioldm_tpu_torch.lora import export_peft_state_dict
    from audioldm_tpu_torch.pipeline import generate as pg

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, corpus, run_dir = (os.path.join(tmp, n) for n in ("ckpt", "corpus", "run"))
        os.makedirs(corpus)
        t0 = time.perf_counter()
        write_checkpoint(torch, ckpt, calibrate=True)
        write_corpus(corpus)
        out["setup_s"] = time.perf_counter() - t0

        printed = io.StringIO()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            state = cli.main(["distill", "--checkpoint", ckpt, "--dataset", corpus, "--output", run_dir, "--batch-size", "2",
                              "--max-steps", str(CLI_DISTILL_STEPS), "--w", DISTILL_W, "--log-every", "1"])
        torch.cuda.synchronize()
        out["run_s"] = time.perf_counter() - t0
        counts = launch_counts()
        print(printed.getvalue(), end="", flush=True)
        n = CLI_DISTILL_STEPS
        check(state.step == n and f"distilled {n} steps -> {run_dir}/model.safetensors; final loss" in printed.getvalue(),
              f"distill: cli distill ran {state.step} steps and says so (expect {n})")
        count_checks(counts, {"flash_fwd": unet_calls(2, 3 * n),
                              **{k: unet_calls(2, n) for k in ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq")}},
                     f"distill: cli distill, {n} steps")
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        check([r["step"] for r in recs] == list(range(1, n + 1)) and all(math.isfinite(r["distill_loss"]) for r in recs),
              f"distill: one finite distill_loss line a step in metrics.jsonl: {[r.get('distill_loss') for r in recs]}")
        for name, adapters in (("model", state.ema_lora), ("student", state.lora)):
            path = os.path.join(run_dir, f"{name}.safetensors")
            want = export_peft_state_dict(adapters)
            got = read_safetensors(path) if os.path.exists(path) else {}
            check(got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want),
                  f"distill: {name}.safetensors holds the {'EMA' if name == 'model' else 'student'} adapter "
                  f"({len(got)} tensors, expect {len(want)})")
        out.update(losses=[r["distill_loss"] for r in recs], launches=counts)
        del state
        torch.cuda.empty_cache()

        model = os.path.join(run_dir, "model.safetensors")
        wav_path = os.path.join(tmp, "lcm.wav")
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            cli.main(["generate", "--checkpoint", ckpt, "--prompt", "hip hop music with a heavy bass line", "--scheduler", "lcm",
                      "--steps", str(LCM_STEPS), "--seconds", str(SECONDS), "--lora", model, "--output", wav_path])
        torch.cuda.synchronize()
        out["generate_cli_s"] = time.perf_counter() - t0
        counts = launch_counts()
        wav, _ = read_wav(wav_path)
        wave_checks(torch, torch.from_numpy(wav)[None], SECONDS, "distill: cli generate --scheduler lcm with the distilled adapter")
        count_checks(counts, {"flash_fwd": unet_calls(1, LCM_STEPS)},
                     f"distill: lcm {LCM_STEPS} with the distilled adapter")
        k2_want = {((1, c, t), post): 1 for c, t, post in ((64, 81936, 0), (32, 163872, 7))}
        check(counts["mrf_stage"] == k2_want, f"distill: lcm clip's K2 launched {counts['mrf_stage']} (expect {k2_want})")
        out["lcm_launches"] = counts

        mods = pg.AudioLDMModules.from_checkpoint(ckpt, device="cuda")
        cli.merge_lora_specs(mods, [model])
        tok = byte_tokenizer()
        enc, unc = tok(["hip hop music with a heavy bass line"]), tok([""])
        args = (mods, enc["input_ids"], enc["attention_mask"], unc["input_ids"], unc["attention_mask"])
        clip_s = []
        for seed in range(4):
            t0 = time.perf_counter()
            pg.generate(*args, seed=seed, num_inference_steps=LCM_STEPS, audio_length_in_s=SECONDS, scheduler="lcm")
            torch.cuda.synchronize()
            clip_s.append(time.perf_counter() - t0)
        out["lcm_s_per_clip"], out["lcm_clip_s"] = statistics.median(clip_s[1:]), clip_s[1:]
        del mods
    torch.cuda.empty_cache()
    return out


def ckpt_drill_path(torch) -> dict:
    """The checkpoint drill (``python -m audioldm_tpu_torch.tools.ckpt_drill
    --write --width full``): a full-width checkpoint written by the port,
    ``cli generate`` as a subprocess on the card in fp32 and in bf16, each
    against the CPU fp32 replay of the same trajectory within the tool's
    bounds, each bound below the distance to another seed's trajectory.
    Passes when the tool does."""
    import contextlib
    import io
    import tempfile

    from audioldm_tpu_torch.tools import ckpt_drill

    printed = io.StringIO()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(printed):
        rc = ckpt_drill.main(["--write", "--width", "full", "--out", tmp, "--device", "cuda"])
    lines = printed.getvalue().strip().splitlines()
    result = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else {"pass": False, "printed": lines[-5:]}
    result["drill_s"] = time.perf_counter() - t0
    check(rc == 0 and result.get("pass") is True,
          "ckpt_drill: the full-width drill passes in " + ", ".join(
              f"{d} (max|d| {result[d]['max_abs_diff']:.3g} <= {result[d]['bound']}, corr {result[d]['corr']:.6f})"
              for d in ("fp32", "bf16") if d in result) + f"; another seed's trajectory {result.get('separation')} away")
    return result


PAR_CLI_STEPS = 10  # the parallel phase's torchrun subprocesses: DDIM steps of generate and serve
PAR_TRAIN_STEPS = 2  # ... and the steps of train and distill
PAR_DP_STEPS = 5  # timed train_step(mesh=) steps, after the equality step
GL_ITERS, GL_CARD_VS_CPU = 32, 1e-3  # Griffin-Lim iterations at the full mel geometry; bound on max|card - CPU| / peak


def nccl_rows(prof) -> dict:
    """The profiler's collective rows: NCCL device kernels (count, ms), the
    host ops of collectives by name, and ``all_reduces``, the calls (the
    largest count among the host rows that name an all-reduce: c10d's op
    and the ``nccl:all_reduce`` range count one each a call)."""
    events = prof.key_averages()
    dev = [e for e in events if "nccl" in e.key.lower() and str(e.device_type).endswith("CUDA")]
    host = {e.key[:60]: e.count for e in events if not str(e.device_type).endswith("CUDA")
            and any(w in e.key.lower() for w in ("nccl", "allreduce", "all_reduce", "allgather", "all_gather"))}
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    is_ar = lambda k: "allreduce" in k.lower() or "all_reduce" in k.lower()
    host_ar = [e for e in events if not str(e.device_type).endswith("CUDA") and is_ar(e.key)]
    return {"device_kernels": sum(e.count for e in dev), "device_ms": sum(dev_us(e) for e in dev) / 1e3,
            "device_rows": {e.key[:60]: e.count for e in dev}, "host_ops": host,
            "all_reduces": max((n for k, n in host.items() if is_ar(k)), default=0),
            # the host time of the calls: the outermost all-reduce row (c10d's op holds NCCL's range)
            "all_reduce_host_ms": max((e.cpu_time_total for e in host_ar), default=0.0) / 1e3}


def torchrun_cmd(nproc: int, *args) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(nproc),
            "-m", "audioldm_tpu_torch.cli", *args]


def run_concurrently(cmds: dict, timeout: float) -> dict:
    """Start every command at once; ``{name: (exit code, seconds, stdout,
    stderr)}``. A command past ``timeout`` is killed (exit code None)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__)) + os.pathsep + env.get("PYTHONPATH", "")
    procs = {n: (subprocess.Popen(c, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
                 time.perf_counter()) for n, c in cmds.items()}
    out = {}
    for name, (proc, t0) in procs.items():
        try:
            so, se = proc.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
            out[name] = (proc.returncode, time.perf_counter() - t0, so, se)
        except subprocess.TimeoutExpired:
            proc.kill()
            so, se = proc.communicate()
            out[name] = (None, time.perf_counter() - t0, so, se)
    return out


def parallel_cli(torch, tmp: str, nproc: int, half_batch: bool = False) -> dict:
    """``generate --tp``, ``train --dp``, ``distill --dp`` and ``serve --dp
    --requests`` at full width as torchrun subprocesses of ``nproc``
    processes, all four at once (one card holds them), from the checkpoint
    and corpus in ``tmp``. With ``half_batch`` train and distill take batch
    1 a rank, so that 2 ranks step on the global batch of 2 of one rank."""
    import numpy as np

    from audioldm_tpu_torch.ckpt import read_safetensors
    from audioldm_tpu_torch.data.wavio import read_wav

    ckpt, corpus, w = os.path.join(tmp, "ckpt"), os.path.join(tmp, "corpus"), f"w{nproc}"
    bs = "1" if half_batch else "2"
    with open(os.path.join(tmp, "requests.jsonl"), "w") as f:
        for p, a in zip(ENGINE_PROMPTS, ENGINE_MIXED):
            f.write(json.dumps({"prompt": p, "adapter": None if a == "base" else "a"}) + "\n")
    cmds = {
        "generate": torchrun_cmd(nproc, "generate", "--checkpoint", ckpt, "--prompt", EVAL_PROMPT, "--steps", str(PAR_CLI_STEPS),
                                 "--seconds", str(SECONDS), "--output", os.path.join(tmp, f"{w}_tp.wav"), "--tp", str(nproc)),
        "train": torchrun_cmd(nproc, "train", "--checkpoint", ckpt, "--dataset", corpus, "--output", os.path.join(tmp, f"{w}_train"),
                              "--batch-size", bs, "--max-steps", str(PAR_TRAIN_STEPS), "--validate-every", "0", "--log-every", "1",
                              "--dp", str(nproc)),
        "distill": torchrun_cmd(nproc, "distill", "--checkpoint", ckpt, "--dataset", corpus, "--output",
                                os.path.join(tmp, f"{w}_distill"), "--batch-size", bs, "--max-steps", str(PAR_TRAIN_STEPS),
                                "--w", DISTILL_W, "--log-every", "1", "--dp", str(nproc)),
        "serve": torchrun_cmd(nproc, "serve", "--checkpoint", ckpt, "--lora", f"a={os.path.join(tmp, 'a.safetensors')}",
                              "--requests", os.path.join(tmp, "requests.jsonl"), "--output", os.path.join(tmp, f"{w}_serve"),
                              "--steps", str(PAR_CLI_STEPS), "--seconds", str(SECONDS), "--dp", str(nproc)),
    }
    runs = run_concurrently(cmds, 600.0)
    out = {}
    for name, (rc, secs, so, se) in runs.items():
        check(rc == 0, f"parallel: torchrun --nproc-per-node {nproc} cli {name} exits 0 (got {rc}, {secs:.1f} s)"
                       + ("" if rc == 0 else f"\n{so[-2000:]}\n{se[-3000:]}"))
        out[name] = {"exit": rc, "s": secs}
    if runs["generate"][0] == 0:
        wav, _ = read_wav(os.path.join(tmp, f"{w}_tp.wav"))
        wave_checks(torch, torch.from_numpy(wav)[None], SECONDS, f"parallel: cli generate --tp {nproc}")
        check(runs["generate"][2].count(f"tensor-parallel over {nproc} devices") == 1, f"parallel: --tp {nproc} path taken")
        out["generate"]["wav"] = wav
    for name, files in (("train", [f"checkpoint-{PAR_TRAIN_STEPS}/model.safetensors"]),
                        ("distill", ["model.safetensors", "student.safetensors"])):
        if runs[name][0] == 0:
            paths = [os.path.join(tmp, f"{w}_{name}", f) for f in files]
            check(all(os.path.exists(p) for p in paths), f"parallel: cli {name} --dp {nproc} wrote {files}")
            with open(os.path.join(tmp, f"{w}_{name}", "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            key = "train_loss" if name == "train" else "distill_loss"
            check(len(recs) == PAR_TRAIN_STEPS and all(math.isfinite(r[key]) for r in recs),
                  f"parallel: cli {name} --dp {nproc}: {PAR_TRAIN_STEPS} finite {key} lines, one writer")
            out[name]["adapters"] = {f: read_safetensors(p) for f, p in zip(files, paths)}
    if runs["serve"][0] == 0:
        wavs = [read_wav(os.path.join(tmp, f"{w}_serve", f"{i:06d}.wav"))[0] for i in range(len(ENGINE_PROMPTS))]
        for i, x in enumerate(wavs):
            wave_checks(torch, torch.from_numpy(x)[None], SECONDS, f"parallel: cli serve --dp {nproc} row {i}")
        out["serve"]["wavs"] = np.stack(wavs)
    return out


def parallel_path(torch, serve_s_per_clip=None, train_s_per_step=None) -> dict:
    """Parallelism at full width on this card, world size 1 over NCCL.

    - TP generation: ``make_tp_generate_fn`` at tp 1 (every attention split
      into one rank's heads, one all-reduce after each), DDIM 50, 10.24 s,
      CFG 2.5, against ``pipeline.generate`` on the same seed (mel
      correlation >= 0.9, the samplers phase's bound for the same function
      at another rounding): K1 500 a routed level, K2 1 + 1, and the
      NCCL all-reduces of two denoise steps from the profiler.
    - DP training: ``train_step(mesh=)`` against the plain step on the
      training cell's batch from the same state and draws, equal bits
      under deterministic algorithms; K3-K5 10 a step a routed level; the step's seconds
      against the plain step's; the all-reduces a step.
    - DP serving: ``ServeEngine(mesh=)`` on the engine phase's mixed batch
      (rank-r, bucket 4) against the engine without a mesh on the rank-r
      route: within 1e-6; K1 500 a routed level at batch 8, K2 1 + 1 at batch 4.
    - Griffin-Lim (``ops.invert.inv_mel_spec``, 32 iterations) of a 10.24 s
      log-mel on the card against the CPU from the same phase.
    - ``cli generate --tp 1``, ``train --dp 1``, ``distill --dp 1`` and
      ``serve --dp 1 --requests`` under torchrun, at once; with two cards or
      more, again at world size 2, held against world size 1."""
    import copy
    import statistics
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from audioldm_tpu_torch import config as cfg
    from audioldm_tpu_torch.ckpt import write_safetensors
    from audioldm_tpu_torch.eval.proximity import calibrate_vocoder_gain, mel_correlation
    from audioldm_tpu_torch.kernels import launch_counts, reset_launches
    from audioldm_tpu_torch.lora import export_peft_state_dict, init_lora
    from audioldm_tpu_torch.ops.invert import inv_mel_spec
    from audioldm_tpu_torch.ops.mel import log_mel_spectrogram
    from audioldm_tpu_torch.parallel import make_mesh, make_tp_generate_fn, make_tp_mesh, shard_modules, split_blocks
    from audioldm_tpu_torch.pipeline import generate as pg
    from audioldm_tpu_torch.serve import AdapterBank, ServeEngine
    from audioldm_tpu_torch.train import Trainer
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    out = {"launches": {}}
    tok = byte_tokenizer()
    enc, unc = tok([EVAL_PROMPT]), tok([""])
    prompts = (enc["input_ids"], enc["attention_mask"], unc["input_ids"], unc["attention_mask"])
    bf16 = torch.bfloat16
    k2_one = {((1, c, t), post): 1 for c, t, post in ((64, 81936, 0), (32, 163872, 7))}

    # -- TP generation at tp 1 ---------------------------------------------------
    tp_mesh = make_tp_mesh(1, device="cuda")
    out["backend"] = dist.get_backend()
    check(out["backend"] == "nccl", f"parallel: the process group runs {out['backend']} (expect nccl)")
    mods = pg.random_modules(seed=0, device="cuda")
    calibrate_vocoder_gain(mods, (1, int(SECONDS * 100), 64))
    tp_mods = shard_modules(tp_mesh, mods)
    fn = make_tp_generate_fn(tp_mods, tp_mesh, num_inference_steps=STEPS, audio_length_in_s=SECONDS, guidance_scale=2.5)
    make_tp_generate_fn(tp_mods, tp_mesh, num_inference_steps=2, audio_length_in_s=SECONDS)(*prompts, seed=0)  # warm-up

    def timed(f):
        t0 = time.perf_counter()
        r = f()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    reset_launches()
    wav_tp, s0 = timed(lambda: fn(*prompts, seed=0))
    counts = launch_counts()
    plain_fn = lambda: pg.generate(mods, *prompts, seed=0, num_inference_steps=STEPS, audio_length_in_s=SECONDS,
                                   guidance_scale=2.5)
    wav_plain, p0 = timed(plain_fn)
    # the rest in turns (plain, TP, TP, plain): the host's pace drifts within a process
    tp_s, plain_s = [s0], [p0]
    for f, into in ((plain_fn, plain_s), (lambda: fn(*prompts, seed=0), tp_s), (lambda: fn(*prompts, seed=0), tp_s),
                    (plain_fn, plain_s)):
        into.append(timed(f)[1])
    # one all-reduce's host time without the profiler: a level-0 attention's output, [2, 4096, 128] bf16
    x = torch.zeros((2, 4096, 128), dtype=bf16, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        dist.all_reduce(x, group=tp_mesh.groups["tp"])
    torch.cuda.synchronize()
    ar_us = (time.perf_counter() - t0) / 200 * 1e6
    wave_checks(torch, wav_tp, SECONDS, "parallel: TP generation at tp 1")
    count_checks(counts, {"flash_fwd": unet_calls(2, STEPS)}, "parallel: TP generation")
    check(counts["mrf_stage"] == k2_one, f"parallel: TP generation's K2 launched {counts['mrf_stage']} (expect {k2_one})")
    corr = mel_correlation(wav_tp[0].cpu().numpy(), wav_plain[0].cpu().numpy())
    check(corr >= 0.9, f"parallel: TP generation at tp 1 against pipeline.generate, mel correlation {corr:.4f} >= 0.9")
    n_split = split_blocks(tp_mods.unet)
    with torch.inference_mode():
        cond, uncond = pg.encode_stage(tp_mods, *prompts)
        lat = pg.init_noise(tp_mods, 0, 1, SECONDS)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pg.denoise(tp_mods, lat, cond, uncond, 2, 2.5, bf16)
            torch.cuda.synchronize()
    rows = nccl_rows(prof)
    check(rows["all_reduces"] == 2 * n_split,
          f"parallel: TP denoise all-reduces {rows['all_reduces']} times in 2 steps (expect 2 x {n_split} split blocks)")
    out["tp_generate"] = {"s_per_clip": statistics.median(tp_s), "clip_s": tp_s, "plain_clip_s": plain_s,
                          "plain_s_per_clip": statistics.median(plain_s), "serve_phase_s_per_clip": serve_s_per_clip,
                          "all_reduce_host_us": ar_us,
                          "mel_correlation_vs_plain": corr,
                          "max_abs_diff_vs_plain": (wav_tp - wav_plain).abs().max().item(),
                          "split_blocks": n_split, "all_reduce_per_step": rows["all_reduces"] / 2,
                          "all_reduce_host_ms_per_step": rows["all_reduce_host_ms"] / 2,
                          "nccl_device_ms_per_step": rows["device_ms"] / 2, "nccl_kernels_per_step": rows["device_kernels"] / 2,
                          "nccl_rows": rows}
    out["launches"]["tp_generate"] = counts
    del tp_mods, fn, mods
    torch.cuda.empty_cache()

    # -- DP training --------------------------------------------------------------
    dp_mesh = make_mesh(1, device="cuda")
    lcfg, tcfg = cfg.LoRAConfig(), cfg.TrainConfig()
    tmods = pg.random_modules(seed=0, device="cuda")
    lora0 = init_lora(tmods.unet, lcfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for b in lora0.b.values():
            b.copy_(0.1 * torch.randn(b.shape, generator=torch.Generator().manual_seed(1)))
    with tempfile.TemporaryDirectory() as d:
        plain_tr = Trainer(tmods, lcfg, tcfg, d, dtype=bf16)
        dp_tr = Trainer(tmods, lcfg, tcfg, d, dtype=bf16, mesh=dp_mesh)
        sa, sb = plain_tr.init_state(copy.deepcopy(lora0)), dp_tr.init_state(copy.deepcopy(lora0))
        batch = next(train_batches(1, seed=5))
        det = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic)
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        try:
            sa, ma = plain_tr.step_fn(sa, batch, torch.Generator(device="cuda").manual_seed(2))
            reset_launches()
            sb, mb = dp_tr.step_fn(sb, batch, torch.Generator(device="cuda").manual_seed(2))
            torch.cuda.synchronize()
            counts = launch_counts()
        finally:
            torch.use_deterministic_algorithms(det[0])
            torch.backends.cudnn.deterministic = det[1]
        diff = max((x - y).abs().max().item() for x, y in zip(sa.lora.parameters(), sb.lora.parameters()))
        check(diff == 0.0 and ma["loss"].item() == mb["loss"].item(),
              f"parallel: train_step(mesh=) at world 1 equals the plain step: adapters max|d| {diff:.3g}, "
              f"loss {mb['loss'].item():.6f} vs {ma['loss'].item():.6f}")
        count_checks(counts, {k: unet_calls(2, 1) for k in ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq")},
                     "parallel: one DP step")
        out["launches"]["dp_step"] = counts
        step_s = {"dp": [], "plain": []}
        gen = torch.Generator(device="cuda").manual_seed(3)
        for i, b in enumerate(train_batches(2 * PAR_DP_STEPS, seed=6)):
            tr, st = (dp_tr, sb) if i % 2 == 0 else (plain_tr, sa)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, _ = tr.step_fn(st, b, gen)
            torch.cuda.synchronize()
            step_s["dp" if i % 2 == 0 else "plain"].append(time.perf_counter() - t0)
            sb, sa = (st, sa) if i % 2 == 0 else (sb, st)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sb, _ = dp_tr.step_fn(sb, batch, gen)
            torch.cuda.synchronize()
        rows = nccl_rows(prof)
        check(rows["all_reduces"] == 2, f"parallel: a DP step all-reduces {rows['all_reduces']} times (expect 2: the "
                                        f"gradients, the loss)")
    out["dp_step"] = {"s_per_step": statistics.median(step_s["dp"]), "step_s": step_s["dp"],
                      "plain_s_per_step": statistics.median(step_s["plain"]), "train_phase_s_per_step": train_s_per_step,
                      "all_reduce_per_step": rows["all_reduces"], "all_reduce_host_ms_per_step": rows["all_reduce_host_ms"],
                      "nccl_device_ms_per_step": rows["device_ms"], "nccl_kernels_per_step": rows["device_kernels"],
                      "nccl_rows": rows}
    del plain_tr, dp_tr, sa, sb, tmods
    torch.cuda.empty_cache()

    # -- DP serving -----------------------------------------------------------------
    smods = pg.random_modules(seed=0, device="cuda")
    calibrate_vocoder_gain(smods, (1, int(SECONDS * 100), 64))
    gen = torch.Generator().manual_seed(0)
    adapters = {}
    for name in ("a", "b"):
        adapters[name] = init_lora(smods.unet, lcfg, gen)
        with torch.no_grad():
            for b in adapters[name].b.values():
                b.copy_(0.3 * torch.randn(b.shape, generator=gen))
    bank = AdapterBank.from_adapters(adapters, lcfg, device="cuda")
    eng_dp = ServeEngine(smods, tok, lcfg, bank=bank, mesh=dp_mesh)
    eng_plain = ServeEngine(smods, tok, lcfg, bank=bank, bucket_sizes=(ENGINE_BUCKET,))
    kw = dict(audio_length_in_s=SECONDS, guidance_scale=2.5)
    run = lambda e, steps: e.generate(list(ENGINE_PROMPTS), adapters=list(ENGINE_MIXED), num_inference_steps=steps, **kw)
    run(eng_dp, 2)
    run(eng_plain, 2)
    reset_launches()
    batches0 = dict(eng_dp.batches)
    wav_dp, s_dp = timed(lambda: run(eng_dp, STEPS))
    counts = launch_counts()
    routed = {k: v - batches0.get(k, 0) for k, v in eng_dp.batches.items() if v - batches0.get(k, 0)}
    wav_pl, s_pl = timed(lambda: run(eng_plain, STEPS))
    s_dp2, s_pl2 = timed(lambda: run(eng_dp, STEPS))[1], timed(lambda: run(eng_plain, STEPS))[1]
    diff = float(np.abs(wav_dp - wav_pl).max())
    check(diff <= 1e-6, f"parallel: ServeEngine(mesh=) at world 1 against the engine without a mesh (rank-r): max|d| {diff:.3g} <= 1e-6")
    count_checks(counts, {"flash_fwd": unet_calls(2 * ENGINE_BUCKET, STEPS)}, "parallel: DP serving")
    k2_srv = {((ENGINE_BUCKET, c, t), post): 1 for c, t, post in ((64, 81936, 0), (32, 163872, 7))}
    check(counts["mrf_stage"] == k2_srv, f"parallel: DP serving's K2 launched {counts['mrf_stage']} (expect {k2_srv})")
    check(routed == {("rank_r", ENGINE_BUCKET): 1}, f"parallel: the mixed batch took {routed} under a mesh (expect rank_r 4)")
    out["dp_serving"] = {"s_per_batch": [s_dp, s_dp2], "plain_s_per_batch": [s_pl, s_pl2], "max_abs_diff_vs_plain": diff,
                         "routes": {f"{k[0]}_{k[1]}": v for k, v in routed.items()}}
    out["launches"]["dp_serving"] = counts
    del eng_dp, eng_plain, smods, bank
    torch.cuda.empty_cache()

    # -- Griffin-Lim on the card ------------------------------------------------------
    logmel = log_mel_spectrogram(torch.from_numpy(synthetic_clip(SECONDS))[None])
    gl_gen = torch.Generator().manual_seed(0)
    phase = torch.rand((1, logmel.shape[1], 513), generator=gl_gen) * (2 * math.pi) - math.pi
    ref = inv_mel_spec(logmel, n_iters=GL_ITERS, phase=phase)
    inv_mel_spec(logmel.cuda(), n_iters=2, phase=phase)  # warm-up: cuFFT plans
    got, gl_s = timed(lambda: inv_mel_spec(logmel.cuda(), n_iters=GL_ITERS, phase=phase))
    rel = (got.cpu() - ref).abs().max().item() / ref.abs().max().item()
    check(bool(torch.isfinite(got).all()) and rel <= GL_CARD_VS_CPU,
          f"parallel: Griffin-Lim ({GL_ITERS} iterations, log-mel {tuple(logmel.shape)}) card vs CPU, max|d| / peak "
          f"{rel:.3g} <= {GL_CARD_VS_CPU}")
    out["griffin_lim"] = {"s": gl_s, "rel_diff_vs_cpu": rel, "samples": got.shape[-1]}

    # -- the CLI under torchrun ------------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "corpus"))
        write_checkpoint(torch, os.path.join(tmp, "ckpt"), calibrate=True)
        write_corpus(os.path.join(tmp, "corpus"))
        write_safetensors(os.path.join(tmp, "a.safetensors"), export_peft_state_dict(adapters["a"]))
        dist.destroy_process_group()  # the subprocesses use the card; this process's group is done
        one = parallel_cli(torch, tmp, 1)
        out["cli_w1"] = {k: {"exit": v["exit"], "s": v["s"]} for k, v in one.items()}
        cards = torch.cuda.device_count()
        if cards >= 2:
            two = parallel_cli(torch, tmp, 2, half_batch=True)
            out["cli_w2"] = {k: {"exit": v["exit"], "s": v["s"]} for k, v in two.items()}
            if "wav" in one["generate"] and "wav" in two["generate"]:
                c = mel_correlation(two["generate"]["wav"], one["generate"]["wav"])
                check(c >= 0.9, f"parallel: cli generate --tp 2 against --tp 1, mel correlation {c:.4f} >= 0.9")
            if "wavs" in one["serve"] and "wavs" in two["serve"]:
                c = min(mel_correlation(x, y) for x, y in zip(two["serve"]["wavs"], one["serve"]["wavs"]))
                check(c >= 0.9, f"parallel: cli serve --dp 2 against --dp 1, least row mel correlation {c:.4f} >= 0.9")
            for name in ("train", "distill"):
                if "adapters" in one[name] and "adapters" in two[name]:
                    d = max((one[name]["adapters"][f][k].float() - two[name]["adapters"][f][k].float()).abs().max().item()
                            for f in one[name]["adapters"] for k in one[name]["adapters"][f])
                    # Adam moves each entry about one learning rate (1e-5) a step whatever the rounding
                    check(d <= 2e-5 * PAR_TRAIN_STEPS, f"parallel: cli {name} --dp 2 (batch 1 a rank) against --dp 1 "
                                                       f"(batch 2): adapters max|d| {d:.3g}")
        else:
            print(f"parallel: world size 2 not run on the card: this machine has {cards} CUDA device(s)", flush=True)
    out["parallel_s"] = time.perf_counter() - t_phase
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    from audioldm_tpu_torch.kernels import _build

    print(card(), flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build_s {time.perf_counter() - t0:.2f}", flush=True)
    print("build_s_by_source " + json.dumps({n: round(s, 2) for n, s in _build.seconds.items()}), flush=True)
    for name, log in _build.logs.items():
        if log.strip():
            print(f"nvcc {name}:\n{log.strip()}", flush=True)

    for fn, c in sass_counts().items():
        print(f"sass {fn} {json.dumps(c)}", flush=True)

    phases = set(PHASES) if len(sys.argv) < 2 else set(sys.argv[1].split(","))
    if not phases <= set(PHASES + EXTRA_PHASES):
        print(f"chip_smoke: phases are {','.join(PHASES + EXTRA_PHASES)}", file=sys.stderr)
        return 2
    # references in full fp32: cuDNN's fp32 convolutions default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    serve_s = train_s = None  # the serve and train phases' s/clip and s a step, for the parallel phase's lines
    serve_kernels = flash_cases(torch) + mrf_cases(torch) + serving_batch_cases(torch) if "kernels" in phases else []
    val_kernels = serving_batch_cases(torch, VAL_CLIPS, 14, "validation batch") if "kernels" in phases else []
    one_kernels = one_cases(torch) if "kernels" in phases else []
    if "kernels" in phases:
        print("k2_inference_mode " + json.dumps({"card": card(), **k2_inference_mode(torch)}), flush=True)
    train_kernels = flash_train_cases(torch) if "kernels" in phases else []
    level_kernels = level_cases(torch) if phases & {"kernels", "levels"} else []
    if level_kernels:
        print("level_kernels " + json.dumps(level_kernels), flush=True)
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True  # the main paths run PyTorch's defaults
    if "serve" in phases:
        path = main_path(torch)
        fp32_k1 = {(dtype, tuple(shape)): n for (dtype, shape), n in path["denoise_profile_fp32"]["k1_launches"]}
        for case in serve_kernels:  # the serving path's launches at this entry's dtype and shape
            case["launches"] = path["launches"][case["name"]].get(case["variant"], 0)
            if case["name"] == "flash_fwd" and case["variant"] in fp32_k1:  # and the two fp32 denoise steps'
                case["launches_fp32_steps"] = case["launches"] = fp32_k1[case["variant"]]
        serve_s = path["s_per_clip"]
        print(f"s_per_clip {path['s_per_clip']:.4f} (median of 3 clips; {STEPS} DDIM steps, {SECONDS} s, bf16, CFG 2.5)",
              flush=True)
        path["launches"] = {name: [[list(key), n] for key, n in c.items()] for name, c in path["launches"].items()}
        print("main_path " + json.dumps(path), flush=True)
        del path
        torch.cuda.empty_cache()
    if "train" in phases:
        train = train_path(torch)
        train_s = train["s_per_step"]
        fp32_steps = train["fp32_step"]["steps"]
        for case in train_kernels:  # the training path's launches, over its TRAIN_STEPS steps (fp32: its fp32 steps)
            case["launches"] = train["launches"][case["name"]].get(case["variant"], 0)
            case["launches_per_step"] = case["launches"] / TRAIN_STEPS
            fp32_n = train["fp32_launches"].get(case["name"], {}).get(case["variant"], 0)
            if fp32_n:
                case["launches"] += fp32_n
                case["launches_fp32_steps"], case["launches_per_step"] = fp32_n, fp32_n / fp32_steps
        print(f"s_per_step {train['s_per_step']:.4f} ({train['samples_per_s']:.2f} samples/s; median of {TRAIN_STEPS} "
              f"steps, batch 2, bf16 frozen modules, fp32 rank-2 adapters on to_q and to_v)", flush=True)
        train["launches"] = {name: [[list(key), n] for key, n in c.items()] for name, c in train["launches"].items()}
        del train["fp32_launches"]  # as train["fp32_step"]["launches"]
        print("train_path " + json.dumps(train), flush=True)
        torch.cuda.empty_cache()
    if "train_cli" in phases:
        from audioldm_tpu_torch.tools import bench_dataprep

        tc = train_cli_path(torch)
        for case in serve_kernels + train_kernels + val_kernels:  # cli train's launches, validation's included
            case["launches_train_cli"] = tc["launches"][case["name"]].get(case["variant"], 0)
            if not case.get("launches"):  # K1 and K2 at the validation batch: this path's rows
                case["launches"] = case["launches_train_cli"]
        print(f"train_cli s_per_step {tc['s_per_step']:.4f} ({tc['samples_per_s']:.2f} samples/s; cli train from wav files, "
              f"batch 2, median of the steps after the first without validation), first_batch_s {tc['first_batch_s']:.3f}, "
              f"data_wait_share {json.dumps([round(x, 4) for x in tc['data_wait_share']])}", flush=True)
        for run in (tc, tc["resume"]):
            run["launches"] = {k: [[list(key), n] for key, n in c.items()] for k, c in run["launches"].items() if c}
        print("train_cli " + json.dumps({"card": card(), **tc}), flush=True)
        # BASELINE config 3: batch data prep at batch 64 of 10.24 s clips
        for rec in bench_dataprep.run(batch=64, batches=8, device="cuda"):
            check(rec["value"] is not None and rec.get("finite", True),
                  f"dataprep {rec['metric']}: {rec['value']} clips/s, finite output")
        del tc
        torch.cuda.empty_cache()
    if "samplers" in phases:
        samplers = samplers_path(torch)
        runs = {name: run for name, run in samplers.items() if isinstance(run, dict) and "launches" in run}
        for case in serve_kernels + one_kernels:  # the sampler paths' launches, summed over their variants' counted clips
            per_run = {name: run["launches"][case["name"]].get(case["variant"], 0) for name, run in runs.items()}
            case["launches_samplers"] = {name: n for name, n in per_run.items() if n}
            if not case.get("launches"):  # K6, and K1 at the batch of 1: launched on these paths only
                case["launches"] = sum(per_run.values())
        for name, run in runs.items():
            print(f"s_per_clip {name} {run['s_per_clip']:.4f} (median of 3 clips)", flush=True)
            run["launches"] = {k: [[list(key), n] for key, n in c.items()] for k, c in run["launches"].items()}
        print("samplers_path " + json.dumps(samplers), flush=True)
        del samplers, runs
        torch.cuda.empty_cache()
    if "a2a" in phases:
        a2a = a2a_path(torch)
        for case in serve_kernels:
            case["launches_a2a"] = sum(a2a[name]["launches"][case["name"]].get(case["variant"], 0) for name in ("style_transfer", "inpaint"))
        for name in ("style_transfer", "inpaint"):
            a2a[name]["launches"] = {k: [[list(key), n] for key, n in c.items()] for k, c in a2a[name]["launches"].items()}
        print("a2a_path " + json.dumps(a2a), flush=True)
        torch.cuda.empty_cache()
    if "engine" in phases:
        engine = engine_path(torch)
        for case in serve_kernels:  # the serving routes' launches, summed over their counted batches
            per_route = {route: run["launches"][case["name"]].get(case["variant"], 0) for route, run in engine["routes"].items()}
            case["launches_engine"] = {route: n for route, n in per_route.items() if n}
            if not case.get("launches"):  # K1 and K2 at the serving batch: launched on these paths only
                case["launches"] = sum(per_route.values())
        for route, run in engine["routes"].items():
            print(f"s_per_batch {route} {run['s_per_batch']:.4f} ({run['clips_per_s']:.3f} clips/s; median of 3 batches of "
                  f"{ENGINE_BUCKET}, {STEPS} DDIM steps, {SECONDS} s, bf16, CFG 2.5)", flush=True)
            run["launches"] = {k: [[list(key), n] for key, n in c.items()] for k, c in run["launches"].items() if c}
        print(f"engine_s {engine['engine_s']:.2f} (routes at DDIM {STEPS}, checks and daemon at DDIM {CHECK_STEPS})", flush=True)
        print("serving " + json.dumps({"card": card(), **engine}), flush=True)
        del engine
        torch.cuda.empty_cache()
    if "eval" in phases:
        ev = eval_path(torch)
        for case in serve_kernels:  # best-of's launches: K1 and K2 at the serving batch (N = ENGINE_BUCKET)
            case["launches_eval"] = ev["best_of"]["launches"][case["name"]].get(case["variant"], 0)
            if not case.get("launches"):
                case["launches"] = case["launches_eval"]
        ev["best_of"]["launches"] = {k: [[list(key), n] for key, n in c.items()] for k, c in ev["best_of"]["launches"].items() if c}
        e = ev["embed_audio"]
        print(f"eval embed_audio {e['ms_per_clip']:.2f} ms a clip at a chunk of {e['chunk']} (host features "
              f"{e['host_features_ms_per_clip']:.2f}, tower {e['tower_ms_per_chunk']:.3f} ms a chunk, device "
              f"{e['tower_device_ms_per_chunk']} unchecked, bound {e['tower_bound_ms_per_chunk']:.3f}); best-of-"
              f"{ev['best_of']['n']} {ev['best_of']['s']:.2f} s", flush=True)
        print("eval " + json.dumps({"card": card(), **ev}), flush=True)
        del ev
        torch.cuda.empty_cache()
    if "routes_fp32" in phases:
        print("routes_fp32 " + json.dumps({"card": card(), **routes_fp32_path(torch)}), flush=True)
        torch.cuda.empty_cache()
    diag_kernels = []
    if "diag" in phases:
        diag = diag_path(torch)
        diag_kernels = diag_cases(torch)
        for case in diag_kernels:  # the tool's launches at this entry's variant, over its five sections
            case["launches"] = diag["launches"][case["counter"]].get(case["variant"], 0)
            if case["tool_shape"]:
                check(case["launches"] > 0, f"{case['name']} {case['shape']} {case.get('block_k', '')}: launched "
                                            f"{case['launches']} times by the tool's sections")
        diag["launches"] = {k: [[list(key), n] for key, n in c.items()] for k, c in diag["launches"].items() if c}
        print(f"diag_s {diag['seconds']:.2f} (sections v1-v5, {DIAG_ITERS} timed calls a kernel)", flush=True)
        print("diag_path " + json.dumps(diag), flush=True)
        torch.cuda.empty_cache()
    if "tools" in phases:
        tools = tools_path(torch)
        for case in serve_kernels + train_kernels:  # the tools' launches: K1 and K2 at the main paths' shapes
            case["launches_tools"] = tools["launches"][case["name"]].get(case["variant"], 0)
            if not case.get("launches"):
                case["launches"] = case["launches_tools"]
        tools["launches"] = {k: [[list(key), n] for key, n in c.items()] for k, c in tools["launches"].items() if c}
        print(f"tools_s {tools['tools_s']:.2f}", flush=True)
        print("tools " + json.dumps({"card": card(), **tools}), flush=True)
        del tools
        torch.cuda.empty_cache()
    if "distill" in phases:
        dist = distill_path(torch)
        for case in serve_kernels + train_kernels:  # a distill step's launches, and the distilled adapter's lcm clip's
            case["launches_distill"] = dist["launches"][case["name"]].get(case["variant"], 0)
            case["launches_distill_per_step"] = case["launches_distill"] / DISTILL_STEPS
            case["launches_lcm_distilled"] = dist["cli"]["lcm_launches"][case["name"]].get(case["variant"], 0)
            if not case.get("launches"):
                case["launches"] = case["launches_distill"] + case["launches_lcm_distilled"]
        prof = dist["step_profile"]
        print(f"distill s_per_step {dist['s_per_step']:.4f} (median of {DISTILL_STEPS} steps, batch 2, bf16 UNet and VAE, "
              f"w ~ U[2, 3)), device_ms_per_step {prof['device_ms_per_step']} unchecked, kernels_per_step "
              f"{prof.get('kernels_per_step')}, peak_mem_gib {dist['peak_mem_gib']:.2f}; cli distill {CLI_DISTILL_STEPS} "
              f"steps {dist['cli']['run_s']:.2f} s; lcm {LCM_STEPS} with the distilled adapter s_per_clip "
              f"{dist['cli']['lcm_s_per_clip']:.4f}; distill_s {dist['distill_s']:.2f}", flush=True)
        for run, key in ((dist, "launches"), (dist["cli"], "launches"), (dist["cli"], "lcm_launches")):
            run[key] = {k: [[list(v), n] for v, n in c.items()] for k, c in run[key].items() if c}
        print("distill " + json.dumps({"card": card(), **dist}), flush=True)
        del dist
        torch.cuda.empty_cache()
    if "ckpt_drill" in phases:
        drill = ckpt_drill_path(torch)
        print(f"ckpt_drill_s {drill['drill_s']:.2f}", flush=True)
        print("ckpt_drill " + json.dumps({"card": card(), **drill}), flush=True)
    if "parallel" in phases:
        par = parallel_path(torch, serve_s, train_s)
        for case in serve_kernels + train_kernels:  # the parallel paths' launches: TP generation, a DP step, DP serving
            per_path = {name: c[case["name"]].get(case["variant"], 0) for name, c in par["launches"].items()}
            case["launches_parallel"] = {name: n for name, n in per_path.items() if n}
            if not case.get("launches"):
                case["launches"] = sum(per_path.values())
        tg, ds = par["tp_generate"], par["dp_step"]
        print(f"parallel tp_generate s_per_clip {tg['s_per_clip']:.4f} at tp 1 (plain {tg['plain_s_per_clip']:.4f} in this "
              f"phase; serve phase {serve_s}), mel_correlation {tg['mel_correlation_vs_plain']:.4f}, all_reduce_per_step "
              f"{tg['all_reduce_per_step']:.0f} ({tg['all_reduce_host_ms_per_step']:.3f} host ms under the profiler; one "
              f"all-reduce {tg['all_reduce_host_us']:.1f} host us without it), nccl_device_ms_per_step "
              f"{tg['nccl_device_ms_per_step']:.4f}", flush=True)
        print(f"parallel dp_step s_per_step {ds['s_per_step']:.4f} at dp 1 (plain {ds['plain_s_per_step']:.4f} in this phase; "
              f"train phase {train_s}), all_reduce_per_step {ds['all_reduce_per_step']} ({ds['all_reduce_host_ms_per_step']:.3f} "
              f"host ms), nccl_device_ms_per_step "
              f"{ds['nccl_device_ms_per_step']:.4f}, nccl_kernels_per_step {ds['nccl_kernels_per_step']}", flush=True)
        par["launches"] = {p: {k: [[list(v), n] for v, n in c.items()] for k, c in cs.items() if c}
                           for p, cs in par["launches"].items()}
        print(f"parallel_s {par['parallel_s']:.2f}", flush=True)
        print("parallel " + json.dumps({"card": card(), **par}), flush=True)
        del par
        torch.cuda.empty_cache()
    if "ab" in phases:
        ab = one_pass_ab(torch)
        print("one_pass_ab_clip_s " + " ".join(f"{k} {' '.join(f'{x:.4f}' for x in v)}" for k, v in ab.items()), flush=True)
        torch.cuda.empty_cache()
    if "tiny" in phases:
        torch.backends.cudnn.allow_tf32 = False
        tiny_reference(torch)
        tiny_clap_reference(torch)
        print("tiny_train " + json.dumps(tiny_train_reference(torch)), flush=True)
    kernels = serve_kernels + val_kernels + one_kernels + train_kernels + level_kernels + diag_kernels
    for case in kernels:
        case.pop("variant", None)
        case.pop("counter", None)

    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
        return 1
    if not phases >= set(PHASES):
        print(f"chip_smoke: only {sorted(phases)} ran; the result lines come with a full run", file=sys.stderr)
        return 0
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
