"""Closed-loop batch generation: one caller sends a batch of ``batch``
distinct requests to ``ServeEngine.generate`` and sends the next when it
returns (offline and batch rendering).

Mix parameters: ``batch``, ``steps``, ``scheduler``, ``guidance``,
``seconds`` (clip length), ``prompt_tokens`` ``[min, max]`` (a prompt's
tokens, padded to 512), ``check_clips`` (clips of the window the reference
recomputes), ``table_rows`` (distinct prompts made).

The window starts after warm-up and ends at the first batch that returns
after ``--seconds``, so it holds whole batches. A traced run profiles one
more batch after the window, with ranges around the text tower, each UNet
step, the VAE decode and the vocoder.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import compare, inputs, program, weights
from portbench import trace as tr
from portbench.reference import ops, pipeline
from audioldm_tpu_torch.serve.engine import ServeEngine


def _requests(seed: int, first: int, n: int) -> tuple[list, list]:
    rows = list(range(first, first + n))
    return [f"r{r}" for r in rows], [inputs.request_seed(seed, r) for r in rows]


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: int, device: torch.device, t0: float) -> dict:
    marks = [("imports", time.perf_counter() - t0)]
    program.build_kernels(device)
    marks.append(("kernels", time.perf_counter() - t0))
    state = weights.make_state(cfg, seed, device)
    mods = program.modules(cfg, state, device)
    del state
    marks.append(("weights and models", time.perf_counter() - t0))
    b = mix["batch"]
    table = inputs.prompt_table(cfg["text_encoder"], seed, mix["table_rows"], *mix["prompt_tokens"])
    tokenizer = program.Tokenizer(*table)
    engine = ServeEngine(mods, tokenizer, dtype=program.dtype_of(cfg), device=device)
    gen = dict(num_inference_steps=mix["steps"], audio_length_in_s=mix["seconds"], guidance_scale=mix["guidance"],
               scheduler=mix["scheduler"])

    def batch(first: int, **over):
        prompts, seeds = _requests(seed, first, b)
        return engine.generate(prompts, seeds=seeds, **{**gen, **over})

    # warm-up: this cell's shapes, on requests the window never sends
    batch(mix["table_rows"] - b, num_inference_steps=2)
    program.sync(device)
    setup_s = time.perf_counter() - t0
    marks.append(("warm-up", setup_s))

    if device.type == "cuda":  # the peak of the program's work, not of the harness's weight draw
        torch.cuda.reset_peak_memory_stats(device)
    done = []
    capture = program.LatentCapture(mods, tokenizer)
    start = time.perf_counter()
    while True:
        first = len(done) * b
        done.append((first, batch(first)))
        end = time.perf_counter()
        if end - start >= seconds:
            break
    window_s = end - start
    capture.close()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    ctx = {"setup_s": setup_s, "setup_marks": marks, "window_s": window_s, "clips": len(done) * b,
           "attempted": len(done) * b, "failed": 0, "memory_peak_bytes": peak}
    if trace:
        ctx["trace"] = _traced_batch(engine, mods, device, lambda: batch(len(done) * b))
    del engine, mods
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ctx["compare"] = check(cfg, mix, seed, table, done, capture, device)
    return ctx


def _traced_batch(engine, mods, device, send) -> dict:
    ranges = tr.Ranges()
    ranges.around(mods.text_encoder, "text")
    ranges.around(mods.unet, "unet")
    ranges.around(mods.vocoder, "vocoder")
    decode = mods.vae.decode

    def traced_decode(z):
        with torch.autograd.profiler.record_function(tr.PREFIX + "decode"):
            return decode(z)

    mods.vae.decode = traced_decode
    try:
        return tr.traced(device, send, program.launch_counts)
    finally:
        ranges.remove()
        mods.vae.decode = decode


def sample(seed: int, batches: int, batch: int, n: int) -> list:
    """``n`` clips of ``batches`` batches, drawn from the seed: ``(batch
    index, row)``. Clip ``k`` lies in the ``k``-th of ``n`` equal spans of
    a batch's rows, and the last is a batch's last row, so every check
    covers both halves of a batch and its last slot."""
    rng = np.random.default_rng([int(seed), 5])
    picks = []
    for k in range(n):
        lo, hi = k * batch // n, max((k + 1) * batch // n, k * batch // n + 1)
        row = batch - 1 if k == n - 1 else int(rng.integers(lo, hi))
        picks.append((int(rng.integers(batches)), row))
    return picks


def reference_waves(cfg, mix, seed: int, table, rows: list, device, kind: str = "fp32"):
    """The plain reference's ``(waveforms, decode inputs, mels)`` of the requests
    ``rows`` (prompt rows of ``table``) of the run seeded ``seed``, in
    arithmetic ``kind``."""
    ids, mask, uids, umask = (torch.as_tensor(x, device=device) for x in table)
    seeds = [inputs.request_seed(seed, r) for r in rows]
    with ops.fp32_mode():
        state = weights.make_state(cfg, seed, device)
        models = pipeline.build(cfg, state, ops.Arith(kind), device)
        del state
        return pipeline.generate(models, cfg, ids[rows], mask[rows], uids, umask, seeds, mix["steps"], mix["guidance"],
                                 mix["seconds"], mix["scheduler"])


def check(cfg, mix, seed, table, done, capture, device) -> dict:
    """The compared numbers over ``check_clips`` clips of the window drawn
    from the seed."""
    picks = sample(seed, len(done), mix["batch"], mix["check_clips"])
    rows = [done[i][0] + r for i, r in picks]
    got = (torch.stack([torch.as_tensor(done[i][1][r]) for i, r in picks]).to(device),
           torch.stack([capture.rows[row] for row in rows]).to(device),
           torch.stack([capture.mels[row] for row in rows]).to(device))
    return numbers(got, reference_waves(cfg, mix, seed, table, rows, device))


def numbers(got: tuple, ref: tuple) -> dict:
    """The compared numbers of generation from ``(waveforms, latents, mels)``
    of the program (or a control) and of the reference: ``latent_rel_l2``
    (text tower, UNet with K1, sampler), ``mel_rel_l2`` (also the VAE
    decode) and ``wave_rel_l2`` (also the vocoder with K2)."""
    wav, lat, mel = got
    ref_wav, ref_lat, ref_mel = ref
    return {"latent_rel_l2": compare.rel_l2(lat.flatten(1), ref_lat.flatten(1)),
            "mel_rel_l2": compare.rel_l2(mel.flatten(1), ref_mel.flatten(1)),
            "wave_rel_l2": compare.rel_l2(wav, ref_wav)}


def control(cfg: dict, mix: dict, seed: int, kind: str, fault, device, seconds: float) -> dict:
    """The compared numbers with the reference in ``kind`` in the program's
    place, on ``check_clips`` requests of the first eight batches drawn from
    the seed as a run draws them."""
    if fault is not None:
        raise ValueError(f"closed_batches plants no fault {fault!r}")
    table = inputs.prompt_table(cfg["text_encoder"], seed, mix["table_rows"], *mix["prompt_tokens"])
    rows = [i * mix["batch"] + r for i, r in sample(seed, 8, mix["batch"], mix["check_clips"])]
    return numbers(reference_waves(cfg, mix, seed, table, rows, device, kind=kind),
                   reference_waves(cfg, mix, seed, table, rows, device))
