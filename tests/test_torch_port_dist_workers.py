"""Multi-process workers of the port's parallelism tests
(tests/test_torch_port_parallel.py, tests/test_torch_port_tp.py); no tests
of its own.

Every worker is a top-level function of this module, which imports torch
and the port but neither jax nor audioldm_tpu: a spawned process imports
only what it unpickles. ``spawn`` starts ``world`` processes that join a
gloo group through a ``file://`` rendezvous in the test's own temporary
directory (no port to collide on when test processes share the machine),
runs ``fn(rank, world, *args)`` in each with one intra-op thread, and
returns each rank's result. It joins under a deadline: a rank still running
when it passes is killed and the test fails, so a hung collective costs
seconds, not the suite.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEADLINE_S = 120.0


def _entry(rank: int, fn, world: int, tmp: str, args: tuple) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv", rank=rank, world_size=world)
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, tmp, *args, deadline: float = DEADLINE_S) -> list:
    """``fn(rank, world, *args)`` in ``world`` processes over gloo; each
    rank's return value, in rank order. Fails the calling test when a rank
    raises or the deadline passes."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    ctx = mp.spawn(_entry, args=(fn, world, tmp, args), nprocs=world, join=False)
    t0 = time.monotonic()
    while not ctx.join(timeout=1.0):
        if time.monotonic() - t0 > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise AssertionError(f"{fn.__name__} at world size {world} did not finish within {deadline:.0f} s")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(world)]


class Tokenizer:
    """tests/test_serve.py's ``DummyTokenizer`` with a hash that every
    process computes alike (``hash(str)`` is salted per process)."""

    def __call__(self, texts, max_length=None):
        n = 6
        ids = np.full((len(texts), n), 1, np.int32)
        mask = np.zeros((len(texts), n), np.int32)
        for i, t in enumerate(texts):
            toks = [0] + [5 + sum(w.encode()) % 40 for w in t.split()][: n - 2] + [2]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def build(cfgs: tuple, sds: dict):
    """Port modules on the CPU from configs ``(unet, vae, text, vocoder)``
    and state dicts by model name."""
    from audioldm_tpu_torch.pipeline import generate as pg

    mods = pg.random_modules(0, *cfgs, device="cpu")
    for name, sd in sds.items():
        getattr(mods, name).load_state_dict(sd, strict=True)
    return mods


def frozen(mods):
    for m in (mods.unet, mods.vae, mods.text_encoder, mods.vocoder):
        m.requires_grad_(False)
    return mods


def adapters_np(lora) -> dict:
    return {f"{p}.{n}": t.detach().numpy().copy() for p, a, b in lora.items() for n, t in (("a", a), ("b", b))}


# -- data parallelism ---------------------------------------------------------


def train_worker(rank, world, cfgs, sds, tensors, lora_cfg, train_cfg, cases):
    """For each ``(batch, draws, accum)`` of ``cases``, one
    ``train_step(mesh=)`` from ``tensors`` on this rank's rows of the global
    batch (the micro axis under accumulation), the draws global."""
    from audioldm_tpu_torch.lora import LoRAAdapters
    from audioldm_tpu_torch.parallel import make_mesh, shard_batch
    from audioldm_tpu_torch.train.trainer import init_train_state, train_step

    mesh = make_mesh(world, device="cpu")
    mods = frozen(build(cfgs, sds))
    out = []
    for batch, draws, accum in cases:
        state = init_train_state(LoRAAdapters(tensors), train_cfg)
        local = shard_batch(mesh, batch, batch_axis=1 if accum > 1 else 0)
        state, m = train_step(state, mods, local, lora_cfg, grad_accum=accum, draws=draws, mesh=mesh)
        out.append({"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(), "lora": adapters_np(state.lora)})
    return out


def distill_worker(rank, world, cfgs, sds, tensors, lora_cfg, train_cfg, batch, uncond, runs):
    """For each ``(w, seed, steps, draws)`` of ``runs``, ``steps``
    ``distill_step(mesh=)``s from ``tensors`` on this rank's rows, the
    draws given whole (``draws``) or made for the global batch from one
    generator seeded ``seed`` on every rank."""
    from audioldm_tpu_torch.lora import LoRAAdapters
    from audioldm_tpu_torch.parallel import make_mesh, shard_batch
    from audioldm_tpu_torch.train.distill import distill_step, init_distill_state

    mesh = make_mesh(world, device="cpu")
    mods = frozen(build(cfgs, sds))
    local = {**shard_batch(mesh, batch), **uncond}
    out = []
    for w, seed, steps, draws in runs:
        state = init_distill_state(LoRAAdapters(tensors), train_cfg)
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        losses = []
        for _ in range(steps):
            state, m = distill_step(state, mods, local, lora_cfg, w=w, generator=gen, draws=draws, mesh=mesh)
            losses.append(m["loss"].item())
        out.append({"losses": losses, "lora": adapters_np(state.lora), "ema": adapters_np(state.ema_lora)})
    return out


def _engine(mesh, cfgs, sds, bank_tensors, lora_cfg, buckets):
    from audioldm_tpu_torch.lora import LoRAAdapters
    from audioldm_tpu_torch.serve import AdapterBank, ServeEngine

    mods = build(cfgs, sds)
    bank = AdapterBank.from_adapters({n: LoRAAdapters(t) for n, t in bank_tensors.items()}, lora_cfg, device="cpu")
    return ServeEngine(mods, Tokenizer(), lora_cfg, bank=bank, dtype=torch.float32, bucket_sizes=buckets,
                       device="cpu", mesh=mesh)


def serve_worker(rank, world, cfgs, sds, bank_tensors, lora_cfg, buckets, calls, new_adapter, requests):
    """``ServeEngine(mesh=)`` generations, the same ``calls`` on every rank
    (each call's waveforms and the engine's route counts, ``"engine"``);
    then the daemon on a fresh engine (``"daemon"``, ``_daemon``)."""
    from audioldm_tpu_torch.parallel import make_mesh

    mesh = make_mesh(world, device="cpu")
    eng = _engine(mesh, cfgs, sds, bank_tensors, lora_cfg, buckets)
    outs = [eng.generate(prompts, adapters=adapters, **kw) for prompts, adapters, kw in calls]
    return {"engine": {"wavs": outs, "batches": dict(eng.batches)},
            "daemon": _daemon(rank, _engine(mesh, cfgs, sds, bank_tensors, lora_cfg, (1, 2, 4)), lora_cfg, new_adapter,
                              requests)}


def _daemon(rank, eng, lora_cfg, new_adapter, requests):
    """The daemon at world size > 1: rank 0 a ``Microbatcher`` (one batch
    of ``requests``, a hot-load of ``new_adapter`` as "c" and a request on
    it), every other rank ``follow``. Rank 0 returns the waveforms, the
    others their call count; both the bank's names."""
    from audioldm_tpu_torch.lora import LoRAAdapters
    from audioldm_tpu_torch.serve import GenParams, Microbatcher
    from audioldm_tpu_torch.serve.daemon import follow

    if rank != 0:
        return {"calls": follow(eng), "names": dict(eng.bank.names)}
    params = GenParams(num_inference_steps=2, audio_length_in_s=0.01, guidance_scale=2.0)
    batcher = Microbatcher(eng, max_batch=len(requests), max_delay_ms=2000.0, base_seed=3, defaults=params)
    try:
        futures = [batcher.submit(p, a, params) for p, a in requests]
        wavs = [f.result(timeout=60) for f in futures]
        refused = ""
        try:
            batcher.submit("a beat", "nope", params)
        except KeyError as e:  # refused on rank 0 before anything reaches the followers
            refused = str(e)
        batcher.load_adapter("c", LoRAAdapters(new_adapter), lora_cfg.r, lora_cfg.lora_alpha)
        on_c = batcher.submit("hip hop beat", "c", params).result(timeout=60)
    finally:
        batcher.close()
    return {"wavs": np.stack(wavs), "on_c": on_c, "refused": refused, "names": dict(eng.bank.names)}


# -- tensor parallelism -------------------------------------------------------


def _count_all_reduces(counter: list):
    real = dist.all_reduce

    def counted(*a, **k):
        counter[0] += 1
        return real(*a, **k)

    dist.all_reduce = counted
    return real


def tp_unet_worker(rank, world, cfg, sd, latents, t, labels):
    """The TP UNet step at tp = world: eps, the all-reduces of one UNet
    call and the number of split blocks."""
    from audioldm_tpu_torch.models.unet import UNet2DConditionModel
    from audioldm_tpu_torch.parallel import make_tp_mesh, make_tp_unet_step, shard_unet_params, split_blocks

    mesh = make_tp_mesh(world, device="cpu")
    unet = UNet2DConditionModel(cfg)
    unet.load_state_dict(sd, strict=True)
    tp_unet = shard_unet_params(mesh, unet)
    count = [0]
    real = _count_all_reduces(count)
    try:
        eps = make_tp_unet_step(cfg, mesh)(tp_unet, torch.from_numpy(latents), torch.from_numpy(t), torch.from_numpy(labels))
    finally:
        dist.all_reduce = real
    return {"eps": eps.numpy(), "all_reduces": count[0], "split_blocks": split_blocks(tp_unet)}


def tp_generate_worker(rank, world, cfgs, sds, prompts, latents, lora_tensors, kw, unet_case):
    """``make_tp_generate_fn`` at tp = world, without and with an adapter;
    then ``tp_unet_worker`` on ``unet_case`` (``"unet"``)."""
    from audioldm_tpu_torch.lora import LoRAAdapters
    from audioldm_tpu_torch.parallel import make_tp_generate_fn, make_tp_mesh, shard_modules

    mesh = make_tp_mesh(world, device="cpu")
    fn = make_tp_generate_fn(shard_modules(mesh, build(cfgs, sds)), mesh, dtype=torch.float32, **kw)
    lat = torch.from_numpy(latents)
    plain = fn(*prompts, latents=lat)
    adapted = fn(*prompts, latents=lat, lora=LoRAAdapters(lora_tensors))
    return {"plain": plain.numpy(), "lora": adapted.numpy(), "unet": tp_unet_worker(rank, world, *unet_case)}


def tp_train_worker(rank, world, dp, tp, cfgs, sds, tensors, lora_cfg, train_cfg, batch, draws):
    """One ``make_tp_train_step`` step on a (dp, tp) mesh from the global
    batch and draws."""
    from audioldm_tpu_torch.lora import LoRAAdapters
    from audioldm_tpu_torch.parallel import make_tp_mesh_2d, make_tp_train_step, shard_modules
    from audioldm_tpu_torch.train.trainer import init_train_state

    mesh = make_tp_mesh_2d(dp, tp, device="cpu")
    mods = shard_modules(mesh, frozen(build(cfgs, sds)))
    state = init_train_state(LoRAAdapters(tensors), train_cfg)
    state, m = make_tp_train_step(mods, lora_cfg, mesh)(state, batch, draws=draws)
    return {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(), "lora": adapters_np(state.lora),
            "step": state.step}


def noop_worker(rank, world, seconds: Optional[float] = None):
    if seconds:
        time.sleep(seconds)
    return rank
