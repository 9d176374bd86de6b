"""Multi-LoRA serving engine (port of audioldm_tpu/serve/engine.py).

BASELINE config 5: batched multi-prompt generation with a per-request
adapter, hot-loaded without touching the base weights.

Design, as in the JAX package:
- ``AdapterBank``: K same-rank adapters stacked slot-wise, one device tensor
  ``[capacity, in, r]`` (A) and one ``[capacity, r, out]`` (B) per adapted
  projection, keyed by the port's module paths (``lora/adapter.py``). Slot 0
  is the zero adapter ("base"). A hot-load is an in-place ``copy_`` into one
  slot, O(slot).
- Rank-r gathered route: a mixed batch gathers each request's (A, B) rows
  into ``[rows, in, r]`` entries that ride the UNet's unmerged adapter path
  (``models/nn.py Attention``), one UNet call for any mix of adapters;
  ``dense_lora_max_dim`` densifies the narrow projections (hybrid route).
- Merged-weight cache: a uniform batch runs on a copy of the UNet with
  ``W += (alpha/r) A B`` merged once, no adapter cost a step.
- Split cost gate: a mixed batch is split into uniform sub-batches on the
  merged cache when their padded sizes cost less than the rank-r batch. The
  gate always runs (the JAX engine's ``split_mixed_adapters`` switch is not
  ported): an engine with one bucket keeps every mixed batch on the rank-r
  route, since k groups then cost k buckets, never under 1.5.

``RANK_R_OVERHEAD`` and the default ``bucket_sizes`` are the JAX package's
TPU numbers, kept so that both packages route the same batches (as
``kernels/flash_attention.py`` keeps the JAX ``_MIN_TOKENS`` for CPU
tensors, while the card routes attention by its own measured
``_CARD_MIN_TOKENS``); ``chip_smoke.py engine`` measures the card's own
rank-r : merged ratio.

Data parallelism (``mesh=``, a ``parallel.Mesh`` with a ``dp`` axis): the
engine is SPMD, every rank calls ``generate``/``flush`` with the same
arguments. A padded bucket that divides the dp size splits into contiguous
rows: every rank draws the whole bucket's init latents (and lcm's in-loop
noise) exactly as at one rank and keeps its rows, runs the UNet, the VAE
and the vocoder (K1, K2) on them, and ``all_gather`` returns the whole
batch on every rank. A bucket that does not divide runs whole on every
rank (the JAX engine's replicated fallback). Under a mesh the mixed-adapter
split is off and mixed batches take the rank-r route, the JAX rule
(``audioldm_tpu/serve/engine.py:584,620``): sub-batches need not divide
the mesh. ``batches`` counts as at one rank, on every rank.

Left out of the port:
- The ``traces`` counter: eager PyTorch compiles nothing per batch key.
  ``ServeEngine.batches`` counts the batches that reached the UNet, by route
  and padded batch size, instead.

Spans and counters (``utils/profiling.py``): ``engine.generate`` (or
``engine.flush``), keyed by the engine's call ordinal, holds an
``engine.prepare`` a launched sub-batch (init latents, tokens, padding; its
route and bucket as attributes), the pipeline's ``gen.*`` spans and
``engine.copy_out``. ``counters`` (always on; the batcher's ``/v1/stats``)
counts merged-cache hits and misses and bank gathers; each also goes to the
span recorder as ``engine.<name>``.

Seeds: a request seeded ``s`` draws its init latents from
``row_generator(s, 0)``, what ``pipeline.generate.generate(seed=s)`` draws
at batch 1, whatever shares its batch. Unseeded rows draw from the batch
key, ``(seed, *folds)`` (``pipeline.generate.key_generator``); ``flush``
folds a monotone engine counter into it, so no two batches share latents.
"""

from __future__ import annotations

import copy
import dataclasses
from collections import Counter
from typing import Optional, Sequence

import numpy as np
import torch

from audioldm_tpu_torch import resolve_device
from audioldm_tpu_torch.config import LoRAConfig
from audioldm_tpu_torch.lora import LoRAAdapters, compose_adapters, merge_lora
from audioldm_tpu_torch.parallel.mesh import Mesh, gather_rows, local_rows
from audioldm_tpu_torch.pipeline.generate import AudioLDMModules, generate, key_generator, latent_shape, row_generator
from audioldm_tpu_torch.utils import profiling
from audioldm_tpu_torch.utils.profiling import span


def _as_dict(adapter) -> dict:
    """``{path: (a, b)}`` of a ``LoRAAdapters`` or of such a mapping."""
    if isinstance(adapter, LoRAAdapters):
        return {p: (a, b) for p, a, b in adapter.items()}
    return dict(adapter)


class AdapterBank:
    """Named bank of same-rank adapters stacked slot-wise on one device.

    Slots are preallocated: every tensor carries a leading ``capacity`` dim
    and ``add`` writes into a free slot in place instead of re-stacking the
    bank. When full, capacity doubles (one concatenation) up to
    ``max_capacity``; beyond that ``add`` raises and the caller must
    ``remove`` (or evict: the daemon's LRU policy) first. ``remove`` zeroes
    the slot (a stale index gathers base weights, never deleted ones) and
    frees it for reuse. ``template`` (a ``LoRAAdapters`` or ``{path: (a,
    b)}``) fixes the paths, shapes and dtype."""

    def __init__(self, template, rank: int, capacity: int = 8, max_capacity: Optional[int] = None, device="cuda"):
        self.device = resolve_device(device)
        self.names: dict[str, int] = {"base": 0}
        self.rank = rank
        self.max_capacity = max_capacity
        self._free: list[int] = []
        self._next = 1  # high-water slot (slot 0 = the zero/base adapter)
        cap = max(2, int(capacity))
        if max_capacity is not None:
            cap = min(cap, max(2, int(max_capacity)))
        self.a: dict[str, torch.Tensor] = {}
        self.b: dict[str, torch.Tensor] = {}
        template = _as_dict(template)
        if not template:
            raise ValueError("an AdapterBank needs a template with at least one adapted projection")
        for path, (a, b) in template.items():
            a, b = torch.as_tensor(a), torch.as_tensor(b)
            self.a[path] = torch.zeros((cap, *a.shape), dtype=a.dtype, device=self.device)
            self.b[path] = torch.zeros((cap, *b.shape), dtype=b.dtype, device=self.device)

    @property
    def capacity(self) -> int:
        return next(iter(self.a.values())).shape[0]

    @property
    def full(self) -> bool:
        """No slot free and no growth headroom left."""
        if self._free or self._next < self.capacity:
            return False
        return self.max_capacity is not None and self.capacity >= self.max_capacity

    def __len__(self) -> int:
        return len(self.names)

    @classmethod
    def from_adapters(cls, adapters: dict, lora_cfg: LoRAConfig, capacity: int = 8,
                      max_capacity: Optional[int] = None, device="cuda") -> "AdapterBank":
        first = next(iter(adapters.values()))
        bank = cls(first, lora_cfg.r, capacity=max(capacity, len(adapters) + 1), max_capacity=max_capacity,
                   device=device)
        for name, adapter in adapters.items():
            bank.add(name, adapter)
        return bank

    @classmethod
    def from_stacked(cls, stacked: dict, names: dict, rank: int, max_capacity: Optional[int] = None,
                     device="cuda") -> "AdapterBank":
        """A bank whose slots are ``stacked`` (``{path: (a [capacity, in,
        r], b [capacity, r, out])}``), named by ``names`` (name -> slot, base
        at 0), slot for slot. The slots below the highest named one that no
        name holds are free, reused highest first."""
        capacity = next(iter(stacked.values()))[0].shape[0]
        bank = cls({p: (a[0], b[0]) for p, (a, b) in stacked.items()}, rank, capacity=capacity,
                   max_capacity=max_capacity, device=device)
        for p, (a, b) in stacked.items():
            bank.a[p].copy_(a)
            bank.b[p].copy_(b)
        bank.names = {str(n): int(i) for n, i in names.items()}
        bank._next = max(bank.names.values()) + 1
        bank._free = [i for i in range(1, bank._next) if i not in set(bank.names.values())]
        return bank

    def add(self, name: str, adapter) -> int:
        if name == "base":
            raise ValueError("'base' is the reserved zero-adapter slot")
        tensors = self._conform(adapter)  # before any state changes: all or nothing
        if name in self.names:  # replace in place
            idx = self.names[name]
        elif self._free:
            idx = self._free.pop()
        else:
            if self._next >= self.capacity:
                if self.full:
                    raise ValueError(
                        f"AdapterBank is full ({len(self.names) - 1} adapters, "
                        f"max_capacity={self.max_capacity}); remove one first"
                    )
                grown = self.capacity * 2
                if self.max_capacity is not None:
                    grown = min(grown, self.max_capacity)
                for bank in (self.a, self.b):
                    for p, t in bank.items():
                        bank[p] = torch.cat([t, t.new_zeros((grown - t.shape[0], *t.shape[1:]))])
            idx = self._next
            self._next += 1
        self._write(idx, tensors)
        self.names[name] = idx
        return idx

    def remove(self, name: str) -> None:
        """Free ``name``'s slot (zeroed, reused by the next ``add``)."""
        if name == "base":
            raise ValueError("cannot remove the reserved base slot")
        if name not in self.names:
            raise KeyError(f"unknown adapter {name!r}; bank has {sorted(self.names)}")
        idx = self.names.pop(name)
        for bank in (self.a, self.b):
            for t in bank.values():
                t[idx].zero_()
        self._free.append(idx)

    def _conform(self, adapter) -> dict:
        """``adapter`` checked against the bank's template (the same paths,
        the same shapes) and moved to the bank's device and dtype. Raises
        ValueError on any mismatch, before a single slot write."""
        items = _as_dict(adapter)
        if set(items) != set(self.a):
            missing, extra = sorted(set(self.a) - set(items)), sorted(set(items) - set(self.a))
            raise ValueError(f"adapter rejected, bank unchanged: its paths differ from the bank template "
                             f"(missing {missing[:3]}, extra {extra[:3]})")
        out = {}
        for path, entry in items.items():
            if len(entry) != 2:
                raise ValueError(f"adapter rejected, bank unchanged: {path} needs (a, b)")
            pair = []
            for x, bank in zip(entry, (self.a[path], self.b[path])):
                x = torch.as_tensor(x)
                if tuple(x.shape) != tuple(bank.shape[1:]):
                    raise ValueError(
                        f"adapter rejected, bank unchanged: adapter leaf shape {tuple(x.shape)} != bank template "
                        f"{tuple(bank.shape[1:])} (same-rank, same-geometry adapters only)"
                    )
                pair.append(x.detach().to(device=self.device, dtype=bank.dtype))
            out[path] = tuple(pair)
        return out

    def _write(self, idx: int, tensors: dict) -> None:
        for path, (a, b) in tensors.items():
            self.a[path][idx].copy_(a)
            self.b[path][idx].copy_(b)

    def adapter(self, name: str) -> LoRAAdapters:
        """The adapter in ``name``'s slot, as fp32 ``LoRAAdapters``."""
        i = self.names[name]
        return LoRAAdapters({p: (self.a[p][i], self.b[p][i]) for p in self.a})

    def indices(self, names: Sequence[str]) -> torch.Tensor:
        unknown = sorted(set(names) - set(self.names))
        if unknown:
            raise KeyError(f"unknown adapter(s) {unknown}; bank has {sorted(self.names)}")
        return torch.tensor([self.names[n] for n in names], dtype=torch.long, device=self.device)

    def gather(self, idx: torch.Tensor, cfg_batch: int = 1) -> dict:
        """Per-request entries ``{path: (A [B*cfg_batch, in, r], B [B*cfg_batch,
        r, out])}``, tiled so that the CFG-folded UNet batch (uncond rows
        stacked before cond rows) sees the same adapter on both halves."""
        tiled = idx.repeat(cfg_batch)
        return {p: (self.a[p][tiled], self.b[p][tiled]) for p in self.a}

    def gather_dense(self, idx: torch.Tensor, cfg_batch: int = 1, dtype=torch.bfloat16,
                     max_dense_dim: Optional[int] = None) -> dict:
        """Gather and densify: a per-request ``AB [rows, in, out]`` per
        projection, computed once a batch (in fp32, cast to ``dtype``), so that
        a step applies one batched matmul instead of two rank-r ones.
        ``max_dense_dim`` selects a hybrid: only projections whose in and out
        dims are at most the bound are densified; the wider keep rank-r."""
        out = {}
        for path, (a, b) in self.gather(idx, cfg_batch).items():
            if max_dense_dim is not None and (a.shape[1] > max_dense_dim or b.shape[2] > max_dense_dim):
                out[path] = (a, b)
            else:
                out[path] = torch.matmul(a.float(), b.float()).to(dtype)
        return out


def _cast(entry, dtype):
    if isinstance(entry, torch.Tensor):
        return entry.to(dtype)
    return tuple(x.to(dtype) for x in entry)


class ServeEngine:
    # the JAX package's rank-r-gathered : merged-route cost ratio a clip on
    # a TPU (1.16 vs 0.78 s/clip), used by the mixed-batch split gate
    RANK_R_OVERHEAD = 1.5

    def __init__(
        self,
        modules: AudioLDMModules,
        tokenizer,
        lora_cfg: LoRAConfig = LoRAConfig(),
        bank: Optional[AdapterBank] = None,
        dtype: torch.dtype = torch.bfloat16,
        negative_prompt: str = "",
        bucket_sizes: Sequence[int] = (1, 2, 4, 8, 16),
        dense_lora_max_dim: Optional[int] = None,
        device="cuda",
        mesh: Optional[Mesh] = None,
    ):
        """Moves ``modules`` to ``device`` (the mesh's under ``mesh``) and
        casts its UNet and VAE to ``dtype`` in place
        (``AudioLDMModules.to``)."""
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.modules = modules.to(self.device, dtype)
        self.tokenizer = tokenizer
        self.lora_cfg = lora_cfg
        self.bank = bank
        self.dtype = dtype
        self.negative_prompt = negative_prompt
        # hybrid mixed-adapter serving: densify per-request AB only for
        # projections up to this dim (see AdapterBank.gather_dense)
        self.dense_lora_max_dim = dense_lora_max_dim
        self.bucket_sizes = tuple(sorted(bucket_sizes))
        # composed (weighted multi-LoRA) adapters: name -> component weights,
        # served from the merged cache only (their rank is the sum of the
        # components' ranks; the bank stacks one rank)
        self.composed: dict[str, dict[str, float]] = {}
        self._merged_cache: dict[str, AudioLDMModules] = {}
        self._queue: list[tuple[str, Optional[str]]] = []
        self._rng_counter = 0  # monotone across flushes: no latent collisions
        self.batches: Counter = Counter()  # (route, padded batch) -> batches that reached the UNet
        # merged_hits, merged_misses, bank_gathers (module docstring)
        self.counters: Counter = Counter()
        self._ordinal = 0  # generate and flush calls so far: the key of their spans

    def _count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n
        profiling.count("engine." + name, n)

    def _bucket(self, b: int) -> int:
        """Smallest configured bucket >= b (batches are padded to it)."""
        for s in self.bucket_sizes:
            if s >= b:
                return s
        return self.bucket_sizes[-1]

    def warmup(
        self,
        num_inference_steps: int = 50,
        audio_length_in_s: float = 10.24,
        guidance_scale: float = 2.5,
        scheduler: str = "ddim",
    ) -> None:
        """Drive one throwaway negative-prompt batch through the normal
        dispatch of every bucket, one after the other, before real traffic
        arrives, so that the first requests find cuDNN's algorithm choices
        and the allocator's pool made for their shapes. The JAX package runs
        one thread a bucket to overlap its compiles; eager PyTorch compiles
        nothing, and one card gains nothing from threads. Its ``buckets=``
        and ``adapter=`` are not ported: no caller sets them."""
        for b in self.bucket_sizes:
            parts = self._generate_async(
                [self.negative_prompt] * b, None, num_inference_steps, audio_length_in_s, guidance_scale, scheduler, (0,),
            )
            self._assemble(parts, b)

    def has_adapter(self, name: Optional[str]) -> bool:
        """True if ``name`` can be served: base traffic, a bank adapter, or
        a composed adapter."""
        if name in (None, "base"):
            return True
        return (self.bank is not None and name in self.bank.names) or name in self.composed

    def _merged(self, adapters: LoRAAdapters, cfg: LoRAConfig) -> AudioLDMModules:
        """The modules with ``adapters`` merged into a copy of the UNet:
        ``merge_lora`` works in place, and the base UNet is shared."""
        return dataclasses.replace(self.modules, unet=merge_lora(copy.deepcopy(self.modules.unet), adapters, cfg))

    def add_composed(self, name: str, weights: dict[str, float]) -> None:
        """Register a weighted composition of bank adapters under ``name``
        (delta = sum_i w_i * scale * A_i B_i, exact: ``compose_adapters``),
        merged at once into a UNet copy of the merged cache."""
        self.check_composed(name, weights)
        parts = [(self.bank.adapter(comp), self.lora_cfg, float(w)) for comp, w in weights.items()]
        self._merged_cache[name] = self._merged(*compose_adapters(parts))
        self.composed[name] = dict(weights)

    def check_composed(self, name: str, weights: dict[str, float]) -> None:
        """``add_composed``'s refusals, without the work."""
        if self.bank is None:
            raise ValueError("add_composed needs an AdapterBank with the component adapters")
        if name in self.bank.names:
            raise ValueError(
                f"composed name {name!r} collides with a bank adapter: it would hijack that adapter's "
                "merged-cache route while rank-r batches still gather the bank weights"
            )
        unknown = sorted((set(weights) - set(self.bank.names)) | ({"base"} & set(weights)))
        if unknown:
            raise KeyError(f"cannot compose from {unknown}; bank has "
                           f"{sorted(n for n in self.bank.names if n != 'base')}")

    def refresh_composed(self, component: str) -> list[str]:
        """Recompute every composed adapter that references ``component``
        (after hot-replacing that component in the bank, the merged
        composition would otherwise keep serving the old weights). Returns
        the refreshed names."""
        stale = [n for n, w in self.composed.items() if component in w]
        for n in stale:
            weights = self.composed.pop(n)
            self._merged_cache.pop(n, None)
            self.add_composed(n, weights)
        return stale

    def remove_adapter(self, name: str) -> None:
        """Unload an adapter: a composed name drops its registration and
        merged copy; a bank name frees its slot (zeroed, reused by the next
        hot-load). Removing a bank adapter that a composition still uses is
        refused: the composition would keep serving its merged copy."""
        self.check_remove(name)
        if name in self.composed:
            del self.composed[name]
            self._merged_cache.pop(name, None)
            return
        self.bank.remove(name)
        self._merged_cache.pop(name, None)

    def check_remove(self, name: str) -> None:
        """``remove_adapter``'s refusals, without the work."""
        if name in self.composed:
            return
        if self.bank is None or name not in self.bank.names:
            raise KeyError(
                f"unknown adapter {name!r}; loaded: {sorted(self.bank.names) if self.bank else ['base']} "
                f"composed: {sorted(self.composed)}"
            )
        used_by = sorted(n for n, w in self.composed.items() if name in w)
        if used_by:
            raise ValueError(f"adapter {name!r} is a component of composed adapter(s) {used_by}; remove those first")

    def load_adapter(self, name: str, adapter, rank: int, alpha: Optional[float] = None) -> None:
        """Hot-load (or replace) ``name`` in the bank, making the bank with
        the first load; a replaced name's merged copy and the compositions
        that use it are rebuilt. The daemon checks names and ranks first
        (``Microbatcher.load_adapter``)."""
        if self.bank is None:
            self.lora_cfg = LoRAConfig(r=rank, lora_alpha=float(alpha if alpha is not None else rank))
            self.bank = AdapterBank.from_adapters({name: adapter}, self.lora_cfg, device=self.device)
        else:
            self.bank.add(name, adapter)
        self._merged_cache.pop(name, None)
        self.refresh_composed(name)  # compositions of the old weights would go on serving them

    def check_adapters(self, adapters: Optional[Sequence[Optional[str]]]) -> None:
        """Raise the ValueError that ``generate`` would raise for this list
        of adapters before any work (unknown names; under a mesh, a composed
        adapter in a mixed batch, which takes the rank-r route), so that a
        daemon under data parallelism refuses a request before it reaches
        the other ranks."""
        if adapters is None:
            return
        self._refuse_unknown(adapters)
        if self.mesh is None or self.bank is None:
            return
        step = self.bucket_sizes[-1]
        for i in range(0, len(adapters), step):
            names = {a or "base" for a in adapters[i : i + step]}
            if len(names) > 1:
                self._refuse_composed_rank_r(names)

    def _refuse_unknown(self, adapters: Sequence[Optional[str]]) -> None:
        missing = sorted({str(a) for a in adapters if not self.has_adapter(a)})
        if missing:
            have = (
                "no AdapterBank is configured" if self.bank is None and not self.composed
                else f"loaded: bank={sorted(self.bank.names) if self.bank else []} composed={sorted(self.composed)}"
            )
            raise ValueError(f"unknown adapter(s) {missing}: serving would silently fall back to base weights ({have})")

    def _refuse_composed_rank_r(self, names) -> None:
        in_bank = [n for n in set(names) if n in self.composed and n not in self.bank.names]
        if in_bank:
            raise ValueError(
                f"composed adapter(s) {sorted(in_bank)} cannot ride the rank-r gathered path (their rank is "
                "the sum of component ranks; the bank stacks one fixed rank): serve them in uniform batches "
                "or with buckets fine enough for the split gate to serve each adapter on its own"
            )

    def _tokenize(self, prompts: Sequence[str], negative_prompt: str):
        tok = self.tokenizer(list(prompts))
        u = self.tokenizer([negative_prompt])
        return tok["input_ids"], tok["attention_mask"], u["input_ids"], u["attention_mask"]

    # -- public API -----------------------------------------------------------
    def generate(
        self,
        prompts: Sequence[str],
        adapters: Optional[Sequence[Optional[str]]] = None,
        num_inference_steps: int = 50,
        audio_length_in_s: float = 10.0,
        guidance_scale: float = 2.5,
        seed: int = 0,
        scheduler: str = "ddim",
        rng_key: Optional[tuple] = None,
        negative_prompt: Optional[str] = None,
        window_seconds: Optional[float] = None,
        window_overlap: float = 0.5,
        seeds: Optional[Sequence[Optional[int]]] = None,
        guidance_interval: Optional[tuple[float, float]] = None,
    ) -> np.ndarray:
        """Batched generation; ``adapters[i]`` selects the LoRA for prompt i
        (None or "base" = the base model, a bank name, or a composed name).
        ``negative_prompt`` overrides the engine's for this batch (one uncond
        row a batch). Returns ``[B, samples]`` float32 on the host.

        ``seeds[i]`` (optional, a request's own): row i draws its init
        latents from ``row_generator(seeds[i], 0)``, whatever shares the
        batch. That holds exactly for samplers without in-loop noise (ddim
        at eta 0, the serving default, and dpm++); lcm draws its in-loop
        noise from the batch key, so a seeded lcm request needs a batch of
        its own (the daemon serves it alone). ``rng_key`` (a tuple of ints,
        the batch key) replaces ``(seed,)``.

        The batch is padded to the next bucket; a uniform-adapter batch runs
        on the merged-weight cache, a mixed one is split into uniform
        sub-batches on it or runs the rank-r route (``_generate_async``)."""
        if len(prompts) == 0:
            return np.zeros((0, 0), np.float32)
        if seeds is not None and len(seeds) != len(prompts):
            raise ValueError(f"seeds has {len(seeds)} entries for {len(prompts)} prompts")
        self._ordinal += 1
        with span("engine.generate", key=self._ordinal, rows=len(prompts)):
            parts = self._generate_async(
                prompts, adapters, num_inference_steps, audio_length_in_s, guidance_scale, scheduler,
                (seed,) if rng_key is None else tuple(rng_key), negative_prompt=negative_prompt,
                window=None if window_seconds is None else (window_seconds, window_overlap),
                seeds=seeds, guidance_interval=guidance_interval,
            )
            return self._assemble(parts, len(prompts))

    @staticmethod
    def _assemble(parts, b: int) -> np.ndarray:
        """Copy launched batches to the host and scatter their rows back to
        request order. ``parts``: list of (device waveforms, row indices)."""
        out = None
        with span("engine.copy_out"):
            for wav, rows in parts:
                host = wav.float().cpu().numpy()
                if out is None:
                    out = np.empty((b,) + host.shape[1:], host.dtype)
                out[np.asarray(rows)] = host[: len(rows)]
        return out

    def _generate_async(
        self,
        prompts: Sequence[str],
        adapters: Optional[Sequence[Optional[str]]],
        num_inference_steps: int,
        audio_length_in_s: float,
        guidance_scale: float,
        scheduler: str,
        key: tuple,
        negative_prompt: Optional[str] = None,
        window: Optional[tuple[float, float]] = None,
        seeds: Optional[Sequence[Optional[int]]] = None,
        guidance_interval: Optional[tuple[float, float]] = None,
    ) -> list:
        """Launch the batch without copying it to the host: returns a list of
        (device waveforms, row indices) whose union covers the batch.
        ``generate`` and ``flush`` copy through ``_assemble``; ``flush``
        launches every chunk before the first copy.

        Routing: a mixed-adapter batch is split into per-adapter uniform
        sub-batches, each on the merged-weight cache, when the bucket sizes
        make that cheaper (the cost gate below); otherwise it runs the rank-r
        gathered route."""
        b = len(prompts)
        neg = self.negative_prompt if negative_prompt is None else negative_prompt
        if adapters is not None:
            self._refuse_unknown(adapters)
        common = dict(negative_prompt=neg, window=window, guidance_interval=guidance_interval)
        max_bucket = self.bucket_sizes[-1]
        if b > max_bucket:
            # oversized batches chunk to the largest bucket
            parts = []
            for i in range(0, b, max_bucket):
                sub = self._generate_async(
                    list(prompts[i : i + max_bucket]),
                    None if adapters is None else list(adapters[i : i + max_bucket]),
                    num_inference_steps, audio_length_in_s, guidance_scale, scheduler, key + (i,),
                    seeds=None if seeds is None else list(seeds[i : i + max_bucket]), **common,
                )
                parts.extend((wav, [i + r for r in rows]) for wav, rows in sub)
            return parts

        names = None if adapters is None else [a or "base" for a in adapters]
        mixed = names is not None and len(set(names)) > 1 and self.bank is not None
        mixed_split = False
        if mixed and self.mesh is None:  # under a mesh sub-batches need not divide it: rank-r
            groups: dict[str, list[int]] = {}
            for i, n in enumerate(names):
                groups.setdefault(n, []).append(i)
            # cost gate: serving time taken as proportional to the padded
            # batch, the rank-r route as RANK_R_OVERHEAD times the merged one
            # a row. Splitting pays sum(bucket(|group|)), rank-r pays
            # bucket(b) * RANK_R_OVERHEAD: fine buckets (1, 2, 4, ...) split
            # (groups 2+1+1 -> 4 <= 6), coarse ones (only 4) keep rank-r.
            split_cost = sum(self._bucket(len(r)) for r in groups.values())
            mixed_split = split_cost <= self._bucket(b) * self.RANK_R_OVERHEAD
        if mixed_split:
            # per-adapter uniform sub-batches, submission order kept in each;
            # the key folds on the group ordinal
            parts = []
            for g, (name, rows) in enumerate(sorted(groups.items())):
                sub = self._generate_async(
                    [prompts[i] for i in rows], [name] * len(rows), num_inference_steps, audio_length_in_s,
                    guidance_scale, scheduler, key + (g,), seeds=None if seeds is None else [seeds[i] for i in rows],
                    **common,
                )
                parts.extend((wav, [rows[r] for r in sub_rows]) for wav, sub_rows in sub)
            return parts

        bucket = self._bucket(b)
        uniform = names is not None and len(set(names)) == 1 and names[0] != "base" and self.bank is not None
        if names is None or self.bank is None or all(n == "base" for n in names) or uniform:
            route = "merged" if uniform else "base"
        else:
            route = "rank_r"
        with span("engine.prepare", route=route, bucket=bucket):
            if bucket > b:
                prompts = list(prompts) + [neg] * (bucket - b)
                if names is not None:
                    # pad rows are cut from the output, so their adapter is
                    # arbitrary: the first request's keeps a uniform batch uniform
                    names = list(names) + [names[0]] * (bucket - b)
            shape = latent_shape(self.modules, 1, audio_length_in_s)[1:]
            gens = [row_generator(seeds[i], 0) if seeds is not None and i < len(seeds) and seeds[i] is not None
                    else key_generator(key, i) for i in range(bucket)]
            latents = torch.stack([torch.randn(shape, generator=g) for g in gens])
            tokens = self._tokenize(prompts, neg)
            rows = list(range(b))
            # data parallelism: this rank's rows of a bucket that divides the mesh
            split = self.mesh is not None and bucket % self.mesh.axis_size("dp") == 0
            draws = None
            if split:
                if scheduler == "lcm":  # the in-loop noise of the whole bucket, as one rank draws it, then its rows
                    loop = key_generator(key)
                    draws = {"step_noise": [local_rows(self.mesh, torch.randn(latents.shape, generator=loop))
                                            for _ in range(num_inference_steps - 1)]}
                latents = local_rows(self.mesh, latents)
                tokens = (local_rows(self.mesh, tokens[0]), local_rows(self.mesh, tokens[1]), *tokens[2:])
        run = dict(
            num_inference_steps=num_inference_steps, audio_length_in_s=audio_length_in_s,
            guidance_scale=guidance_scale, dtype=self.dtype, latents=latents, device=self.device,
            scheduler=scheduler, guidance_interval=guidance_interval, generator=key_generator(key),
            window_seconds=None if window is None else window[0], window_overlap=0.5 if window is None else window[1],
            draws=draws,
        )

        def launch(mods, **kw):
            wav = generate(mods, *tokens, **run, **kw)
            return [(gather_rows(self.mesh, wav) if split else wav, rows)]

        if route != "rank_r":
            mods = self.merged_modules(names[0]) if uniform else self.modules
            self.batches[(route, bucket)] += 1
            return launch(mods)

        # rank-r gathered route
        self._refuse_composed_rank_r(names)
        idx = self.bank.indices(names)
        if split:
            idx = local_rows(self.mesh, idx)
        # the CFG factor follows denoise's rule: lcm runs the UNet at batch B
        cfg_batch = 2 if guidance_scale != 1.0 and scheduler != "lcm" else 1
        if self.dense_lora_max_dim is not None:
            lora = self.bank.gather_dense(idx, cfg_batch, self.dtype, self.dense_lora_max_dim)
        else:
            lora = self.bank.gather(idx, cfg_batch)
        self._count("bank_gathers")
        # cast once a batch; the UNet's casts of each step are then no-ops
        lora = {p: _cast(e, self.dtype) for p, e in lora.items()}
        self.batches[("rank_r", bucket)] += 1
        return launch(self.modules, lora=lora, lora_scale=self.lora_cfg.scale)

    def submit(self, prompt: str, adapter: Optional[str] = None) -> int:
        """Queue a request for ``flush``; returns its ticket."""
        self._queue.append((prompt, adapter))
        return len(self._queue) - 1

    def flush(
        self,
        num_inference_steps: int = 50,
        audio_length_in_s: float = 10.0,
        guidance_scale: float = 2.5,
        seed: int = 0,
        max_batch: Optional[int] = None,
        group_by_adapter: bool = True,
    ) -> np.ndarray:
        """Run every queued request (in ``max_batch`` chunks) and return the
        waveforms in submission order.

        ``group_by_adapter`` stable-sorts the queue by adapter before
        chunking, so that chunks tend to be adapter-uniform and run on the
        merged-weight cache. Every chunk is launched before the first is
        copied to the host, so the copies overlap the next chunk's work on
        the card; the output equals the chunk-by-chunk one."""
        queue, self._queue = self._queue, []
        if not queue:
            return np.zeros((0, 0), np.float32)
        order = list(range(len(queue)))
        if group_by_adapter:
            order.sort(key=lambda i: queue[i][1] or "base")
        chunk = max_batch or len(queue)
        launched = []
        self._ordinal += 1
        with span("engine.flush", key=self._ordinal, rows=len(queue)):
            for i in range(0, len(order), chunk):
                rows = order[i : i + chunk]
                # a chunk's key folds a monotone engine counter: two same-size
                # chunks in different flushes never share latents
                self._rng_counter += 1
                parts = self._generate_async(
                    [queue[j][0] for j in rows], [queue[j][1] for j in rows], num_inference_steps, audio_length_in_s,
                    guidance_scale, "ddim", (seed, self._rng_counter),
                )
                launched.append((parts, rows))
            out = None
            for parts, rows in launched:
                host = self._assemble(parts, len(rows))
                if out is None:
                    out = np.empty((len(queue),) + host.shape[1:], host.dtype)
                out[np.asarray(rows)] = host
        return out

    def merged_modules(self, adapter_name: str) -> AudioLDMModules:
        """Merged-weight cache: the modules with the adapter merged into a
        UNet copy (W += (alpha/r) A B once), for a uniform batch."""
        if adapter_name in self._merged_cache:
            self._count("merged_hits")
        else:
            if self.bank is None or adapter_name not in self.bank.names:
                raise KeyError(f"unknown adapter {adapter_name!r}; bank has "
                               f"{sorted(self.bank.names) if self.bank else []}")
            self._count("merged_misses")
            self._merged_cache[adapter_name] = self._merged(self.bank.adapter(adapter_name), self.lora_cfg)
        return self._merged_cache[adapter_name]
