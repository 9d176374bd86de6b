"""LoRA fine-tuning steps through ``Trainer.fit``: batches of ``batch``
log-mels ``[batch, 1, frames, bins]`` and prompt token rows, made on the
device from the seed, a pool of ``pool`` distinct batches fed in turn.

Mix parameters: ``batch``, ``frames``, ``pool``, ``prompt_tokens``,
``adapter_b_std`` (the adapters' B, an adapter some steps into training;
A follows peft's ``gaussian`` rule), ``check_steps`` (the first steps, which
the reference follows).

Set-up builds one ``Trainer`` and its state and drives them through the
first ``check_steps`` steps with the window's own call and feed (their
batches all differ); those steps warm every shape. The window is one
``Trainer.fit`` call over the same feed. Once ``--seconds`` have passed the
feed yields one more batch, the window's closing step, and then none; it
keeps the program's state (adapters, AdamW moments, update count, draw
generator) just before that step, and the reference takes the same step
from it. The window ends after the closing step's work is done, so it
holds whole steps. A traced run profiles three more steps after the window."""

from __future__ import annotations

import gc
import shutil
import tempfile
import time

import torch

from portbench import compare, inputs, program, weights
from portbench import trace as tr
from portbench.reference import models as ref_models
from portbench.reference import ops, pipeline
from audioldm_tpu_torch.lora.adapter import LoRAAdapters, iter_lora_paths
from audioldm_tpu_torch.train.trainer import Trainer


class Feed:
    """The batches of the pool in turn. Once ``stop_at`` (host clock) has
    passed it yields one more, calling ``on_close(index in the pool)``
    first, and then nothing, which ends ``Trainer.fit``."""

    def __init__(self, pool: list):
        self.pool, self.i, self.stop_at, self.on_close = pool, 0, None, None

    def __iter__(self):
        return self

    def __next__(self):
        if self.stop_at is not None and time.perf_counter() >= self.stop_at:
            if self.on_close is None:
                raise StopIteration
            self.on_close(self.i % len(self.pool))
            self.on_close = None
        batch = self.pool[self.i % len(self.pool)]
        self.i += 1
        return batch


def make_inputs(cfg: dict, mix: dict, seed: int, device) -> tuple[list, dict]:
    """The pool of batches and the initial adapters ``{path: (A, B)}``."""
    n = mix["pool"] * mix["batch"]
    ids, mask, _, _ = inputs.prompt_table(cfg["text_encoder"], seed, n, *mix["prompt_tokens"])
    ids, mask = torch.as_tensor(ids, device=device), torch.as_tensor(mask, device=device)
    mels = inputs.mel_batches(seed, mix["pool"], mix["batch"], mix["frames"], cfg["vocoder"]["model_in_dim"], device)
    b = mix["batch"]
    pool = [{"log_mel_spec": m, "input_ids": ids[i * b : (i + 1) * b], "attention_mask": mask[i * b : (i + 1) * b]}
            for i, m in enumerate(mels)]
    with torch.device("meta"):
        unet = ref_models.UNet(cfg["unet"])
    paths = inputs.lora_paths(unet, cfg["lora"]["target_modules"])
    lora = inputs.adapters(paths, cfg["lora"]["r"], mix["adapter_b_std"], seed, device)
    return pool, lora


def _draw_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) + 5)


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: int, device: torch.device, t0: float) -> dict:
    marks = [("imports", time.perf_counter() - t0)]
    program.build_kernels(device)
    marks.append(("kernels", time.perf_counter() - t0))
    state_w = weights.make_state(cfg, seed, device, names=("unet", "vae", "text_encoder", "vocoder"))
    mods = program.modules(cfg, state_w, device)
    del state_w
    marks.append(("weights and models", time.perf_counter() - t0))
    pool, lora0 = make_inputs(cfg, mix, seed, device)
    dtype = torch.bfloat16 if cfg["train"]["mixed_precision"] == "bfloat16" else torch.float32
    outdir = tempfile.mkdtemp(prefix="portbench-train-")
    if device.type == "cuda":  # the peak of the program's work, not of the harness's weight draw
        torch.cuda.reset_peak_memory_stats(device)
    trainer = Trainer(mods, program.lora_config(cfg), program.train_config(cfg), outdir, dtype=dtype, device=device)
    paths = {p for p, _ in iter_lora_paths(mods.unet, cfg["lora"]["target_modules"])}
    if paths != set(lora0):
        raise RuntimeError(f"adapter paths differ from the program's: {sorted(paths ^ set(lora0))[:4]}")
    state = trainer.init_state(LoRAAdapters(lora0))
    leaves, opt = _leaves(state.lora), state.optimizer.adamw  # the same objects all run: fit steps them in place
    before = _clone(leaves)
    gen = _draw_generator(seed, device)
    feed = Feed(pool)
    losses, grad1 = [], None
    b1 = cfg["train"]["betas"][0]
    for step in range(1, mix["check_steps"] + 1):
        state, m = trainer.fit(state, feed, generator=gen, max_steps=step)
        losses.append(float(m["loss"]))
        if step == 1:  # the gradient as the optimizer got it: its first moment over (1 - beta1)
            grad1 = {k: v / (1.0 - b1) for k, (v, _) in _moments(opt, leaves).items()}
    after = _clone(leaves)
    program.sync(device)
    setup_s = time.perf_counter() - t0
    marks.append(("first steps", setup_s))

    steps0, i0, closing = state.step, feed.i, {}

    def on_close(index: int) -> None:  # the state before the closing step, in stream order
        closing.update(lora=_clone(leaves), moments=_moments(opt, leaves), count=steps0 + feed.i - i0, batch=index,
                       gen_state=gen.get_state())

    feed.on_close = on_close
    start = time.perf_counter()
    feed.stop_at = start + seconds
    state, _ = trainer.fit(state, feed, generator=gen, max_steps=steps0 + 10**9)
    program.sync(device)
    window_s = time.perf_counter() - start
    steps = state.step - steps0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    last_grad = {k: (v - b1 * closing["moments"][k][0]) / (1.0 - b1) for k, (v, _) in _moments(opt, leaves).items()}
    got = {"losses": losses, "grad1": grad1, "change": {k: after[k] - before[k] for k in after},
           "last": {"grad": last_grad, "change": {k: x.detach() - closing["lora"][k] for k, x in leaves.items()}}}
    ctx = {"setup_s": setup_s, "setup_marks": marks, "window_s": window_s, "samples": steps * mix["batch"], "steps": steps,
           "attempted": steps * mix["batch"], "failed": 0, "memory_peak_bytes": peak}
    if trace:
        ctx["trace"] = _traced_steps(trainer, state, feed, gen, device)
    del trainer, state, mods, feed, leaves, opt
    shutil.rmtree(outdir, ignore_errors=True)  # no checkpoint falls in the run: it stays empty
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ctx["compare"] = numbers(got, reference(cfg, mix, seed, pool, lora0, device, closing=closing))
    return ctx


def numbers(got: dict, ref: dict) -> dict:
    """The compared numbers of training from ``reference``-shaped results of
    the program (or a control) and of the reference: over the set-up steps,
    each step's loss (the worst), the first gradient and the adapters'
    change after them; of the window's closing step (``last_``), its
    gradient and change. Gradients and changes are compared by the worst
    leaf, over the leaves that move (``compare.moving_leaves``). The closing
    step's loss is not compared: neither the control nor a planted fault
    separates it from sound runs (PERF.md)."""
    keep, keep_last = compare.moving_leaves(ref["grad1"]), compare.moving_leaves(ref["last"]["grad"])
    return {
        "loss_rel_gap": compare.loss_rel_gap(got["losses"], ref["losses"]),
        "grad_leaf_gap": compare.leaf_norm_gap(got["grad1"], ref["grad1"], keep),
        "change_leaf_gap": compare.leaf_norm_gap(got["change"], ref["change"], keep),
        "last_grad_leaf_gap": compare.leaf_norm_gap(got["last"]["grad"], ref["last"]["grad"], keep_last),
        "last_change_leaf_gap": compare.leaf_norm_gap(got["last"]["change"], ref["last"]["change"], keep_last),
    }


def _clone(leaves: dict) -> dict:
    return {k: v.detach().clone() for k, v in leaves.items()}


def _moments(opt, leaves: dict) -> dict:
    """``{leaf: (first, second moment)}`` of AdamW's state (zeros before its first step)."""
    st = opt.state
    return {k: tuple(st.get(p, {}).get(n, torch.zeros_like(p)).detach().clone() for n in ("exp_avg", "exp_avg_sq"))
            for k, p in leaves.items()}


def _leaves(lora) -> dict:
    """``{(path, 0 or 1): parameter}``: A and B of every adapted projection."""
    out = {}
    for path in lora.paths():
        a, b = lora.get(path)
        out[(path, 0)], out[(path, 1)] = a, b
    return out


def _traced_steps(trainer, state, feed, gen, device, steps: int = 3) -> dict:
    step_fn = trainer.step_fn

    def traced(*args, **kwargs):
        with torch.autograd.profiler.record_function(tr.PREFIX + "train_step"):
            return step_fn(*args, **kwargs)

    trainer.step_fn = traced
    feed.stop_at = None

    def work():
        nonlocal state
        state, _ = trainer.fit(state, feed, generator=gen, max_steps=state.step + steps)

    try:
        return tr.traced(device, work, program.launch_counts)
    finally:
        del trainer.step_fn


def reference(cfg: dict, mix: dict, seed: int, pool: list, lora0: dict, device, kind: str = "fp32",
              batch_rows=None, closing=None) -> dict:
    """The plain reference's first ``check_steps`` steps from the same
    weights, adapters, batches and draws: the losses, the first (clipped)
    gradient and the adapters' change, each leaf keyed ``(path, 0 or 1)``;
    and, under ``last``, the clipped gradient and change of one step
    from ``closing``: a state before the window's closing step (its
    adapters, AdamW moments, update count, batch index and draw generator
    state), or with ``"own"`` this reference's state after its set-up steps,
    which ``state`` returns in the same form. ``batch_rows`` keeps only
    those rows of each batch (a planted fault)."""
    with ops.fp32_mode():
        state_w = weights.make_state(cfg, seed, device, names=("unet", "vae", "text_encoder"))
        models = pipeline.build(cfg, state_w, ops.Arith(kind), device, names=("unet", "vae", "text_encoder"))
        del state_w
        lora = {p: (a.clone().requires_grad_(True), b.clone().requires_grad_(True)) for p, (a, b) in lora0.items()}
        start = _flat(lora)
        gen = _draw_generator(seed, device)
        opt_state, losses, grad1 = {}, [], None
        for step in range(mix["check_steps"]):
            loss, clipped = _ref_step(models, cfg, mix, pool[step % len(pool)], gen, lora, opt_state, step, batch_rows)
            losses.append(loss)
            grad1 = clipped if step == 0 else grad1
        now = _flat(lora)
        out = {"losses": losses, "grad1": grad1, "change": {k: now[k] - start[k] for k in now},
               "state": {"lora": now, "moments": {k: (m.clone(), v.clone()) for k, (m, v) in opt_state.items()},
                         "count": mix["check_steps"], "batch": mix["check_steps"] % len(pool),
                         "gen_state": gen.get_state()}}
        if closing is not None:
            closing = out["state"] if closing == "own" else closing
            lora = {p: (closing["lora"][(p, 0)].clone().requires_grad_(True),
                        closing["lora"][(p, 1)].clone().requires_grad_(True)) for p in lora0}
            opt_state = {k: (m.clone(), v.clone()) for k, (m, v) in closing["moments"].items()}
            gen = torch.Generator(device=device)
            gen.set_state(closing["gen_state"])
            _, clipped = _ref_step(models, cfg, mix, pool[closing["batch"]], gen, lora, opt_state, closing["count"],
                                   batch_rows)
            now = _flat(lora)
            out["last"] = {"grad": clipped, "change": {k: now[k] - closing["lora"][k] for k in now}}
    return out


def _flat(lora: dict) -> dict:
    return {(p, j): x.detach().clone() for p, pair in lora.items() for j, x in enumerate(pair)}


def _ref_step(models, cfg, mix, src: dict, gen, lora: dict, opt_state: dict, count: int, batch_rows) -> tuple:
    """One reference step on the batch ``src`` with the draws that ``gen``
    makes next, in place on ``lora`` and ``opt_state``: the loss and the
    clipped gradients."""
    factor = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    device = src["log_mel_spec"].device
    shape = (src["log_mel_spec"].shape[0], cfg["vae"]["latent_channels"], mix["frames"] // factor,
             cfg["vocoder"]["model_in_dim"] // factor)
    draws = {"latent_eps": torch.randn(shape, generator=gen, device=device),
             "noise": torch.randn(shape, generator=gen, device=device)}
    draws["t"] = torch.randint(0, cfg["scheduler"]["num_train_timesteps"], shape[:1], generator=gen, device=device)
    batch = {"mel": src["log_mel_spec"].float(), "ids": src["input_ids"], "mask": src["attention_mask"]}
    if batch_rows is not None:
        batch = {k: v[batch_rows] for k, v in batch.items()}
        draws = {k: v[batch_rows] for k, v in draws.items()}
    scale = cfg["lora"]["lora_alpha"] / cfg["lora"]["r"]
    loss, grads = pipeline.loss_and_grads(models, cfg, batch, draws, lora, scale)
    clipped = pipeline.adamw_step(lora, grads, opt_state, cfg["train"], count)
    return loss, {(p, j): g for p, pair in clipped.items() for j, g in enumerate(pair)}


def control(cfg: dict, mix: dict, seed: int, kind: str, fault, device, seconds: float) -> dict:
    """The compared numbers with the reference in ``kind`` in the program's
    place, or, with ``fault`` ``"half_batch"``, the fp32 reference fed half
    of each batch (the mean taken over the rest). The closing step is taken
    from the fp32 reference's state after the set-up steps, which stands in
    for the program's state at the window's close."""
    if fault not in (None, "half_batch"):
        raise ValueError(f"train_steps plants no fault {fault!r}")
    pool, lora0 = make_inputs(cfg, mix, seed, device)
    ref = reference(cfg, mix, seed, pool, lora0, device, closing="own")
    rows = list(range(mix["batch"] // 2)) if fault == "half_batch" else None
    got = reference(cfg, mix, seed, pool, lora0, device, kind="fp32" if fault else kind, batch_rows=rows,
                    closing=ref["state"])
    return numbers(got, ref)
