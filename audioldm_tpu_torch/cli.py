"""Command-line entry point of the port.

    python -m audioldm_tpu_torch.cli generate --checkpoint CKPT --prompt "..." [--device cuda]
    python -m audioldm_tpu_torch.cli serve --checkpoint CKPT --lora NAME=PATH (--requests R.jsonl --output DIR | --port N)
    python -m audioldm_tpu_torch.cli train --checkpoint CKPT --dataset DIR [--config run.yaml] [--device cuda]
    python -m audioldm_tpu_torch.cli distill --checkpoint CKPT --dataset DIR --output OUT [--w LO,HI] [--device cuda]
    python -m audioldm_tpu_torch.cli score --checkpoint CLAP --generated DIR [--reference DIR] [--prompt "..."]
    python -m audioldm_tpu_torch.cli slice --input WAV_OR_DIR --output DIR [--seconds 4.0]
    python -m audioldm_tpu_torch.cli export-dataset --dataset ID_OR_DIR --output DIR [--split train] [--limit N]
    python -m audioldm_tpu_torch.cli push-dataset --input DIR [--save DIR] [--repo ID]

``generate`` mirrors ``audioldm_tpu.cli generate``: text to audio with DDIM,
DPM-Solver++ or LCM sampling (``--scheduler``), classifier-free guidance on
every step or in a limited interval (``--guidance-interval LO,HI``),
MultiDiffusion windows for long clips (``--window-seconds``,
``--window-overlap``), and audio to audio from ``--init-audio`` (style
transfer by ``--strength``, inpainting by ``--inpaint`` and
``--inpaint-freq``, ``--sample-posterior``); bf16 UNet and VAE (fp32 with
``--fp32``), fp32 vocoder, 16 kHz wav output, and ``--lora PATH[:WEIGHT]`` to
merge PEFT LoRA adapters into the UNet at load time. ``--best-of N --clap
DIR`` generates N candidates in one batch and keeps the one whose CLAP score
against the prompt is highest.

``serve`` mirrors ``audioldm_tpu.cli serve``: batched multi-LoRA serving
through ``serve.ServeEngine`` (a bank of ``--lora NAME=PATH`` adapters,
``--compose`` weighted compositions), offline from a requests file to wavs
(``--requests``, ``--output``) or as the HTTP daemon with microbatching
(``--port``, ``--host``).

``train`` mirrors ``audioldm_tpu.cli train``: LoRA fine-tuning from a
directory of wavs with same-stem captions (or a HF dataset id) under the
run yaml (``--config``, the reference's ``config.yaml`` schema) and its
flag overrides, through ``data.DataPipeline`` and ``train.Trainer``, with
validation clips every ``--validate-every`` epochs, checkpoints and
``--resume``; metrics go to ``OUTPUT/metrics.jsonl`` (and wandb or
tensorboard when asked for). With ``--clap-dir`` validation also scores both
passes: CLAP scores against the prompt, KAD against the first
``--val-clips`` prepared clips of the dataset.

``distill`` mirrors ``audioldm_tpu.cli distill``: LCM-LoRA consistency
distillation of the 50-step CFG sampler into a 1-8 step adapter
(``train.distill``), from the same data as ``train``; it writes the EMA
adapter as ``OUTPUT/model.safetensors`` and the student as
``student.safetensors`` (PEFT layout), which ``generate --scheduler lcm
--lora OUTPUT/model.safetensors`` serves. ``--teacher-lora`` merges a PEFT
adapter into the base UNet first (distilling a fine-tuned model).

``score`` mirrors ``audioldm_tpu.cli score``: the CLAP score a clip of a
folder of wavs against ``--prompt`` and the folder's KAD against a
``--reference`` folder, as JSON (``--output``), with a CLAP model directory
(or a directory that holds one as ``clap/``).

``slice``, ``export-dataset`` and ``push-dataset`` mirror the JAX commands
of the same names: cut wavs into fixed-length segments; write a Hugging Face
dataset's clips as wav + caption txt pairs (``datasets.load_dataset``, as
the reference does: a hub id or a directory of data files such as
``train.parquet``); a wav + txt directory as a ``datasets.Dataset``, saved
with ``--save`` (``save_to_disk``) and pushed with ``--repo``.

Parallelism runs one process a GPU under torchrun (``python -m
torch.distributed.run --nproc-per-node N -m audioldm_tpu_torch.cli ...``):
``generate --tp N`` splits the UNet's heads and feed-forward width over N
ranks (``parallel.tp``); ``train --dp N``, ``distill --dp N`` and ``serve
--dp N`` split each batch over N ranks (``parallel.mesh``). ``--tp``/``--dp``
default to the number of processes (1 without torchrun); a value other than
it exits naming the torchrun command. With ``--device cpu`` the ranks talk
over gloo, on the GPU over NCCL. Only rank 0 prints results and writes
files.
"""

from __future__ import annotations

import argparse
import json
import os

def _parallel(args, flag: str, device: str):
    """The mesh of ``--tp``/``--dp`` (``flag``), or None for the
    single-device path: a mesh when the flag is given or when torchrun
    started more than one process. The flag's value must equal the number
    of processes."""
    from audioldm_tpu_torch.parallel import make_mesh, make_tp_mesh, torchrun_hint, world_size

    n, world = getattr(args, flag), world_size()
    if n is None and world == 1:
        return None
    n = world if n is None else n
    if n != world:
        raise SystemExit(f"--{flag} {n} needs {n} processes, but {world} {'is' if world == 1 else 'are'} running: "
                         f"launch with {torchrun_hint(n)}")
    return (make_tp_mesh if flag == "tp" else make_mesh)(n, device=device)


def _end(mesh) -> None:
    """Leave the process group of a command's mesh."""
    import torch.distributed as dist

    if mesh is not None and dist.is_initialized():
        dist.destroy_process_group()


def _parse_ranges(spec: str, conv):
    """``LO-HI[,LO-HI...]`` -> list of 2-tuples; raises ValueError on a piece
    that is not exactly two values ``conv`` can parse."""
    out = []
    for r in spec.split(","):
        parts = r.split("-")
        if len(parts) != 2:
            raise ValueError(f"range {r!r} is not LO-HI")
        out.append((conv(parts[0]), conv(parts[1])))
    return out


def _add_generate(sub):
    p = sub.add_parser("generate", help="text -> audio")
    p.add_argument("--checkpoint", required=True, help="audioldm checkpoint dir (HF layout)")
    p.add_argument("--prompt", required=True)
    p.add_argument("--negative-prompt", default="")
    p.add_argument("--lora", action="append", default=None, metavar="PATH[:WEIGHT]",
                   help="PEFT LoRA safetensors to merge at load; repeat with :WEIGHT suffixes for an "
                        "exact weighted composition (delta = sum_i w_i * (alpha/r) * A_i B_i)")
    p.add_argument("--lora-alpha", type=float, default=None, help="LoRA alpha (default: the adapter's rank)")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--guidance", type=float, default=2.5)
    p.add_argument("--scheduler", default="ddim", choices=["ddim", "dpm++", "lcm"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--output", default="output.wav")
    p.add_argument("--init-audio", default=None, metavar="WAV",
                   help="audio-to-audio: SDEdit style transfer from this clip (VAE-encode, noise to "
                        "--strength's timestep, denoise the rest)")
    p.add_argument("--strength", type=float, default=None,
                   help="(0,1] fraction of the schedule to re-run for --init-audio (diffusers img2img "
                        "convention; 1.0 = full redraw from the noised init; default 0.75)")
    p.add_argument("--inpaint", default=None, metavar="T0-T1[,T0-T1...]",
                   help="second ranges of --init-audio to regenerate; the rest is held to the source "
                        "every DDIM step (latent inpainting)")
    p.add_argument("--inpaint-freq", default=None, metavar="LO-HI[,LO-HI...]",
                   help="mel-bin ranges (of 64) to regenerate across the whole clip, e.g. 32-64 redraws "
                        "the top octave (super-resolution)")
    p.add_argument("--sample-posterior", action="store_true",
                   help="sample the VAE posterior for --init-audio instead of its mode")
    p.add_argument("--window-seconds", type=float, default=None,
                   help="long clips: MultiDiffusion windowed denoising; predict eps on overlapping windows "
                        "of this many seconds (one UNet call a step) and average the overlaps")
    p.add_argument("--window-overlap", type=float, default=0.5,
                   help="fraction of window overlap for --window-seconds (default 0.5)")
    p.add_argument("--guidance-interval", default=None, metavar="LO,HI",
                   help="limited-interval guidance: apply it only on steps whose timestep falls in [LO,HI] "
                        "(fractions of the train range, e.g. 0.05,0.65); the other steps run the "
                        "conditional-only UNet")
    p.add_argument("--best-of", type=int, default=None, metavar="N",
                   help="generate N candidates in one batch and keep the CLAP-highest (needs --clap)")
    p.add_argument("--clap", default=None, help="CLAP model dir for --best-of reranking")
    p.add_argument("--fp32", action="store_true", help="run the UNet and VAE in fp32 instead of bf16")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu only when asked)")
    p.add_argument("--tp", type=int, default=None,
                   help="tensor-parallel over N processes under torchrun (attention heads + FF split; default: the "
                        "number of processes)")


def _is_float(text: str) -> bool:
    try:
        float(text)
        return True
    except ValueError:
        return False


def merge_lora_specs(modules, specs, lora_alpha=None) -> str:
    """Load-time merge of ``PATH[:WEIGHT]`` PEFT adapter files into
    ``modules.unet`` (in place): import, compose with the weights, merge
    ``W += sum_i w_i * (alpha/r) * A_i B_i``. Returns a description."""
    from audioldm_tpu_torch.ckpt import read_safetensors
    from audioldm_tpu_torch.config import LoRAConfig
    from audioldm_tpu_torch.lora import compose_adapters, import_peft_state_dict, merge_lora

    parts = []
    for spec in specs:
        path, sep, w = spec.rpartition(":")
        if sep and not os.path.exists(spec) and _is_float(w):
            weight = float(w)
        else:
            path, weight = spec, 1.0
        lora, rank = import_peft_state_dict(read_safetensors(path))
        alpha = lora_alpha if lora_alpha is not None else float(rank)
        parts.append((lora, LoRAConfig(r=rank, lora_alpha=alpha), weight))
    composed, ccfg = compose_adapters(parts)
    merge_lora(modules.unet, composed, ccfg)
    return ", ".join(f"{s} (r={c.r}, w={w})" for (_, c, w), s in zip(parts, specs))


def _check_generate_args(args, tp: bool = False):
    """The JAX CLI's checks of flag combinations (``tp``: the tensor-parallel
    path runs); returns the parsed guidance interval (or None). Sets the
    default ``--strength``, and ``--batch`` to ``--best-of``'s N."""
    if args.best_of is not None:
        if args.best_of < 2 or args.batch != 1:
            raise SystemExit("--best-of needs N >= 2 and --batch 1 (candidates fill the batch)")
        if not args.clap:
            raise SystemExit("--best-of needs --clap (CLAP model dir for reranking)")
        args.batch = args.best_of

    if not args.init_audio:
        # audio-to-audio flags without an init clip would be silently ignored
        a2a_flags = [f for f, on in (("--strength", args.strength is not None),
                                     ("--inpaint", args.inpaint is not None),
                                     ("--inpaint-freq", args.inpaint_freq is not None),
                                     ("--sample-posterior", args.sample_posterior)) if on]
        if a2a_flags:
            verb = "requires" if len(a2a_flags) == 1 else "require"
            raise SystemExit(f"{'/'.join(a2a_flags)} {verb} --init-audio WAV (audio-to-audio)")

    guidance_interval = None
    if args.guidance_interval is not None:
        try:
            lo, hi = (float(x) for x in args.guidance_interval.split(","))
        except ValueError:
            raise SystemExit("--guidance-interval expects LO,HI fractions (e.g. 0.05,0.65)")
        if not 0.0 <= lo <= hi <= 1.0:
            raise SystemExit("--guidance-interval needs 0 <= LO <= HI <= 1")
        if args.scheduler == "lcm":
            raise SystemExit("--guidance-interval is meaningless with lcm (no CFG)")
        if args.window_seconds is not None or tp or args.init_audio:
            raise SystemExit("--guidance-interval is not combinable with --window-seconds/--tp/--init-audio")
        guidance_interval = (lo, hi)

    if args.init_audio:
        for flag, on in (("--tp", tp), ("--best-of", args.best_of is not None),
                         ("--window-seconds", args.window_seconds is not None)):
            if on:
                raise SystemExit(f"--init-audio is not combinable with {flag}")
        if args.scheduler == "lcm":
            raise SystemExit("--init-audio supports ddim/dpm++ (lcm uses its own distilled grid)")
        if args.strength is None:
            args.strength = 0.75
        if int(args.steps * args.strength) < 1:
            raise SystemExit(
                f"--strength {args.strength} too low for --steps {args.steps}: "
                "int(steps * strength) must be >= 1 (it is the number of denoise steps run)"
            )
        if (args.inpaint or args.inpaint_freq) and args.scheduler != "ddim":
            raise SystemExit("--inpaint/--inpaint-freq require --scheduler ddim")
    if tp and args.window_seconds is not None:
        raise SystemExit("--window-seconds is not wired into the --tp path; use one or the other")
    return guidance_interval


def cmd_generate(args):
    from audioldm_tpu_torch.parallel import world_size

    guidance_interval = _check_generate_args(args, tp=args.tp is not None or world_size() > 1)
    mesh = _parallel(args, "tp", args.device)
    try:
        _generate(args, mesh, guidance_interval)
    finally:
        _end(mesh)


def _generate(args, mesh, guidance_interval):
    import torch

    from audioldm_tpu_torch.data.tokenizer import load_tokenizer
    from audioldm_tpu_torch.data.wavio import read_wav, write_wav
    from audioldm_tpu_torch.pipeline.generate import AudioLDMModules, generate

    device = mesh.device if mesh is not None else args.device
    modules = AudioLDMModules.from_checkpoint(args.checkpoint, device=device)
    if args.lora:
        print(f"merged LoRA: {merge_lora_specs(modules, args.lora, args.lora_alpha)}")
    tokenizer = load_tokenizer(os.path.join(args.checkpoint, "tokenizer"))
    tok = tokenizer([args.prompt] * args.batch)
    unc = tokenizer([args.negative_prompt])
    prompts = (tok["input_ids"], tok["attention_mask"], unc["input_ids"], unc["attention_mask"])
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    common = dict(seed=args.seed, num_inference_steps=args.steps, audio_length_in_s=args.seconds,
                  guidance_scale=args.guidance, dtype=dtype, scheduler=args.scheduler, device=device)
    sr = modules.vocoder.cfg.sampling_rate
    if args.init_audio:
        from audioldm_tpu_torch.ops.resample import resample_np
        from audioldm_tpu_torch.pipeline.audio2audio import generate_from_audio, latent_mask, prepare_init_mel

        wav_in, sr_in = read_wav(args.init_audio)
        if sr_in != sr:
            wav_in = resample_np(wav_in, sr_in, sr)
        mel_init = prepare_init_mel(wav_in, modules, args.seconds)
        inp_mask = None
        if args.inpaint or args.inpaint_freq:
            try:
                times = _parse_ranges(args.inpaint, float) if args.inpaint else None
                freqs = _parse_ranges(args.inpaint_freq, int) if args.inpaint_freq else None
            except ValueError:
                raise SystemExit("--inpaint/--inpaint-freq expect LO-HI[,LO-HI...] ranges")
            inp_mask = latent_mask(modules, args.seconds, regenerate_times=times, regenerate_mel_bins=freqs)
        mode = "inpainting" if inp_mask is not None else f"style transfer (strength {args.strength})"
        print(f"audio-to-audio from {args.init_audio}: {mode}")
        wav = generate_from_audio(modules, mel_init, *prompts, strength=args.strength, inpaint_mask=inp_mask,
                                  sample_posterior=args.sample_posterior, **common)
    elif mesh is not None:
        from audioldm_tpu_torch.parallel import make_tp_generate_fn, shard_modules

        fn = make_tp_generate_fn(shard_modules(mesh, modules), mesh, num_inference_steps=args.steps,
                                 audio_length_in_s=args.seconds, guidance_scale=args.guidance, dtype=dtype,
                                 scheduler=args.scheduler)
        if mesh.rank == 0:
            print(f"tensor-parallel over {mesh.size} devices (attention heads + FF sharded)")
        wav = fn(*prompts, seed=args.seed)
    else:
        wav = generate(modules, *prompts, window_seconds=args.window_seconds, window_overlap=args.window_overlap,
                       guidance_interval=guidance_interval, **common)
    wav = wav.cpu().numpy()
    if mesh is not None and mesh.rank != 0:
        return
    if args.best_of is not None:
        from audioldm_tpu_torch.eval.scoring import ClapScorer

        scorer = ClapScorer.from_checkpoint(args.clap, device=device)
        scores = scorer.clap_scores(scorer.to_48k(wav, sr), args.prompt)
        best = int(scores.argmax())
        write_wav(args.output, wav[best], sr)
        print(f"best-of-{args.best_of}: kept candidate {best} "
              f"(clap {scores[best]:.4f}; all: {[round(float(s), 4) for s in scores]})")
        print(f"wrote {args.output}")
    elif args.batch == 1:
        write_wav(args.output, wav[0], sr)
        print(f"wrote {args.output}")
    else:
        stem, ext = os.path.splitext(args.output)
        for i in range(args.batch):
            write_wav(f"{stem}_{i}{ext}", wav[i], sr)
        print(f"wrote {args.batch} clips to {stem}_*{ext}")


def _add_serve(sub):
    p = sub.add_parser("serve", help="batched multi-LoRA serving: requests file -> wavs, or --port for the HTTP daemon")
    p.add_argument("--checkpoint", required=True, help="audioldm checkpoint dir (HF layout)")
    p.add_argument("--port", type=int, default=None,
                   help="run the HTTP serving daemon on this port (microbatching; POST /v1/generate, "
                        "POST /v1/adapters hot-load, DELETE /v1/adapters/<name>, /healthz, /v1/stats)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--batch-delay-ms", type=float, default=50.0,
                   help="daemon batching window: close a batch when the oldest request has waited this long")
    p.add_argument("--warmup", action="store_true",
                   help="daemon: run one throwaway batch of every bucket before accepting traffic")
    p.add_argument("--requests", default=None, help='jsonl file: {"prompt": ..., "adapter": <name|null>} per line')
    p.add_argument("--lora", action="append", default=[], metavar="NAME=PATH",
                   help="adapter bank entry (PEFT safetensors); repeatable")
    p.add_argument("--compose", action="append", default=[], metavar="NAME=COMP:W,COMP:W",
                   help="register a weighted composition of bank adapters as a servable adapter "
                        "(exact: delta = sum w_i*scale*A_i B_i); repeatable")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--guidance", type=float, default=2.5)
    p.add_argument("--scheduler", default="ddim", choices=["ddim", "dpm++", "lcm"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-batch", type=int, default=None)
    p.add_argument("--max-adapters", type=int, default=None,
                   help="bank capacity policy: hot-loading past this count LRU-evicts the least recently "
                        "served adapter not pinned by a composition (daemon only)")
    p.add_argument("--geometry", action="append", default=[], metavar="SPEC",
                   help="daemon geometry allowlist entry; repeatable. 'default' = this command's --steps/"
                        "--seconds/--guidance/--scheduler, or a JSON object with any of steps/seconds/guidance/"
                        "scheduler/window_seconds/window_overlap/guidance_interval (missing fields take this "
                        "command's flags, as bare requests do). With at least one, requests of another "
                        "geometry get HTTP 400; without, any geometry is accepted")
    p.add_argument("--output", default=None, help="output dir (000000.wav ... in request order)")
    p.add_argument("--fp32", action="store_true", help="run the UNet and VAE in fp32 instead of bf16")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu only when asked)")
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel over N processes under torchrun (default: the number of processes)")


def _parse_geometry(spec: str, defaults, modules):
    """A ``--geometry`` entry -> validated ``GenParams``: 'default', or a
    JSON object whose present, non-null fields override ``defaults`` (the
    HTTP handler's rule, ``GenParams.from_fields``)."""
    from audioldm_tpu_torch.serve.daemon import REQUEST_FIELDS, GenParams

    if spec == "default":
        return defaults
    try:
        d = json.loads(spec)
        if not isinstance(d, dict):
            raise ValueError("not a JSON object")
        # the negative prompt groups batches but is no part of a geometry
        unknown = set(d) - (set(REQUEST_FIELDS) - {"negative_prompt"}) - {"guidance_interval"}
        if unknown:
            raise ValueError(f"unknown fields {sorted(unknown)}")
        # an entry the pipeline would reject is dead config: fail at startup
        return GenParams.from_fields(d, defaults, modules)
    except (ValueError, TypeError) as e:  # json.JSONDecodeError is a ValueError
        raise SystemExit(f"--geometry expects 'default' or a JSON object (steps/seconds/guidance/scheduler/"
                         f"window_seconds/window_overlap/guidance_interval), got {spec!r}: {e}")


def cmd_serve(args):
    import torch

    from audioldm_tpu_torch.ckpt import read_safetensors
    from audioldm_tpu_torch.config import LoRAConfig
    from audioldm_tpu_torch.data.tokenizer import load_tokenizer
    from audioldm_tpu_torch.data.wavio import write_wav
    from audioldm_tpu_torch.lora import import_peft_state_dict
    from audioldm_tpu_torch.pipeline.generate import AudioLDMModules
    from audioldm_tpu_torch.serve import AdapterBank, GenParams, Microbatcher, ServeEngine, make_server

    if (args.port is None) == (args.requests is None):
        raise SystemExit("serve needs exactly one of --requests (offline batch) or --port (HTTP daemon)")
    if args.requests is not None and args.output is None:
        raise SystemExit("offline serve (--requests) needs --output")
    mesh = _parallel(args, "dp", args.device)
    try:
        _serve(args, mesh)
    finally:
        _end(mesh)


def _serve(args, mesh):
    import torch

    from audioldm_tpu_torch.ckpt import read_safetensors
    from audioldm_tpu_torch.config import LoRAConfig
    from audioldm_tpu_torch.data.tokenizer import load_tokenizer
    from audioldm_tpu_torch.data.wavio import write_wav
    from audioldm_tpu_torch.lora import import_peft_state_dict
    from audioldm_tpu_torch.pipeline.generate import AudioLDMModules
    from audioldm_tpu_torch.serve import AdapterBank, GenParams, Microbatcher, ServeEngine, make_server
    from audioldm_tpu_torch.serve.daemon import follow

    main = mesh is None or mesh.rank == 0
    device = mesh.device if mesh is not None else args.device
    modules = AudioLDMModules.from_checkpoint(args.checkpoint, device=device)
    tokenizer = load_tokenizer(os.path.join(args.checkpoint, "tokenizer"))
    bank, lcfg = None, LoRAConfig()
    if args.lora:
        adapters, rank = {}, None
        for spec in args.lora:
            name, _, path = spec.partition("=")
            if not path:
                raise SystemExit(f"--lora expects NAME=PATH, got {spec!r}")
            adapters[name], rank = import_peft_state_dict(read_safetensors(path))
        lcfg = LoRAConfig(r=rank, lora_alpha=float(rank))
        bank = AdapterBank.from_adapters(adapters, lcfg, device=device)
    engine = ServeEngine(modules, tokenizer, lcfg, bank=bank, dtype=torch.float32 if args.fp32 else torch.bfloat16,
                         device=device, mesh=mesh)
    for spec in args.compose:
        name, _, rest = spec.partition("=")
        if not rest:
            raise SystemExit(f"--compose expects NAME=COMP:W,COMP:W, got {spec!r}")
        weights = {}
        for term in rest.split(","):
            comp, _, w = term.partition(":")
            weights[comp] = float(w) if w else 1.0
        engine.add_composed(name, weights)
        if main:
            print(f"composed adapter {name!r} = {weights}")
    sr = modules.vocoder.cfg.sampling_rate

    if args.port is not None:
        if args.warmup:
            if main:
                print("warming up: one batch of every bucket ...")
            engine.warmup(num_inference_steps=args.steps, audio_length_in_s=args.seconds,
                          guidance_scale=args.guidance, scheduler=args.scheduler)
        if not main:  # rank 0 serves HTTP; this rank makes the engine calls it sends
            follow(engine)
            return
        # the daemon's request defaults: fields a client omits come from
        # here, and `--geometry default` allows exactly these
        defaults = GenParams(num_inference_steps=args.steps, audio_length_in_s=args.seconds,
                             guidance_scale=args.guidance, scheduler=args.scheduler)
        geometries = None
        if args.geometry:
            geometries = [_parse_geometry(spec, defaults, modules) for spec in args.geometry]
            print(f"geometry allowlist: {[g.geometry() for g in geometries]}")
        batcher = Microbatcher(engine, max_batch=args.max_batch or engine.bucket_sizes[-1],
                               max_delay_ms=args.batch_delay_ms, base_seed=args.seed,
                               max_adapters=args.max_adapters, geometries=geometries, defaults=defaults)
        server = make_server(batcher, sr, host=args.host, port=args.port)
        print(f"serving on http://{args.host}:{server.server_address[1]} "
              f"(POST /v1/generate; adapters: {sorted(bank.names) if bank else ['base']})", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
            batcher.close()
        return

    with open(args.requests) as f:
        requests = [json.loads(line) for line in f if line.strip()]
    if not requests:
        raise SystemExit(f"no requests in {args.requests}")
    for r in requests:
        engine.submit(r["prompt"], r.get("adapter"))
    wavs = engine.flush(num_inference_steps=args.steps, audio_length_in_s=args.seconds,
                        guidance_scale=args.guidance, seed=args.seed, max_batch=args.max_batch)
    if not main:
        return
    os.makedirs(args.output, exist_ok=True)
    for i in range(wavs.shape[0]):
        write_wav(os.path.join(args.output, f"{i:06d}.wav"), wavs[i], sr)
    print(f"served {wavs.shape[0]} requests -> {args.output}")


def _add_train(sub):
    p = sub.add_parser("train", help="LoRA fine-tune")
    p.add_argument("--checkpoint", required=True, help="audioldm checkpoint dir (HF layout)")
    p.add_argument("--config", default=None, help="run config yaml (config.yaml schema)")
    p.add_argument("--dataset", default=None, help="wav+txt dir or HF dataset id (overrides the config)")
    p.add_argument("--output", default=None)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None, help="train for N epochs (config num_train_epochs)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--log-every", type=int, default=10, help="host metric fetch cadence (steps)")
    p.add_argument("--profile-dir", default=None, help="capture a torch.profiler trace of steps 2-5 into this dir")
    p.add_argument("--validate-every", type=int, default=None,
                   help="validation cadence in EPOCHS (default: config validation_epochs; 0 disables)")
    p.add_argument("--val-prompt", default=None, help="validation prompt (default: config validation_prompt)")
    p.add_argument("--val-clips", type=int, default=None, help="clips per validation (default: config num_validation_images)")
    p.add_argument("--val-steps", type=int, default=50)
    p.add_argument("--val-seconds", type=float, default=4.0)
    p.add_argument("--clap-dir", default=None, help="CLAP model dir: validation scores CLAP and KAD")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu only when asked)")
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel over N processes under torchrun (default: the number of processes)")


def cmd_train(args):
    """Returns ``(trainer, state)`` after the last step and ``trainer.save``."""
    mesh = _parallel(args, "dp", args.device)
    try:
        return _train(args, mesh)
    finally:
        _end(mesh)


def _train(args, mesh):
    import dataclasses

    import numpy as np
    import torch

    from audioldm_tpu_torch.config import RunConfig
    from audioldm_tpu_torch.data import AudioCaptionDataset, DataPipeline, load_tokenizer
    from audioldm_tpu_torch.lora import init_lora
    from audioldm_tpu_torch.pipeline.generate import AudioLDMModules
    from audioldm_tpu_torch.train import Trainer, to_device_batch
    from audioldm_tpu_torch.utils import MetricLogger

    main = mesh is None or mesh.rank == 0
    device = mesh.device if mesh is not None else args.device
    run = RunConfig.from_yaml(args.config) if args.config else RunConfig()
    if args.dataset:
        run = dataclasses.replace(run, dataset_hub_id=args.dataset)
    output_dir = args.output or run.output_dir
    tcfg = run.train
    if args.max_steps:
        tcfg = dataclasses.replace(tcfg, max_train_steps=args.max_steps)
    if args.batch_size:
        tcfg = dataclasses.replace(tcfg, train_batch_size=args.batch_size)

    modules = AudioLDMModules.from_checkpoint(args.checkpoint, device=device)
    tokenizer = load_tokenizer(os.path.join(args.checkpoint, "tokenizer"))
    if os.path.isdir(run.dataset_hub_id):
        source = run.dataset_hub_id
    else:
        from datasets import load_dataset

        source = load_dataset(run.dataset_hub_id, split="train")
    pipe = DataPipeline(AudioCaptionDataset(source), tokenizer, run.mel, add_ons=run.data.add_ons, trim=run.data.trim,
                        freqm=run.data.freqm, timem=run.data.timem, device=device)
    logger = (MetricLogger(output_dir, wandb_config=run.wandb, use_wandb=args.wandb, use_tensorboard=args.tensorboard)
              if main else None)
    trainer = Trainer(modules, run.lora, tcfg, output_dir, logger=logger, device=device, mesh=mesh,
                      dtype=torch.bfloat16 if tcfg.mixed_precision == "bfloat16" else torch.float32)
    state = trainer.init_state(init_lora(modules.unet, run.lora, torch.Generator().manual_seed(tcfg.seed)))
    if args.resume:
        state = trainer.restore(state)
        if main:
            print(f"resumed at step {state.step}")

    # one optimizer step takes batch x data-parallel ranks x accumulation
    # samples (the JAX CLI's rule): each rank steps on its rows of it
    global_bs = tcfg.train_batch_size * (mesh.size if mesh is not None else 1) * max(tcfg.gradient_accumulation_steps, 1)
    steps_per_epoch = max(len(pipe.dataset) // global_bs, 1)

    validate_every_epochs = args.validate_every if args.validate_every is not None else run.validation_epochs
    validate_fn = None
    if validate_every_epochs and validate_every_epochs > 0 and main:  # only rank 0 validates
        from audioldm_tpu_torch.train.validation import log_validation

        val_prompt = args.val_prompt or run.validation_prompt
        val_clips = args.val_clips or run.num_validation_images
        scorer = ref_audios = None
        if args.clap_dir:
            from audioldm_tpu_torch.eval.scoring import ClapScorer

            scorer = ClapScorer.from_checkpoint(args.clap_dir, device=device)
            # the KAD reference corpus: prepared dataset clips (the reference
            # scores against its training-set audio, train:597-607)
            rng0 = np.random.default_rng(tcfg.seed)
            ref_audios = []
            for i in range(min(val_clips, len(pipe.dataset))):
                wav, sr, _ = pipe.dataset.get_raw(i)
                ref_audios.append(pipe.prepare_waveform(wav, sr, rng0)[0])

        def validate_fn(state, step):
            # in the trainer's dtype: generate casts the UNet and VAE in place
            return log_validation(modules, state.lora, run.lora, tokenizer, val_prompt, num_clips=val_clips,
                                  num_inference_steps=args.val_steps, audio_length_in_s=args.val_seconds,
                                  scorer=scorer, ref_audios_16k=ref_audios, logger=logger, step=step, seed=tcfg.seed,
                                  dtype=trainer.dtype, device=trainer.device)

    batches = pipe.batches(global_bs, np.random.default_rng(tcfg.seed), prefetch=run.data.prefetch)
    try:
        state, metrics = trainer.fit(
            state, (to_device_batch(b, trainer.device) for b in batches),
            torch.Generator(device=trainer.device).manual_seed(tcfg.seed + 1),
            log_every=args.log_every, steps_per_epoch=steps_per_epoch,
            num_epochs=args.epochs or (tcfg.num_train_epochs if args.max_steps is None else None),
            validate_every_epochs=validate_every_epochs if validate_fn else None, validate_fn=validate_fn,
            profile_dir=args.profile_dir if main else None,
        )
    finally:
        batches.close()  # stops the prefetch thread
    trainer.save(state)
    if not main:
        return trainer, state
    logger.close()
    if "loss" in metrics:
        print(f"done at step {state.step}; final loss {float(metrics['loss']):.4f}")
    else:
        print(f"done at step {state.step}; no steps run (already at max_steps or empty dataset)")
    return trainer, state


def _add_distill(sub):
    p = sub.add_parser("distill", help="LCM consistency-distill the 50-step CFG sampler into a 1-8 step LoRA adapter "
                                       "(serve it with generate --scheduler lcm --lora ...)")
    p.add_argument("--checkpoint", required=True, help="audioldm checkpoint dir (HF layout)")
    p.add_argument("--config", default=None, help="run config yaml (config.yaml schema)")
    p.add_argument("--dataset", default=None, help="wav+txt dir or HF dataset id (overrides the config)")
    p.add_argument("--output", required=True)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--w", default="2.5",
                   help="guidance baked into the student: a float, or LO,HI to draw w ~ U[LO,HI] per example")
    p.add_argument("--ema-decay", type=float, default=0.95)
    p.add_argument("--num-ddim-steps", type=int, default=50, help="teacher trajectory grid size")
    p.add_argument("--teacher-lora", default=None,
                   help="PEFT safetensors merged into the teacher first (distill a fine-tuned genre model)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu only when asked)")
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel over N processes under torchrun (default: the number of processes)")


def cmd_distill(args):
    """Returns the ``DistillState`` after the last step."""
    mesh = _parallel(args, "dp", args.device)
    try:
        return _distill(args, mesh)
    finally:
        _end(mesh)


def _distill(args, mesh):
    import dataclasses

    import numpy as np
    import torch

    from audioldm_tpu_torch.ckpt import read_safetensors, write_safetensors
    from audioldm_tpu_torch.config import LoRAConfig, RunConfig
    from audioldm_tpu_torch.data import AudioCaptionDataset, DataPipeline, load_tokenizer
    from audioldm_tpu_torch.lora import export_peft_state_dict, import_peft_state_dict, init_lora, merge_lora
    from audioldm_tpu_torch.parallel import shard_batch
    from audioldm_tpu_torch.pipeline.generate import AudioLDMModules
    from audioldm_tpu_torch.train import to_device_batch
    from audioldm_tpu_torch.train.distill import add_uncond_tokens, distill_modules, distill_step, init_distill_state
    from audioldm_tpu_torch.utils import MetricLogger

    main = mesh is None or mesh.rank == 0
    device = mesh.device if mesh is not None else args.device
    run = RunConfig.from_yaml(args.config) if args.config else RunConfig()
    if args.dataset:
        run = dataclasses.replace(run, dataset_hub_id=args.dataset)
    tcfg = run.train
    if args.max_steps:
        tcfg = dataclasses.replace(tcfg, max_train_steps=args.max_steps)
    if args.batch_size:
        tcfg = dataclasses.replace(tcfg, train_batch_size=args.batch_size)
    try:
        w = tuple(float(x) for x in args.w.split(",")) if "," in args.w else float(args.w)
    except ValueError:
        raise SystemExit(f"--w expects a float or LO,HI, got {args.w!r}")
    if isinstance(w, tuple) and (len(w) != 2 or w[0] > w[1]):
        raise SystemExit(f"--w LO,HI needs two values with LO <= HI, got {args.w!r}")

    modules = AudioLDMModules.from_checkpoint(args.checkpoint, device=device)
    tokenizer = load_tokenizer(os.path.join(args.checkpoint, "tokenizer"))
    if args.teacher_lora:
        tree, rank = import_peft_state_dict(read_safetensors(args.teacher_lora))
        merge_lora(modules.unet, tree, LoRAConfig(r=rank, lora_alpha=float(rank)))
    dtype = torch.bfloat16 if tcfg.mixed_precision == "bfloat16" else torch.float32
    distill_modules(modules, dtype)
    if os.path.isdir(run.dataset_hub_id):
        source = run.dataset_hub_id
    else:
        from datasets import load_dataset

        source = load_dataset(run.dataset_hub_id, split="train")
    pipe = DataPipeline(AudioCaptionDataset(source), tokenizer, run.mel, device=device)
    logger = MetricLogger(args.output) if main else None

    dev = modules.device
    state = init_distill_state(init_lora(modules.unet, run.lora, torch.Generator().manual_seed(tcfg.seed)), tcfg)
    generator = torch.Generator(device=dev).manual_seed(tcfg.seed + 1)
    base_keys = ("log_mel_spec", "input_ids", "attention_mask")
    # a global batch of batch x data-parallel ranks (the JAX CLI's rule); each rank steps on its rows
    global_bs = tcfg.train_batch_size * (mesh.size if mesh is not None else 1)
    batches = pipe.batches(global_bs, np.random.default_rng(tcfg.seed), prefetch=run.data.prefetch)
    metrics = {}
    try:
        for batch in batches:
            if state.step >= tcfg.max_train_steps:
                break
            b = {k: batch[k] for k in base_keys}
            if mesh is not None:  # before the [1, L] negative prompt joins, which every rank keeps whole
                b = shard_batch(mesh, b)
            b = to_device_batch(add_uncond_tokens(b, tokenizer), dev)
            state, metrics = distill_step(state, modules, b, run.lora, dtype, w=w, num_ddim_steps=args.num_ddim_steps,
                                          ema_decay=args.ema_decay, generator=generator, mesh=mesh)
            if logger is not None and (state.step % max(args.log_every, 1) == 0 or state.step == tcfg.max_train_steps):
                logger.log({"distill_loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])}, step=state.step)
    finally:
        batches.close()  # stops the prefetch thread
    if not main:
        return state
    logger.close()

    # the EMA adapter is the sampler (model.safetensors, PEFT layout: served by
    # generate/serve --lora with --scheduler lcm); the raw student beside it
    os.makedirs(args.output, exist_ok=True)
    for name, adapters in (("model", state.ema_lora), ("student", state.lora)):
        write_safetensors(os.path.join(args.output, f"{name}.safetensors"), export_peft_state_dict(adapters))
    loss_txt = f"; final loss {float(metrics['loss']):.4f}" if "loss" in metrics else ""
    print(f"distilled {state.step} steps -> {args.output}/model.safetensors{loss_txt}")
    return state


def _add_score(sub):
    p = sub.add_parser("score", help="CLAP/KAD scoring of generated vs reference wav dirs")
    p.add_argument("--checkpoint", required=True, help="checkpoint dir with a clap/ subfolder, or a CLAP model dir")
    p.add_argument("--generated", required=True)
    p.add_argument("--reference", default=None)
    p.add_argument("--prompt", default=None)
    p.add_argument("--output", default=None, help="write results json here")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu only when asked)")


def cmd_score(args):
    from audioldm_tpu_torch.eval.scoring import score_directories

    results = score_directories(clap_dir=args.checkpoint, generated_dir=args.generated, reference_dir=args.reference,
                                prompt=args.prompt, device=args.device)
    print(json.dumps(results, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)
    return results


def _add_export(sub):
    p = sub.add_parser("export-dataset", help="HF dataset -> wav + caption txt pairs")
    p.add_argument("--dataset", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--output", required=True)
    p.add_argument("--limit", type=int, default=None)


def cmd_export(args):
    import numpy as np
    from datasets import load_dataset

    from audioldm_tpu_torch.data.wavio import write_wav

    ds = load_dataset(args.dataset, split=args.split)
    os.makedirs(args.output, exist_ok=True)
    n = 0
    for i, item in enumerate(ds):
        if args.limit and n >= args.limit:
            break
        wav = np.asarray(item["audio"]["array"], np.float32)
        write_wav(os.path.join(args.output, f"{i:06d}.wav"), wav, int(item["audio"]["sampling_rate"]))
        with open(os.path.join(args.output, f"{i:06d}.txt"), "w") as f:
            f.write(item.get("caption", ""))
        n += 1
    print(f"exported {n} items to {args.output}")


def _add_push(sub):
    p = sub.add_parser("push-dataset", help="wav+txt dir -> HF dataset (+push)")
    p.add_argument("--input", required=True)
    p.add_argument("--repo", default=None, help="hub repo id to push to (omit for local save)")
    p.add_argument("--save", default=None, help="local dataset dir to save to")


def cmd_push(args):
    from datasets import Dataset

    from audioldm_tpu_torch.data.dataset import AudioCaptionDataset

    ds = AudioCaptionDataset(args.input)
    records = {"audio": [], "caption": []}
    for i in range(len(ds)):
        wav, sr, cap = ds.get_raw(i)
        records["audio"].append({"array": wav, "sampling_rate": sr})
        records["caption"].append(cap)
    hf = Dataset.from_dict(records)
    if args.save:
        hf.save_to_disk(args.save)
        print(f"saved dataset to {args.save}")
    if args.repo:
        hf.push_to_hub(args.repo)
        print(f"pushed to {args.repo}")


def _add_slice(sub):
    p = sub.add_parser("slice", help="cut wavs into fixed-length segments")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--seconds", type=float, default=4.0)


def cmd_slice(args):
    from audioldm_tpu_torch.data.wavio import slice_wav

    paths = (
        [args.input]
        if args.input.endswith(".wav")
        else [os.path.join(args.input, f) for f in sorted(os.listdir(args.input)) if f.endswith(".wav")]
    )
    total = sum(len(slice_wav(p, args.output, args.seconds)) for p in paths)
    print(f"wrote {total} segments to {args.output}")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="audioldm_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    for add in (_add_generate, _add_serve, _add_train, _add_distill, _add_score, _add_export, _add_push, _add_slice):
        add(sub)
    args = parser.parse_args(argv)
    return {"generate": cmd_generate, "serve": cmd_serve, "train": cmd_train, "distill": cmd_distill,
            "score": cmd_score, "export-dataset": cmd_export, "push-dataset": cmd_push,
            "slice": cmd_slice}[args.command](args)


if __name__ == "__main__":
    main()
