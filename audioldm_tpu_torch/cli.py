"""Command-line entry point of the port.

    python -m audioldm_tpu_torch.cli generate --checkpoint CKPT --prompt "..." [--device cuda]
    python -m audioldm_tpu_torch.cli serve --checkpoint CKPT --lora NAME=PATH (--requests R.jsonl --output DIR | --port N)

``generate`` mirrors ``audioldm_tpu.cli generate``: text to audio with DDIM,
DPM-Solver++ or LCM sampling (``--scheduler``), classifier-free guidance on
every step or in a limited interval (``--guidance-interval LO,HI``),
MultiDiffusion windows for long clips (``--window-seconds``,
``--window-overlap``), and audio to audio from ``--init-audio`` (style
transfer by ``--strength``, inpainting by ``--inpaint`` and
``--inpaint-freq``, ``--sample-posterior``); bf16 UNet and VAE (fp32 with
``--fp32``), fp32 vocoder, 16 kHz wav output, and ``--lora PATH[:WEIGHT]`` to
merge PEFT LoRA adapters into the UNet at load time.

``serve`` mirrors ``audioldm_tpu.cli serve``: batched multi-LoRA serving
through ``serve.ServeEngine`` (a bank of ``--lora NAME=PATH`` adapters,
``--compose`` weighted compositions), offline from a requests file to wavs
(``--requests``, ``--output``) or as the HTTP daemon with microbatching
(``--port``, ``--host``).

``--tp``, ``--best-of`` and ``--clap`` of ``generate`` and ``--dp`` of
``serve`` belong to later slices of the port and exit with a message; so
does ``train``, whose data layer is not ported (the trainer itself is:
``audioldm_tpu_torch.train.Trainer``).
"""

from __future__ import annotations

import argparse
import json
import os

# flags of the JAX CLI that this port does not serve yet -> the part of the
# port they wait for
_LATER = {
    "tp": "parallelism",
    "best_of": "CLAP evaluation",
    "clap": "CLAP evaluation",
    "dp": "parallelism",
}


def _add_later(p, flags) -> None:
    for flag in flags:
        p.add_argument("--" + flag.replace("_", "-"), default=None, help=argparse.SUPPRESS)


def _refuse_later(args) -> None:
    for flag, part in _LATER.items():
        if getattr(args, flag, None) is not None:
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported yet: it comes with {part}")


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
    p.add_argument("--fp32", action="store_true", help="run the UNet and VAE in fp32 instead of bf16")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu only when asked)")
    _add_later(p, ("tp", "best_of", "clap"))


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


def _check_generate_args(args):
    """The JAX CLI's checks of flag combinations; returns the parsed
    guidance interval (or None). Sets the default ``--strength``."""
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
        if args.window_seconds is not None or args.init_audio:
            raise SystemExit("--guidance-interval is not combinable with --window-seconds/--init-audio")
        guidance_interval = (lo, hi)

    if args.init_audio:
        if args.window_seconds is not None:
            raise SystemExit("--init-audio is not combinable with --window-seconds")
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
    return guidance_interval


def cmd_generate(args):
    import torch

    from audioldm_tpu_torch.data.tokenizer import load_tokenizer
    from audioldm_tpu_torch.data.wavio import read_wav, write_wav
    from audioldm_tpu_torch.pipeline.generate import AudioLDMModules, generate

    _refuse_later(args)
    guidance_interval = _check_generate_args(args)

    modules = AudioLDMModules.from_checkpoint(args.checkpoint, device=args.device)
    if args.lora:
        print(f"merged LoRA: {merge_lora_specs(modules, args.lora, args.lora_alpha)}")
    tokenizer = load_tokenizer(os.path.join(args.checkpoint, "tokenizer"))
    tok = tokenizer([args.prompt] * args.batch)
    unc = tokenizer([args.negative_prompt])
    prompts = (tok["input_ids"], tok["attention_mask"], unc["input_ids"], unc["attention_mask"])
    common = dict(seed=args.seed, num_inference_steps=args.steps, audio_length_in_s=args.seconds,
                  guidance_scale=args.guidance, dtype=torch.float32 if args.fp32 else torch.bfloat16,
                  scheduler=args.scheduler, device=args.device)
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
    else:
        wav = generate(modules, *prompts, window_seconds=args.window_seconds, window_overlap=args.window_overlap,
                       guidance_interval=guidance_interval, **common)
    wav = wav.cpu().numpy()
    if args.batch == 1:
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
    _add_later(p, ("dp",))


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

    _refuse_later(args)
    if (args.port is None) == (args.requests is None):
        raise SystemExit("serve needs exactly one of --requests (offline batch) or --port (HTTP daemon)")
    if args.requests is not None and args.output is None:
        raise SystemExit("offline serve (--requests) needs --output")

    modules = AudioLDMModules.from_checkpoint(args.checkpoint, device=args.device)
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
        bank = AdapterBank.from_adapters(adapters, lcfg, device=args.device)
    engine = ServeEngine(modules, tokenizer, lcfg, bank=bank, dtype=torch.float32 if args.fp32 else torch.bfloat16,
                         device=args.device)
    for spec in args.compose:
        name, _, rest = spec.partition("=")
        if not rest:
            raise SystemExit(f"--compose expects NAME=COMP:W,COMP:W, got {spec!r}")
        weights = {}
        for term in rest.split(","):
            comp, _, w = term.partition(":")
            weights[comp] = float(w) if w else 1.0
        engine.add_composed(name, weights)
        print(f"composed adapter {name!r} = {weights}")
    sr = modules.vocoder.cfg.sampling_rate

    if args.port is not None:
        if args.warmup:
            print("warming up: one batch of every bucket ...")
            engine.warmup(num_inference_steps=args.steps, audio_length_in_s=args.seconds,
                          guidance_scale=args.guidance, scheduler=args.scheduler)
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
    os.makedirs(args.output, exist_ok=True)
    for i in range(wavs.shape[0]):
        write_wav(os.path.join(args.output, f"{i:06d}.wav"), wavs[i], sr)
    print(f"served {wavs.shape[0]} requests -> {args.output}")


def cmd_train(args):
    raise SystemExit(
        "train is not ported yet: it comes with the data layer (run config, dataset pipeline, mel "
        "front end). The trainer is: drive audioldm_tpu_torch.train.Trainer(...).fit(state, batches) "
        "with an iterator of {log_mel_spec, input_ids, attention_mask} batches."
    )


def main(argv=None):
    parser = argparse.ArgumentParser(prog="audioldm_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_generate(sub)
    _add_serve(sub)
    sub.add_parser("train", help="LoRA fine-tuning (waits for the data layer)", add_help=False)
    args, rest = parser.parse_known_args(argv)
    if args.command != "train" and rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    {"generate": cmd_generate, "serve": cmd_serve, "train": cmd_train}[args.command](args)


if __name__ == "__main__":
    main()
