"""Command-line entry point of the port.

    python -m audioldm_tpu_torch.cli generate --checkpoint CKPT --prompt "..." [--device cuda]

``generate`` mirrors ``audioldm_tpu.cli generate`` for the text-to-audio
path: DDIM sampling with classifier-free guidance, bf16 UNet and VAE (fp32
with ``--fp32``), fp32 vocoder, 16 kHz wav output, and ``--lora
PATH[:WEIGHT]`` to merge PEFT LoRA adapters into the UNet at load time. The
other options of the JAX CLI belong to later slices of the port and exit
with a message; so does ``train``, whose data layer is not ported (the
trainer itself is: ``audioldm_tpu_torch.train.Trainer``).
"""

from __future__ import annotations

import argparse
import os

# flags of the JAX CLI's generate that this port does not serve yet -> the
# part of the port they wait for
_LATER = {
    "init_audio": "audio-to-audio (VAE encode)",
    "strength": "audio-to-audio (VAE encode)",
    "inpaint": "audio-to-audio (VAE encode)",
    "inpaint_freq": "audio-to-audio (VAE encode)",
    "sample_posterior": "audio-to-audio (VAE encode)",
    "window_seconds": "the extra samplers (MultiDiffusion windows)",
    "guidance_interval": "the extra samplers (limited-interval guidance)",
    "tp": "parallelism",
    "best_of": "CLAP evaluation",
    "clap": "CLAP evaluation",
}


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
    p.add_argument("--scheduler", default="ddim")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--output", default="output.wav")
    p.add_argument("--fp32", action="store_true", help="run the UNet and VAE in fp32 instead of bf16")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu only when asked)")
    for flag in _LATER:
        name = "--" + flag.replace("_", "-")
        if flag == "sample_posterior":
            p.add_argument(name, action="store_true", help=argparse.SUPPRESS)
        else:
            p.add_argument(name, default=None, help=argparse.SUPPRESS)


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


def cmd_generate(args):
    import torch

    from audioldm_tpu_torch.data.tokenizer import load_tokenizer
    from audioldm_tpu_torch.data.wavio import write_wav
    from audioldm_tpu_torch.pipeline.generate import AudioLDMModules, generate

    for flag, part in _LATER.items():
        if getattr(args, flag) not in (None, False):
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported yet: it comes with {part}")
    if args.scheduler != "ddim":
        raise SystemExit(f"--scheduler {args.scheduler} is not ported yet: it comes with the extra samplers")

    modules = AudioLDMModules.from_checkpoint(args.checkpoint, device=args.device)
    if args.lora:
        print(f"merged LoRA: {merge_lora_specs(modules, args.lora, args.lora_alpha)}")
    tokenizer = load_tokenizer(os.path.join(args.checkpoint, "tokenizer"))
    tok = tokenizer([args.prompt] * args.batch)
    unc = tokenizer([args.negative_prompt])
    wav = generate(
        modules, tok["input_ids"], tok["attention_mask"], unc["input_ids"], unc["attention_mask"],
        seed=args.seed, num_inference_steps=args.steps, audio_length_in_s=args.seconds,
        guidance_scale=args.guidance, dtype=torch.float32 if args.fp32 else torch.bfloat16,
        device=args.device,
    ).cpu().numpy()
    sr = modules.vocoder.cfg.sampling_rate
    if args.batch == 1:
        write_wav(args.output, wav[0], sr)
        print(f"wrote {args.output}")
    else:
        stem, ext = os.path.splitext(args.output)
        for i in range(args.batch):
            write_wav(f"{stem}_{i}{ext}", wav[i], sr)
        print(f"wrote {args.batch} clips to {stem}_*{ext}")


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
    sub.add_parser("train", help="LoRA fine-tuning (waits for the data layer)", add_help=False)
    args, rest = parser.parse_known_args(argv)
    if args.command != "train" and rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    {"generate": cmd_generate, "train": cmd_train}[args.command](args)


if __name__ == "__main__":
    main()
