"""Full-geometry HF checkpoint -> ``cli generate`` -> waveform drill of the
port (its half of the repo's ``tools/ckpt_drill.py``).

    python -m audioldm_tpu_torch.tools.ckpt_drill --write --width full|quarter --out DIR [--device cuda] [--seconds 10.24]
    python -m audioldm_tpu_torch.tools.ckpt_drill --out DIR                   # a checkpoint already in DIR

1. With ``--write``, writes an HF-layout audioldm checkpoint into ``--out``
   from random port modules (seed 0) through the port's
   ``save_audioldm_checkpoint``: audioldm-s at full width, or the same block
   graph, latent geometry and head counts at a quarter of the channels
   (UNet 32-160, VAE 32-128, 8 latent channels, vocoder 256). The text tower
   keeps its real 12 x 768 but a 512-row vocabulary, which the byte-level
   tokenizer written beside it covers. The vocoder's biases are zeroed, as
   transformers initialises a HiFi-GAN (random biases, not the mel, would
   set the waveform: two seeds' clips came out 1e-3 apart at a 0.3 peak),
   and its last layer is scaled so that a unit-normal mel comes out at
   about 0.3 (a random HiFi-GAN gives ~1e-4, which int16 output turns into
   silence: agreement on silence proves nothing).
2. Runs ``python -m audioldm_tpu_torch.cli generate --checkpoint DIR
   --steps 2 --seed 0 --device DEVICE`` as a subprocess, the user's
   surface: on the GPU once with ``--fp32`` and once in bf16, on the CPU
   with ``--fp32``.
3. Replays the same trajectory in this process on the CPU in fp32 from the
   CLI's own init latents (``pipeline.generate.row_generator(seed, 0)``):
   from the modules it wrote, or with a checkpoint already in DIR from that
   directory. Its waveform is clipped and quantized to int16 as the CLI's.
   A second replay from seed 1 gives the ``separation``, the max|d| between
   two trajectories.
4. Gates each CLI waveform against the replay: max|d| <= bound, mean|d| <=
   bound / 3, correlation >= 0.999, and that the CLI's waveform survived
   int16 (max >= 0.01, at least 10% of its samples nonzero); each bound
   must lie below the separation.

Bounds are fixed, about 10 times the largest gap the drill has read
(``BOUNDS``, by device type and dtype). Prints one JSON line and exits
nonzero when a gate fails. The independent half, a checkpoint written by
raw torch and transformers in the exact cvssp layout and a trajectory
replayed there, is tests/test_torch_port_ckpt_drill.py.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from audioldm_tpu_torch.config import ClapTextConfig, UNetConfig, VAEConfig, VocoderConfig

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PROMPT, STEPS, GUIDANCE = "hip hop beat with heavy bass", 2, 2.5
# (device type, dtype) -> max|d| bound of the CLI's waveform against the CPU fp32 replay, about 10x the
# largest reading: 1 int16 step (3.05e-5) on the CPU against an independent writer and replay, quarter width;
# on an H100 at full width 3.05e-4 in fp32 (TF32 convolutions) and 4.06e-3 in bf16; another seed's
# trajectory lay 0.10 away at both widths
BOUNDS = {("cpu", "fp32"): 3e-4, ("cuda", "fp32"): 3e-3, ("cuda", "bf16"): 4e-2}
MIN_CORR = 0.999

QUARTER_UNET = UNetConfig(
    in_channels=8, out_channels=8, block_out_channels=(32, 64, 96, 160),
    down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=2, norm_num_groups=32, attention_head_dim=8, projection_class_embeddings_input_dim=512,
    class_embeddings_concat=True,
)
QUARTER_VAE = VAEConfig(in_channels=1, out_channels=1, block_out_channels=(32, 64, 128), layers_per_block=2,
                        latent_channels=8, norm_num_groups=32, scaling_factor=0.9227914214134216)


def geometry(width: str) -> dict:
    """The configs of ``full`` (audioldm-s) or ``quarter`` width."""
    full = width == "full"
    return {"unet_cfg": UNetConfig() if full else QUARTER_UNET, "vae_cfg": VAEConfig() if full else QUARTER_VAE,
            "text_cfg": ClapTextConfig(vocab_size=512),
            "vocoder_cfg": VocoderConfig() if full else VocoderConfig(upsample_initial_channel=256)}


def write_tokenizer(folder: str) -> None:
    """A byte-level vocabulary (``<s> <pad> </s> <unk>`` then the 256
    byte symbols) as ``vocab.json`` and ``merges.txt``."""
    from audioldm_tpu_torch.data.tokenizer import bytes_to_unicode

    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for ch in bytes_to_unicode().values():
        vocab[ch] = len(vocab)
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(folder, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")


def write_checkpoint(out_dir: str, width: str):
    """Random CPU modules of ``width`` (seed 0) with the vocoder's biases
    zeroed and its gain calibrated, written to ``out_dir`` with the
    tokenizer; returns the modules."""
    from audioldm_tpu_torch.ckpt import save_audioldm_checkpoint
    from audioldm_tpu_torch.eval.proximity import calibrate_vocoder_gain
    from audioldm_tpu_torch.pipeline.generate import random_modules

    mods = random_modules(0, device="cpu", **geometry(width))
    with torch.no_grad():  # zero biases, as transformers initialises a HiFi-GAN: else they, not the mel, set the waveform
        for m in mods.vocoder.modules():
            if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)) and m.bias is not None:
                m.bias.zero_()
    calibrate_vocoder_gain(mods, (1, 64, mods.vocoder.cfg.model_in_dim), target=0.3)
    save_audioldm_checkpoint(out_dir, mods)
    write_tokenizer(os.path.join(out_dir, "tokenizer"))
    return mods


def run_cli(ckpt: str, wav_path: str, device: str, fp32: bool, seconds: float) -> float:
    """``cli generate`` as a subprocess; returns its seconds. Raises with
    its output when it fails."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "audioldm_tpu_torch.cli", "generate", "--checkpoint", ckpt, "--prompt", PROMPT,
           "--steps", str(STEPS), "--seconds", str(seconds), "--guidance", str(GUIDANCE), "--seed", "0",
           "--output", wav_path, "--device", device] + (["--fp32"] if fp32 else [])
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cli generate failed (exit {proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    return time.perf_counter() - t0


def cli_init_latents(modules, seed: int, seconds: float) -> torch.Tensor:
    """The init latents of row 0 of ``cli generate --seed seed``."""
    from audioldm_tpu_torch.pipeline.generate import latent_shape, row_generator

    shape = latent_shape(modules, 1, seconds)
    return torch.randn(shape[1:], generator=row_generator(seed, 0))[None]


def replay(modules, ckpt: str, seconds: float, seed: int = 0) -> np.ndarray:
    """The trajectory of ``cli generate --seed seed`` on the CPU in fp32,
    from its init latents."""
    from audioldm_tpu_torch.data.tokenizer import load_tokenizer
    from audioldm_tpu_torch.pipeline.generate import generate

    tok = load_tokenizer(os.path.join(ckpt, "tokenizer"))
    enc, unc = tok([PROMPT]), tok([""])
    wav = generate(modules, enc["input_ids"], enc["attention_mask"], unc["input_ids"], unc["attention_mask"], seed=seed,
                   num_inference_steps=STEPS, audio_length_in_s=seconds, guidance_scale=GUIDANCE, dtype=torch.float32,
                   latents=cli_init_latents(modules, seed, seconds), device="cpu")
    return wav[0].numpy()


def quantize(wav: np.ndarray) -> np.ndarray:
    """What ``read_wav`` gives back of ``wav`` written as an int16 wav file
    by ``write_wav`` (x 32767 in, / 32768 out)."""
    return (np.round(np.clip(wav, -1.0, 1.0) * 32767.0) / 32768.0).astype(np.float32)


def compare(wav_cli: np.ndarray, wav_ref: np.ndarray, bound: float) -> dict:
    """The gates on the CLI's int16 waveform against a reference waveform
    (quantized here): max|d| <= bound, mean|d| <= bound / 3, correlation >=
    ``MIN_CORR``, and not silenced by int16 (max >= 0.01 and at least 10%
    of the samples nonzero)."""
    ref = quantize(np.asarray(wav_ref, np.float32))
    cli = np.asarray(wav_cli, np.float32)
    n = min(len(cli), len(ref))
    diff = np.abs(cli[:n] - ref[:n])
    nonzero = float((cli != 0).mean())
    peak = float(np.abs(cli).max())
    corr = float(np.corrcoef(cli[:n], ref[:n])[0, 1]) if peak > 0 and np.abs(ref).max() > 0 else 0.0
    out = {"samples": int(n), "same_length": len(cli) == len(ref), "max_abs_diff": float(diff.max()),
           "mean_abs_diff": float(diff.mean()), "corr": corr, "cli_max_abs": peak, "cli_nonzero_frac": nonzero,
           "bound": bound, "vacuous": peak < 0.01 or nonzero < 0.10}
    out["pass"] = bool(out["same_length"] and not out["vacuous"] and out["max_abs_diff"] <= bound
                       and out["mean_abs_diff"] <= bound / 3 and corr >= MIN_CORR)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--write", action="store_true", help="write a random checkpoint of --width into --out first")
    ap.add_argument("--width", choices=["full", "quarter"], default="full")
    ap.add_argument("--out", default=None, help="checkpoint dir (with --write: default a temp dir)")
    ap.add_argument("--device", default="cuda", help="device of the CLI runs (default cuda; cpu only when asked)")
    ap.add_argument("--seconds", type=float, default=10.24)
    args = ap.parse_args(argv)
    from audioldm_tpu_torch import resolve_device
    from audioldm_tpu_torch.data.wavio import read_wav
    from audioldm_tpu_torch.pipeline.generate import AudioLDMModules

    dev = resolve_device(args.device).type
    dtypes = [d for t, d in BOUNDS if t == dev]  # the CPU runs fp32 only
    if not args.write and args.out is None:
        raise SystemExit("--out DIR (a checkpoint) is needed without --write")
    out_dir = args.out or tempfile.mkdtemp(prefix="ckpt_drill_")
    result = {"drill": f"{args.width if args.write else 'given'}@{STEPS}steps/{args.seconds}s", "device": dev}
    t0 = time.perf_counter()
    if args.write:
        mods = write_checkpoint(out_dir, args.width)
        result["write_s"] = time.perf_counter() - t0
    else:
        mods = AudioLDMModules.from_checkpoint(out_dir, device="cpu")
    t0 = time.perf_counter()
    ref = replay(mods, out_dir, args.seconds)
    result["replay_s"] = time.perf_counter() - t0
    # how far another trajectory lands: every bound must lie below it, or the gate could not tell them apart
    result["separation"] = float(np.abs(quantize(replay(mods, out_dir, args.seconds, seed=1)) - quantize(ref)).max())
    del mods
    for dtype in dtypes:
        wav_path = os.path.join(out_dir, f"drill_{dtype}.wav")
        cli_s = run_cli(out_dir, wav_path, args.device, dtype == "fp32", args.seconds)
        wav, sr = read_wav(wav_path)
        result[dtype] = {**compare(wav, ref, BOUNDS[(dev, dtype)]), "cli_s": cli_s, "sr": sr}
    result["pass"] = all(result[d]["pass"] and result[d]["bound"] < result["separation"] for d in dtypes)
    print(json.dumps(result), flush=True)
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
