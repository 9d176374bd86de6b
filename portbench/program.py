"""The system under test, built from a configuration file and seeded weights.

This is the one module of the harness (with the traffic drivers that call
it) that imports the program, ``audioldm_tpu_torch``; it takes from it only
the entry points a user calls (``ServeEngine``, ``Trainer``), the kernels' launch counters and the kernel build.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from audioldm_tpu_torch import config as pc
from audioldm_tpu_torch.kernels import _build
from audioldm_tpu_torch.kernels import flash_attention as fa
from audioldm_tpu_torch.kernels import mrf_conv
from audioldm_tpu_torch.models.clap_text import ClapTextModelWithProjection
from audioldm_tpu_torch.models.unet import UNet2DConditionModel
from audioldm_tpu_torch.models.vae import AutoencoderKL
from audioldm_tpu_torch.models.vocoder import SpeechT5HifiGan
from audioldm_tpu_torch.pipeline.generate import AudioLDMModules

# the port's CUDA sources that the served and trained paths launch: K1/K3/K4/K5 in bf16 and fp32, K2
SOURCES = ("flash_fwd_sm90", "flash_bwd_sm90", "flash_attention", "flash_attention_bwd", "mrf_conv")


def _dc(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(map(tuple, v)) if k == "resblock_dilation_sizes" else (tuple(v) if isinstance(v, list) else v)
                  for k, v in d.items() if k in names})


def build_kernels(device: torch.device) -> None:
    """Build (or load from the checkout's cache) the kernels, all at once."""
    if device.type == "cuda":
        _build.build_all(SOURCES)


def modules(cfg: dict, state: dict, device: torch.device) -> AudioLDMModules:
    """The program's four models holding the weights of ``state`` (made
    without an initialisation of their own, then given ``state``'s tensors
    as float32, the dtype the models are built in)."""
    with torch.device("meta"):
        mods = AudioLDMModules(
            unet=UNet2DConditionModel(_dc(pc.UNetConfig, cfg["unet"])),
            vae=AutoencoderKL(_dc(pc.VAEConfig, cfg["vae"])),
            text_encoder=ClapTextModelWithProjection(_dc(pc.ClapTextConfig, cfg["text_encoder"])),
            vocoder=SpeechT5HifiGan(_dc(pc.VocoderConfig, cfg["vocoder"])),
            ddim_cfg=_dc(pc.DDIMConfig, cfg["scheduler"]),
        )
    for name in ("unet", "vae", "text_encoder", "vocoder"):
        sd = {k: v.to(device=device, dtype=torch.float32) for k, v in state[name].items()}
        getattr(mods, name).load_state_dict(sd, strict=True, assign=True)
    return mods.eval()


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dtype_of(cfg: dict) -> torch.dtype:
    return {"bf16": torch.bfloat16, "fp32": torch.float32}[cfg["precision"]]


def lora_config(cfg: dict) -> pc.LoRAConfig:
    return _dc(pc.LoRAConfig, cfg["lora"])


def train_config(cfg: dict) -> pc.TrainConfig:
    return _dc(pc.TrainConfig, cfg["train"])


class Tokenizer:
    """The serving engine's tokenizer over a table of token rows: the prompt
    ``"r<k>"`` is row ``k``, the empty prompt is ``<s></s>`` padded."""

    def __init__(self, ids: np.ndarray, mask: np.ndarray, uncond_ids: np.ndarray, uncond_mask: np.ndarray):
        self.ids, self.mask, self.uncond_ids, self.uncond_mask = ids, mask, uncond_ids, uncond_mask
        self.last = threading.local()  # the prompts of this thread's last batch (not the lone empty prompt)

    def __call__(self, texts):
        if list(texts) != [""]:
            self.last.texts = list(texts)
        rows = [int(t[1:]) if t else -1 for t in texts]
        ids = np.stack([self.ids[r] if r >= 0 else self.uncond_ids[0] for r in rows])
        mask = np.stack([self.mask[r] if r >= 0 else self.uncond_mask[0] for r in rows])
        return {"input_ids": ids, "attention_mask": mask}


class LatentCapture:
    """Keeps, by prompt row, what the program hands from one stage to the
    next: the VAE decode's input (``rows``: the sampler's result over the
    scaling factor) and the vocoder's input (``mels``: the decoded log-mel).
    The engine tokenizes a batch's prompts (padded to its bucket) just
    before it runs them in the same thread, so those rows are its prompts."""

    def __init__(self, mods: AudioLDMModules, tokenizer: Tokenizer):
        self.rows: dict = {}
        self.mels: dict = {}
        self._vae, self._decode, self._tok = mods.vae, mods.vae.decode, tokenizer

        def keep(store: dict, x):
            for i, t in enumerate(self._tok.last.texts):
                if t:
                    store[int(t[1:])] = x[i].detach().clone()

        def decode(z):
            keep(self.rows, z)
            return self._decode(z)

        mods.vae.decode = decode
        self._hook = mods.vocoder.register_forward_pre_hook(lambda _m, args: keep(self.mels, args[0]))

    def close(self) -> None:
        self._vae.decode = self._decode
        self._hook.remove()


def launch_counts() -> dict:
    """Every kernel wrapper's launches so far, ``{kernel: Counter(variant)}``."""
    return {
        "K1": fa.flash_attention.launches.copy(), "K6": fa.flash_attention.launches_one.copy(),
        "K3": fa.flash_fwd_lse.launches.copy(), "K4": fa.flash_bwd_dkv.launches.copy(),
        "K5": fa.flash_bwd_dq.launches.copy(), "K2": mrf_conv.mrf_stage.launches.copy(),
    }


def launches_between(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}
