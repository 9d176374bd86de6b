"""Typed model configuration for the PyTorch port.

The port's own copy of the configs the text-to-audio and LoRA training paths
need (UNet, VAE, CLAP text tower, HiFi-GAN vocoder, DDIM schedule, LoRA and
trainer hyperparameters). The fields mirror the
HuggingFace ``config.json`` schemas of ``cvssp/audioldm-s-full-v2``, so a
checkpoint directory's subfolder configs build the models directly; the
defaults are the audioldm-s values. ``from_hf`` refuses keys that would
select an architecture variant this port does not implement.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Optional, Sequence


def _freeze(x):
    if isinstance(x, list):
        return tuple(_freeze(v) for v in x)
    return x


class UnsupportedConfigError(ValueError):
    """A checkpoint config requests an architecture variant the port does not
    implement: fail at load time instead of building the wrong model."""


def _check_hf(name: str, d: dict, known: set, ignored: set, fixed: dict):
    """Keys must be a dataclass field, ignorable metadata, or a ``fixed`` key
    whose value is one of the implemented variants."""
    for k, v in d.items():
        if k in known or k in ignored:
            continue
        if k in fixed:
            if not any((a is None and v is None) or v == a for a in fixed[k]):
                raise UnsupportedConfigError(
                    f"{name}: config key {k}={v!r} requests an unimplemented "
                    f"variant (supported: {fixed[k]})"
                )
            continue
        raise UnsupportedConfigError(
            f"{name}: unknown config key {k!r} — refusing to silently drop a "
            "key that may affect the architecture"
        )


_HF_META = {"_class_name", "_diffusers_version", "_name_or_path", "transformers_version", "model_type", "architectures", "torch_dtype"}


def _fields(cls) -> set:
    return {f.name for f in dataclasses.fields(cls)}


@dataclass(frozen=True)
class DDIMConfig:
    """diffusers ``DDIMScheduler`` config (scaled-linear betas, leading
    timestep spacing, epsilon prediction)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.0015
    beta_end: float = 0.0195
    beta_schedule: str = "scaled_linear"
    clip_sample: bool = False
    set_alpha_to_one: bool = False
    steps_offset: int = 1
    prediction_type: str = "epsilon"
    timestep_spacing: str = "leading"

    @classmethod
    def from_hf(cls, d: dict) -> "DDIMConfig":
        keys = _fields(cls)
        _check_hf(
            "DDIMScheduler", d, keys,
            ignored=_HF_META | {"dynamic_thresholding_ratio", "sample_max_value"},
            fixed={
                "trained_betas": (None,),
                "thresholding": (False,),
                "rescale_betas_zero_snr": (False,),
                "clip_sample_range": (1.0, None),
                "skip_prk_steps": (True, False),
            },
        )
        return cls(**{k: _freeze(v) for k, v in d.items() if k in keys})


@dataclass(frozen=True)
class UNetConfig:
    """diffusers ``UNet2DConditionModel`` config as audioldm-s uses it: the
    pooled CLAP embedding enters through the class-embedding path and, with
    ``cross_attention_dim=None``, attn2 self-attends."""

    sample_size: int = 64
    in_channels: int = 8
    out_channels: int = 8
    down_block_types: Sequence[str] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Sequence[str] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    block_out_channels: Sequence[int] = (128, 256, 384, 640)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    act_fn: str = "silu"
    attention_head_dim: Any = 8  # diffusers legacy: this is the head *count*
    cross_attention_dim: Optional[int] = None  # None -> attn2 self-attends
    class_embed_type: Optional[str] = "simple_projection"
    projection_class_embeddings_input_dim: int = 512
    class_embeddings_concat: bool = True
    freq_shift: int = 0
    flip_sin_to_cos: bool = True
    downsample_padding: int = 1
    mid_block_scale_factor: float = 1.0
    use_linear_projection: bool = False
    transformer_layers_per_block: int = 1

    @classmethod
    def from_hf(cls, d: dict) -> "UNetConfig":
        keys = _fields(cls)
        _check_hf(
            "UNet2DConditionModel", d, keys,
            ignored=_HF_META | {"dropout", "addition_embed_type_num_heads", "attention_legacy_order"},
            fixed={
                "center_input_sample": (False,),
                "dual_cross_attention": (False,),
                "only_cross_attention": (False,),
                "time_embedding_type": ("positional",),
                "resnet_time_scale_shift": ("default",),
                "resnet_skip_time_act": (False,),
                "resnet_out_scale_factor": (1.0,),
                "conv_in_kernel": (3,),
                "conv_out_kernel": (3,),
                "attention_type": ("default",),
                "addition_embed_type": (None,),
                "addition_time_embed_dim": (None,),
                "encoder_hid_dim": (None,),
                "encoder_hid_dim_type": (None,),
                "time_embedding_dim": (None,),
                "time_embedding_act_fn": (None,),
                "timestep_post_act": (None,),
                "time_cond_proj_dim": (None,),
                "num_class_embeds": (None,),
                "num_attention_heads": (None,),
                "upcast_attention": (False, True, None),
                "reverse_transformer_layers_per_block": (None,),
                "mid_block_type": ("UNetMidBlock2DCrossAttn",),
                "mid_block_only_cross_attention": (None, False),
                "cross_attention_norm": (None,),
                "class_embeddings_concat": (True, False),
            },
        )
        cfg = cls(**{k: _freeze(v) for k, v in d.items() if k in keys})
        bad = set(cfg.down_block_types) - {"CrossAttnDownBlock2D", "DownBlock2D"}
        bad |= set(cfg.up_block_types) - {"CrossAttnUpBlock2D", "UpBlock2D"}
        if bad:
            raise UnsupportedConfigError(f"UNet2DConditionModel: unimplemented blocks {sorted(bad)}")
        if cfg.use_linear_projection:
            raise UnsupportedConfigError("UNet2DConditionModel: use_linear_projection=True not implemented")
        if cfg.class_embed_type not in (None, "simple_projection"):
            raise UnsupportedConfigError(f"UNet2DConditionModel: class_embed_type={cfg.class_embed_type!r} not implemented")
        tl = cfg.transformer_layers_per_block
        if isinstance(tl, (tuple, list)):
            if len(set(tl)) != 1:
                raise UnsupportedConfigError("UNet2DConditionModel: non-uniform transformer_layers_per_block not implemented")
            cfg = dataclasses.replace(cfg, transformer_layers_per_block=int(tl[0]))
        return cfg

    def num_heads(self, level: int) -> int:
        """Head count at down-block level ``level`` (diffusers' legacy
        ``attention_head_dim`` is the head COUNT)."""
        ahd = self.attention_head_dim
        if isinstance(ahd, (tuple, list)):
            return int(ahd[level])
        return int(ahd)


@dataclass(frozen=True)
class VAEConfig:
    """diffusers ``AutoencoderKL`` config: a 1024x64 log-mel maps to
    [8, 256, 16] latents for 10.24 s."""

    in_channels: int = 1
    out_channels: int = 1
    down_block_types: Sequence[str] = ("DownEncoderBlock2D",) * 3
    up_block_types: Sequence[str] = ("UpDecoderBlock2D",) * 3
    block_out_channels: Sequence[int] = (128, 256, 512)
    layers_per_block: int = 2
    latent_channels: int = 8
    norm_num_groups: int = 32
    act_fn: str = "silu"
    scaling_factor: float = 0.9227914214134216
    sample_size: int = 512

    @classmethod
    def from_hf(cls, d: dict) -> "VAEConfig":
        keys = _fields(cls)
        _check_hf(
            "AutoencoderKL", d, keys,
            ignored=_HF_META | {"force_upcast"},
            fixed={
                "use_quant_conv": (True,),
                "use_post_quant_conv": (True,),
                "shift_factor": (None,),
                "latents_mean": (None,),
                "latents_std": (None,),
                "mid_block_add_attention": (True,),
                "norm_eps": (1e-6,),
            },
        )
        cfg = cls(**{k: _freeze(v) for k, v in d.items() if k in keys})
        bad = (set(cfg.down_block_types) - {"DownEncoderBlock2D"}) | (set(cfg.up_block_types) - {"UpDecoderBlock2D"})
        if bad:
            raise UnsupportedConfigError(f"AutoencoderKL: unimplemented blocks {sorted(bad)}")
        return cfg


@dataclass(frozen=True)
class ClapTextConfig:
    """CLAP text tower: RoBERTa encoder + 2-layer MLP projection
    (transformers ``ClapTextModelWithProjection``)."""

    vocab_size: int = 50265
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 1
    bos_token_id: int = 0
    eos_token_id: int = 2
    projection_dim: int = 512
    projection_hidden_act: str = "relu"

    @classmethod
    def from_hf(cls, d: dict) -> "ClapTextConfig":
        keys = _fields(cls)
        return cls(**{k: _freeze(v) for k, v in d.items() if k in keys})


@dataclass(frozen=True)
class VocoderConfig:
    """transformers ``SpeechT5HifiGan`` config: mel [B, T, 64] -> 16 kHz
    waveform, hop 160 = prod(upsample_rates)."""

    model_in_dim: int = 64
    sampling_rate: int = 16000
    upsample_initial_channel: int = 1024
    upsample_rates: Sequence[int] = (5, 4, 2, 2, 2)
    upsample_kernel_sizes: Sequence[int] = (16, 16, 8, 4, 4)
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    leaky_relu_slope: float = 0.1
    normalize_before: bool = True

    @classmethod
    def from_hf(cls, d: dict) -> "VocoderConfig":
        keys = _fields(cls)
        return cls(**{k: _freeze(v) for k, v in d.items() if k in keys})


@dataclass(frozen=True)
class MelConfig:
    """STFT/mel front end of the reference's data path: filter 1024, hop 160,
    window 1024, 64 mels, 16 kHz, 0-8000 Hz, 10.24 s -> 1024 frames."""

    sampling_rate: int = 16000
    filter_length: int = 1024
    hop_length: int = 160
    win_length: int = 1024
    n_mel: int = 64
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0
    duration: float = 10.24
    # exact frame count: when set it is ``target_length``, which otherwise
    # comes from the float duration, whose int() can land one frame short
    target_frames: Optional[int] = None

    @property
    def target_length(self) -> int:
        if self.target_frames is not None:
            return self.target_frames
        return int(self.duration * self.sampling_rate / self.hop_length)

    @property
    def num_samples(self) -> int:
        return int(self.duration * self.sampling_rate)


@dataclass(frozen=True)
class LoRAConfig:
    """LoRA adapter config (peft ``LoraConfig``): rank, alpha, A's init and
    the attention projections that get adapters."""

    r: int = 2
    lora_alpha: float = 2.0
    init_lora_weights: str = "gaussian"
    target_modules: Sequence[str] = ("to_q", "to_v")

    @property
    def scale(self) -> float:
        return float(self.lora_alpha) / float(self.r)


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters: batch 2, AdamW lr 1e-5 betas (0.9, 0.999)
    weight decay 1e-5 eps 1e-8, polynomial decay, global-norm clip 1.0."""

    num_workers: int = 4
    train_batch_size: int = 2
    num_train_epochs: int = 1000
    max_train_steps: int = 97000
    checkpointing_steps: int = 19400
    gradient_accumulation_steps: int = 1
    learning_rate: float = 1.0e-5
    weight_decay: float = 1.0e-5
    betas: Sequence[float] = (0.9, 0.999)
    eps: float = 1.0e-8
    lr_scheduler: str = "polynomial"
    lr_warmup_steps: int = 0
    max_grad_norm: float = 1.0
    seed: int = 0
    mixed_precision: Optional[str] = "bfloat16"


def load_hf_config(checkpoint_dir: str, subfolder: str) -> dict:
    """Read a HuggingFace-style ``config.json`` (or scheduler_config.json)
    from a local checkpoint directory."""
    folder = os.path.join(checkpoint_dir, subfolder)
    for name in ("config.json", "scheduler_config.json"):
        p = os.path.join(folder, name)
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
    raise FileNotFoundError(f"no config json under {folder}")
