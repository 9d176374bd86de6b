"""Checkpoint I/O for the port.

- ``read_safetensors`` / ``write_safetensors``: a numpy reader and writer
  for ``.safetensors`` files (8-byte little-endian header length, a JSON
  header, then raw little-endian tensor bytes), so neither loading nor the
  trainer's PEFT export needs the ``safetensors`` package.
- ``load_audioldm_checkpoint``: an HF-layout audioldm checkpoint directory
  (unet/ vae/ text_encoder/ vocoder/ scheduler/, as diffusers and the JAX
  package's ``save_audioldm_checkpoint`` write it) -> configs + state dicts
  that load into the port's modules with ``strict=True``.
- ``from_jax_params``: the JAX package's parameter trees (nested dicts of
  arrays) -> the port's state dicts, mirroring its ``export_*_state``:
  NHWC/HWIO/WIO kernels and [in, out] linears go to torch layouts and the
  renamed module paths go back to the diffusers names.
- ``lora_from_jax`` / ``lora_to_numpy``: the JAX package's adapter pytree
  (nested dicts, list indices as string keys, leaves ``a [in, r]`` and
  ``b [r, out]``) <-> the port's ``LoRAAdapters``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from audioldm_tpu_torch.lora.adapter import LoRAAdapters
from audioldm_tpu_torch.config import (
    ClapTextConfig,
    DDIMConfig,
    UNetConfig,
    VAEConfig,
    VocoderConfig,
    load_hf_config,
)

_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "BF16": np.uint16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
}


def read_safetensors(path: str) -> dict:
    """``{name: torch.Tensor}`` from a safetensors file (CPU tensors)."""
    with open(path, "rb") as f:
        raw = f.read()
    n = int.from_bytes(raw[:8], "little")
    header = json.loads(raw[8 : 8 + n])
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        arr = np.frombuffer(raw, dtype=np.dtype(_ST_DTYPES[info["dtype"]]).newbyteorder("<"),
                            count=(end - start) // np.dtype(_ST_DTYPES[info["dtype"]]).itemsize,
                            offset=base + start).reshape(info["shape"])
        t = torch.from_numpy(arr.astype(arr.dtype.newbyteorder("="), copy=True))
        out[name] = t.view(torch.bfloat16) if info["dtype"] == "BF16" else t
    return out


def write_safetensors(path: str, tensors: dict) -> None:
    """Write ``{name: torch.Tensor}`` (any device; contiguous copies are
    made) as a safetensors file."""
    names = {v: k for k, v in _ST_DTYPES.items()}
    header, chunks, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            code, arr = "BF16", t.view(torch.int16).numpy()
        else:
            arr = t.numpy()
            code = names[arr.dtype.type]
        data = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": code, "shape": list(t.shape), "data_offsets": [offset, offset + len(data)]}
        chunks.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for data in chunks:
            f.write(data)


def load_state_dict(folder: str) -> dict:
    """The first weights file found in a checkpoint subfolder, without the
    index buffers (position/token-type ids, batch-norm counters) that
    transformers may save and the port does not keep."""
    for name in (
        "diffusion_pytorch_model.safetensors", "model.safetensors", "pytorch_model.safetensors",
        "diffusion_pytorch_model.bin", "pytorch_model.bin",
    ):
        p = os.path.join(folder, name)
        if os.path.exists(p):
            sd = read_safetensors(p) if p.endswith(".safetensors") else torch.load(p, map_location="cpu", weights_only=True)
            return {k: v for k, v in sd.items() if not k.endswith(("position_ids", "token_type_ids", "num_batches_tracked"))}
    raise FileNotFoundError(f"no weights file under {folder}")


# legacy diffusers VAE attention names -> current ones
_VAE_LEGACY = [(".query.", ".to_q."), (".key.", ".to_k."), (".value.", ".to_v."), (".proj_attn.", ".to_out.0.")]


def _vae_qkv_bias(sd: dict) -> dict:
    """diffusers' VAE attention has biased q/k/v; a checkpoint written
    without those biases (as the JAX package's initialiser makes them)
    means zero biases."""
    for key in [k for k in sd if k.endswith((".to_q.weight", ".to_k.weight", ".to_v.weight"))]:
        bias = key[: -len("weight")] + "bias"
        if bias not in sd:
            sd[bias] = torch.zeros(sd[key].shape[0], dtype=sd[key].dtype)
    return sd


def load_audioldm_checkpoint(checkpoint_dir: str) -> dict:
    """``{"configs": {...}, "state_dicts": {...}}`` keyed by
    unet / vae / text_encoder / vocoder (+ "scheduler" config)."""
    configs = {
        "unet": UNetConfig.from_hf(load_hf_config(checkpoint_dir, "unet")),
        "vae": VAEConfig.from_hf(load_hf_config(checkpoint_dir, "vae")),
        "text_encoder": ClapTextConfig.from_hf(load_hf_config(checkpoint_dir, "text_encoder")),
        "vocoder": VocoderConfig.from_hf(load_hf_config(checkpoint_dir, "vocoder")),
        "scheduler": DDIMConfig.from_hf(load_hf_config(checkpoint_dir, "scheduler")),
    }
    sds = {name: load_state_dict(os.path.join(checkpoint_dir, name)) for name in ("unet", "vae", "text_encoder", "vocoder")}
    vae = {}
    for k, v in sds["vae"].items():
        for old, new in _VAE_LEGACY:
            k = k.replace(old, new)
        vae[k] = v
    sds["vae"] = _vae_qkv_bias(vae)
    return {"configs": configs, "state_dicts": sds}


# JAX param-path renames (its ckpt bridge's rules, applied backwards)
_UNET_RULES = [
    ("to_out", "to_out.0"),
    ("ff.geglu", "ff.net.0.proj"),
    ("ff.out", "ff.net.2"),
    ("downsamplers.0", "downsamplers.0.conv"),
    ("upsamplers.0", "upsamplers.0.conv"),
]


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v, dtype=np.float32)
    return out


def _jax_tree_to_state(tree: dict, rules, conv_transpose_prefix: str | None = None) -> dict:
    sd = {}
    for key, v in _flatten(tree).items():
        parts = key.split(".")
        leaf, module = parts[-1], ".".join(parts[:-1])
        for old, new in rules:
            module = module.replace(old, new)
        if leaf == "kernel":
            if v.ndim == 4:  # HWIO -> OIHW
                v = v.transpose(3, 2, 0, 1)
            elif v.ndim == 3:
                if conv_transpose_prefix and module.startswith(conv_transpose_prefix):
                    v = v.transpose(1, 2, 0)  # WIO -> ConvTranspose1d [in, out, W]
                else:
                    v = v.transpose(2, 1, 0)  # WIO -> Conv1d OIW
            elif v.ndim == 2:
                v = v.T  # [in, out] -> Linear [out, in]
            name = f"{module}.weight"
        elif leaf in ("scale", "mean") and not module:
            name = leaf  # the vocoder's top-level normalisation buffers
        elif leaf in ("scale", "embedding"):
            name = f"{module}.weight"
        else:
            name = f"{module}.{leaf}"
        sd[name] = torch.tensor(np.ascontiguousarray(v))
    return sd


def from_jax_params(unet=None, vae=None, text_encoder=None, vocoder=None) -> dict:
    """JAX parameter trees -> ``{name: state_dict}`` for the given models."""
    out = {}
    if unet is not None:
        out["unet"] = _jax_tree_to_state(unet, _UNET_RULES)
    if vae is not None:
        out["vae"] = _vae_qkv_bias(_jax_tree_to_state(vae, _UNET_RULES))
    if text_encoder is not None:
        out["text_encoder"] = _jax_tree_to_state(text_encoder, [])
    if vocoder is not None:
        out["vocoder"] = _jax_tree_to_state(vocoder, [], conv_transpose_prefix="upsampler.")
    return out


def lora_from_jax(tree: dict) -> LoRAAdapters:
    """The JAX adapter pytree (arrays or numpy) -> ``LoRAAdapters``. The
    layouts agree (``a [in, r]``, ``b [r, out]``); only the nesting becomes a
    dotted module path."""
    tensors = {}

    def walk(node: dict, path: list):
        for k, v in node.items():
            if isinstance(v, dict) and "a" in v and "b" in v:
                tensors[".".join(path + [str(k)])] = tuple(
                    torch.tensor(np.asarray(v[x], dtype=np.float32)) for x in ("a", "b"))
            elif isinstance(v, dict):
                walk(v, path + [str(k)])

    walk(tree, [])
    return LoRAAdapters(tensors)


def bank_from_jax(stacked: dict, names: dict, rank: int, max_capacity=None, device="cuda"):
    """A JAX ``AdapterBank``'s ``stacked`` tree (numpy leaves ``a [capacity,
    in, r]``, ``b [capacity, r, out]``) and ``names`` -> the port's
    ``serve.engine.AdapterBank``, slot for slot (``AdapterBank.from_stacked``),
    so that both gather the same rows."""
    from audioldm_tpu_torch.serve.engine import AdapterBank

    stacked = {p: (a.detach(), b.detach()) for p, a, b in lora_from_jax(stacked).items()}
    return AdapterBank.from_stacked(stacked, names, rank, max_capacity=max_capacity, device=device)


def lora_to_numpy(lora: LoRAAdapters) -> dict:
    """``LoRAAdapters`` -> the JAX
    package's nested adapter tree with numpy leaves."""
    tree: dict = {}
    for path, a, b in lora.items():
        node = tree
        for k in path.split("."):
            node = node.setdefault(k, {})
        node["a"], node["b"] = a.detach().cpu().numpy(), b.detach().cpu().numpy()
    return tree
