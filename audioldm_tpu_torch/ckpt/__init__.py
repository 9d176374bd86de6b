from audioldm_tpu_torch.ckpt.hf_bridge import (
    from_jax_params,
    load_audioldm_checkpoint,
    load_state_dict,
    lora_from_jax,
    lora_to_numpy,
    read_safetensors,
    write_safetensors,
)

__all__ = [
    "from_jax_params", "load_audioldm_checkpoint", "load_state_dict", "lora_from_jax", "lora_to_numpy",
    "read_safetensors", "write_safetensors",
]
