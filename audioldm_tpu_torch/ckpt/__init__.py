from audioldm_tpu_torch.ckpt.hf_bridge import (
    bank_from_jax,
    from_jax_params,
    load_audioldm_checkpoint,
    load_state_dict,
    lora_from_jax,
    lora_to_numpy,
    read_safetensors,
    save_audioldm_checkpoint,
    split_clap_state,
    write_safetensors,
)

__all__ = [
    "bank_from_jax", "from_jax_params", "load_audioldm_checkpoint", "load_state_dict", "lora_from_jax", "lora_to_numpy",
    "read_safetensors", "save_audioldm_checkpoint", "split_clap_state", "write_safetensors",
]
