from audioldm_tpu_torch.ckpt.hf_bridge import (
    from_jax_params,
    load_audioldm_checkpoint,
    load_state_dict,
    read_safetensors,
)

__all__ = ["from_jax_params", "load_audioldm_checkpoint", "load_state_dict", "read_safetensors"]
