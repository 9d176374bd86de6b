from audioldm_tpu_torch.lora.adapter import (
    LoRAAdapters,
    compose_adapters,
    export_peft_state_dict,
    import_peft_state_dict,
    init_lora,
    iter_lora_paths,
    merge_lora,
    unmerge_lora,
)

__all__ = [
    "LoRAAdapters",
    "compose_adapters",
    "export_peft_state_dict",
    "import_peft_state_dict",
    "init_lora",
    "iter_lora_paths",
    "merge_lora",
    "unmerge_lora",
]
