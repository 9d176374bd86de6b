"""Tiny widths of every configuration group and short mixes, so that a
whole cell runs on the CPU in seconds through the same code."""

TEXT = dict(vocab_size=300, hidden_size=16, num_hidden_layers=1, num_attention_heads=2, intermediate_size=32,
            max_position_embeddings=514, projection_dim=8)
UNET = dict(in_channels=4, out_channels=4, block_out_channels=[8, 16], down_block_types=["CrossAttnDownBlock2D", "DownBlock2D"],
            up_block_types=["UpBlock2D", "CrossAttnUpBlock2D"], layers_per_block=1, norm_num_groups=4, attention_head_dim=2,
            projection_class_embeddings_input_dim=8)
VAE = dict(block_out_channels=[8, 16], layers_per_block=1, latent_channels=4, norm_num_groups=4, scaling_factor=0.9)
VOC = dict(model_in_dim=8, upsample_initial_channel=16, upsample_rates=[2, 2], upsample_kernel_sizes=[4, 4])


def config_overrides(cfg: dict) -> dict:
    """The tiny groups over ``cfg``'s own (keys the tiny model leaves alone keep their values)."""
    return {
        "text_encoder": {**cfg["text_encoder"], **TEXT}, "unet": {**cfg["unet"], **UNET},
        "vae": {**cfg["vae"], **VAE}, "vocoder": {**cfg["vocoder"], **VOC},
    }


MIXES = {
    "closed_batches": dict(batch=2, steps=3, seconds=0.04, table_rows=64, check_clips=2),
    "train_steps": dict(batch=4, frames=32, pool=4),
}

# The limits of the tiny cells on the CPU, set as the cells' own are: between the program's readings at these
# widths (seeds 2**31 + 12345, 11, 12: the largest) and the control's (the smallest), nearer the former.
# bf16 generation: latent 7.4e-3 / 0.051, wave 2.5e-3 / 0.018; fp32 generation: latent 3.6e-7 / 4.7e-3,
# mel 6.4e-7 / 8.9e-3; training: loss 2.4e-4 / 1.4e-3 (half batch 0.030), grad 0.024 / 0.14,
# change 0.016 / 0.077; its closing step: grad 0.024 / 0.23, change 9.5e-3 / 0.066.
LIMITS = {
    "bf16.t2a-ddim50-b16": {"latent_rel_l2": 0.02, "wave_rel_l2": 8e-3},
    "fp32.t2a-ddim50-b16": {"latent_rel_l2": 1e-4, "mel_rel_l2": 1e-4},
    "bf16.lora-train-b32": {"loss_rel_gap": 7e-4, "grad_leaf_gap": 0.07, "change_leaf_gap": 0.04,
                            "last_grad_leaf_gap": 0.07, "last_change_leaf_gap": 0.03},
}
