"""The training step's share of the configuration's peak: the useful FLOPs
of every step in the window (VAE encode, text tower, UNet forward and its
backward to the activations; ``counts/flops.py``) over the window's length,
in percent."""

from portbench.counts import flops


def read(ctx):
    if "steps" not in ctx or ctx["window_s"] <= 0:
        return None
    cfg, mix = ctx["cfg"], ctx["mix"]
    g = flops.groups(cfg)
    per_step = flops.train_step_flops(g["unet"], g["vae"], g["text_encoder"], batch=mix["batch"], mel_t=mix["frames"],
                                      mel_f=cfg["vocoder"]["model_in_dim"])["total"].useful
    return 100.0 * per_step * ctx["steps"] / ctx["window_s"] / cfg["peak_flops"]
