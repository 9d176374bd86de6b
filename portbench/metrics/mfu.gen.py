"""The whole pipeline's share of the configuration's peak: the useful FLOPs
of every clip in the window (text tower on prompt and empty prompt, the
CFG-folded UNet at every step, VAE decode, vocoder; ``counts/flops.py``)
over the window's length, in percent."""

from portbench.counts import flops


def read(ctx):
    if "clips" not in ctx or ctx["window_s"] <= 0:
        return None
    cfg, mix = ctx["cfg"], ctx["mix"]
    g = flops.groups(cfg)
    hop = 1
    for r in cfg["vocoder"]["upsample_rates"]:
        hop *= r
    factor = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    frames = -(-int(mix["seconds"] * cfg["vocoder"]["sampling_rate"] / hop) // factor) * factor
    per_clip = flops.pipeline_flops(g["unet"], g["vae"], g["vocoder"], g["text_encoder"], steps=mix["steps"], batch=1,
                                    latent_h=frames // factor, latent_w=cfg["vocoder"]["model_in_dim"] // factor)["total"].useful
    return 100.0 * per_clip * ctx["clips"] / ctx["window_s"] / cfg["peak_flops"]
