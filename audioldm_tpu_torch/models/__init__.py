"""The port's models: UNet, VAE (decode), CLAP text tower, HiFi-GAN vocoder,
DDIM scheduler, the CLAP audio tower (HTSAT) that evaluation scores with,
and the shared blocks in ``nn``."""
