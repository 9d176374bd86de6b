"""The port's models: UNet, VAE (decode), CLAP text tower, HiFi-GAN vocoder,
DDIM scheduler, and the shared blocks in ``nn``."""
