"""Generation pipelines of the port: ``pipeline.generate`` (text to audio,
every sampler) and ``pipeline.audio2audio`` (style transfer and inpainting
from an input clip)."""
