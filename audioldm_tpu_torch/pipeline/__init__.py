"""Generation pipelines of the port: ``pipeline.generate`` (text to audio)."""
