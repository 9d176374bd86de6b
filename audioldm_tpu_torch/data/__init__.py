"""Host-side data layer of the port: the dataset and batched feature
pipeline (``dataset``), its metadata add-ons (``plugins_meta``), the
tokenizer, wav input and output, and the native host-DSP library
(``native``)."""

from audioldm_tpu_torch.data.dataset import AudioCaptionDataset, DataPipeline
from audioldm_tpu_torch.data import plugins_meta  # noqa: F401 - registers the metadata add-ons
from audioldm_tpu_torch.data.tokenizer import RobertaBPETokenizer, load_tokenizer

__all__ = ["AudioCaptionDataset", "DataPipeline", "RobertaBPETokenizer", "load_tokenizer"]
