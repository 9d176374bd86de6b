"""Multi-LoRA serving on the card: the adapter bank and the serve engine
(``engine``), the microbatcher and the HTTP daemon (``daemon``)."""

from audioldm_tpu_torch.serve.daemon import GenParams, Microbatcher, make_server
from audioldm_tpu_torch.serve.engine import AdapterBank, ServeEngine

__all__ = ["AdapterBank", "GenParams", "Microbatcher", "ServeEngine", "make_server"]
