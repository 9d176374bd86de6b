"""Evaluation of the port: the CLAP and KAD metrics (``eval.metrics``), the
CLAP features (``eval.clap_features``), the scorer of wav folders
(``eval.scoring``), and ``eval.proximity`` (how close two sampling paths'
outputs stay, and the vocoder gain calibration that gauge needs)."""

from audioldm_tpu_torch.eval.metrics import clap_similarity, kernel_audio_distance, median_pairwise_distance

__all__ = ["clap_similarity", "kernel_audio_distance", "median_pairwise_distance"]
