"""Evaluation helpers of the port: ``eval.proximity`` (how close two sampling
paths' outputs stay, and the vocoder gain calibration that gauge needs)."""
