"""Metric logging (port of audioldm_tpu/utils/logging.py).

Scalars (train_loss, total_train_loss, lr, grad_norm, epoch and the
validation metrics), audio clips and mel-spectrogram images, under the
reference's wandb metric names. Always a local ``metrics.jsonl`` stream (a
non-finite value becomes null), wav and png files in the output directory;
wandb and tensorboard only when asked for and importable, each imported
when first needed.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Optional

import numpy as np


class MetricLogger:
    def __init__(
        self,
        output_dir: str,
        project: str = "audioldm-tpu",
        wandb_config: Optional[dict] = None,
        use_wandb: bool = False,
        use_tensorboard: bool = False,
        run_name: Optional[str] = None,
    ):
        os.makedirs(output_dir, exist_ok=True)
        self._dir = output_dir
        self._jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        self._wandb = None
        self._tb = None
        if use_wandb:
            try:
                import wandb

                kw = dict(wandb_config or {})
                self._wandb = wandb.init(project=project, name=run_name, **kw)
            except Exception as e:  # wandb optional / offline
                print(f"[logging] wandb unavailable ({e}); JSONL only")
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(output_dir, "tensorboard"))
            except Exception as e:  # tensorboard optional
                print(f"[logging] tensorboard unavailable ({e}); JSONL only")

    def log(self, metrics: dict, step: int):
        rec = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            if isinstance(v, (int, float, np.floating, np.integer)):
                # JSON has no NaN or Infinity: a bare NaN token would break
                # strict parsers on the whole line; null keeps it valid
                rec[k] = float(v) if math.isfinite(v) else None
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "time") and v is not None:
                    self._tb.add_scalar(k, v, global_step=step)

    def log_audio(self, name: str, waveform: np.ndarray, sample_rate: int, step: int, output_dir: Optional[str] = None):
        """Write a clip as a wav in the output directory (and to wandb and
        tensorboard when on). Returns the file's path."""
        from audioldm_tpu_torch.data.wavio import write_wav

        folder = output_dir or self._dir
        path = os.path.join(folder, f"{name.replace('/', '_')}_step{step}.wav")
        write_wav(path, waveform, sample_rate)
        if self._wandb is not None:
            import wandb

            self._wandb.log({name: wandb.Audio(np.asarray(waveform), sample_rate=sample_rate)}, step=step)
        if self._tb is not None:
            import torch

            self._tb.add_audio(name, torch.from_numpy(np.array(waveform, copy=True))[None], global_step=step, sample_rate=sample_rate)
        return path

    def log_image(self, name: str, png_bytes: bytes, step: int, output_dir: Optional[str] = None):
        """Write PNG bytes to a file in the output directory (and to wandb
        and tensorboard when on). Returns the file's path."""
        folder = output_dir or self._dir
        path = os.path.join(folder, f"{name.replace('/', '_')}_step{step}.png")
        with open(path, "wb") as f:
            f.write(png_bytes)
        decoded = None
        if self._wandb is not None or self._tb is not None:
            try:
                import io

                from PIL import Image

                decoded = np.asarray(Image.open(io.BytesIO(png_bytes)).convert("RGB"))
            except Exception:
                decoded = None
        if decoded is not None and self._wandb is not None:
            import wandb

            self._wandb.log({name: wandb.Image(decoded)}, step=step)
        if decoded is not None and self._tb is not None:
            self._tb.add_image(name, decoded, global_step=step, dataformats="HWC")
        return path

    def close(self):
        self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()
        if self._tb is not None:
            self._tb.close()
