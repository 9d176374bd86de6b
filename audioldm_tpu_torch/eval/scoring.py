"""CLAP and KAD scoring of wav folders (port of audioldm_tpu/eval/scoring.py):
a folder of generated wavs against a prompt (a CLAP score a clip) and
against a folder of reference wavs (the corpus' KAD), with the port's two
CLAP towers in fp32 on one device.

Two departures from the JAX package, neither of which changes a number:
- ``embed_audio`` runs the corpus in chunks of at most ``batch_size`` clips
  with no zero padding. The JAX package pads a chunk to a power of two so
  that XLA compiles few programs; eager PyTorch compiles none.
- ``embed_text`` pads to the batch's longest prompt, with no power-of-two
  bucket (padded positions are masked, so a bucket changes nothing) and no
  cap below the text tower's 512 positions.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from audioldm_tpu_torch import resolve_device
from audioldm_tpu_torch.config import ClapAudioConfig, ClapTextConfig, load_hf_config
from audioldm_tpu_torch.data.wavio import read_wav
from audioldm_tpu_torch.eval.clap_features import SR, batch_fused_features
from audioldm_tpu_torch.eval.metrics import clap_similarity, kernel_audio_distance
from audioldm_tpu_torch.models.clap_audio import ClapAudioModelWithProjection
from audioldm_tpu_torch.models.clap_text import ClapTextModelWithProjection
from audioldm_tpu_torch.ops.resample import resample


class ClapScorer:
    """A CLAP model's text and audio towers (eval mode, fp32, on ``device``)
    and its tokenizer."""

    def __init__(self, text_model: ClapTextModelWithProjection, audio_model: ClapAudioModelWithProjection, tokenizer,
                 device="cuda"):
        self.device = resolve_device(device)
        self.text_model = text_model.to(self.device).eval()
        self.audio_model = audio_model.to(self.device).eval()
        self.tokenizer = tokenizer

    @classmethod
    def from_checkpoint(cls, clap_dir: str, device="cuda") -> "ClapScorer":
        """``clap_dir``: an HF-layout CLAP model directory (``ClapModel``
        weights, ``config.json`` with ``text_config`` and ``audio_config``,
        the tokenizer's files), or a directory that holds one as ``clap/``.
        Both towers load with ``strict=True``."""
        from audioldm_tpu_torch.ckpt import load_state_dict, split_clap_state
        from audioldm_tpu_torch.data.tokenizer import load_tokenizer

        device = resolve_device(device)
        sub = os.path.join(clap_dir, "clap")
        if not os.path.exists(os.path.join(clap_dir, "config.json")) and os.path.isdir(sub):
            clap_dir = sub
        cfg = load_hf_config(clap_dir, "")
        text = ClapTextModelWithProjection(ClapTextConfig.from_hf(cfg.get("text_config", {})))
        audio = ClapAudioModelWithProjection(ClapAudioConfig.from_hf(cfg.get("audio_config", {})))
        text_sd, audio_sd = split_clap_state(load_state_dict(clap_dir))
        text.load_state_dict(text_sd, strict=True)
        audio.load_state_dict(audio_sd, strict=True)
        return cls(text, audio, load_tokenizer(clap_dir), device)

    @torch.no_grad()
    def embed_audio(self, waveforms_48k: list[np.ndarray], rng: Optional[np.random.Generator] = None,
                    batch_size: Optional[int] = 16) -> torch.Tensor:
        """L2-normalised audio embeddings ``[N, projection_dim]`` on the
        scorer's device: the fused features on the host (crops drawn from
        ``rng``), then the tower over chunks of at most ``batch_size`` clips
        (``None``: one chunk). Clips are independent, so chunking changes no
        embedding."""
        feats, longer = batch_fused_features(waveforms_48k, rng, device=self.device)
        step = batch_size or feats.shape[0]
        emb = torch.cat([
            self.audio_model(feats[i : i + step], longer[i : i + step])["audio_embeds"]
            for i in range(0, feats.shape[0], step)
        ])
        return emb / torch.linalg.norm(emb, dim=-1, keepdim=True)

    @torch.no_grad()
    def embed_text(self, texts: list[str]) -> torch.Tensor:
        """L2-normalised text embeddings ``[N, projection_dim]``: prompts
        padded to the batch's longest, none truncated below the tower's
        ``max_position_embeddings - 2`` tokens (the reference's
        ``clap_processor(text=..., padding=True)``)."""
        tok = self.tokenizer(texts, max_length=self.text_model.cfg.max_position_embeddings - 2, padding="longest")
        ids = torch.as_tensor(np.asarray(tok["input_ids"]), dtype=torch.long, device=self.device)
        mask = torch.as_tensor(np.asarray(tok["attention_mask"]), dtype=torch.long, device=self.device)
        emb = self.text_model(ids, mask)["text_embeds"]
        return emb / torch.linalg.norm(emb, dim=-1, keepdim=True)

    def clap_scores(self, waveforms_48k: list[np.ndarray], prompt: str) -> np.ndarray:
        """A ``(cos + 1) / 2`` score a clip against one prompt, float32
        numpy ``[N]``."""
        a = self.embed_audio(waveforms_48k)
        t = self.embed_text([prompt])
        return clap_similarity(a, t.expand_as(a)).cpu().numpy()

    def kad(self, ref_48k: list[np.ndarray], gen_48k: list[np.ndarray]) -> float:
        """The corpus KAD of ``gen_48k`` against ``ref_48k`` (the reference's
        ``compute_clap_kad_from_audio_lists``, train_audioldm_lora.py:296-321)."""
        return float(kernel_audio_distance(self.embed_audio(ref_48k), self.embed_audio(gen_48k)))

    def to_48k(self, waveforms, sample_rate: int) -> list[np.ndarray]:
        """Clips at ``sample_rate`` -> float32 numpy clips at 48 kHz,
        resampled on the scorer's device."""
        return [resample(torch.as_tensor(np.asarray(w, np.float32), device=self.device), sample_rate, SR).cpu().numpy()
                for w in waveforms]


def _load_dir_48k(scorer: ClapScorer, folder: str, limit: Optional[int] = None) -> list[np.ndarray]:
    """The folder's ``*.wav`` files in name order (at most ``limit``), mono,
    at 48 kHz. Raises on an empty file or a folder without wavs."""
    out = []
    for name in sorted(os.listdir(folder)):
        if not name.lower().endswith(".wav"):
            continue
        wav, sr = read_wav(os.path.join(folder, name))
        if wav.size == 0:  # would fail far downstream, in the repeat-pad of the features
            raise ValueError(f"empty wav file: {os.path.join(folder, name)}")
        out += scorer.to_48k([wav], sr)
        if limit and len(out) >= limit:
            break
    if not out:
        raise ValueError(f"no .wav files found in {folder}")
    return out


def score_directories(
    clap_dir: str,
    generated_dir: str,
    reference_dir: Optional[str] = None,
    prompt: Optional[str] = None,
    limit: Optional[int] = None,
    device="cuda",
) -> dict:
    """``{"num_generated", "clap_scores", "clap_score_mean"}`` (with a
    prompt) and ``{"num_reference", "kad"}`` (with a reference folder)."""
    scorer = ClapScorer.from_checkpoint(clap_dir, device=device)
    gen = _load_dir_48k(scorer, generated_dir, limit)
    results: dict = {"num_generated": len(gen)}
    if prompt:
        scores = scorer.clap_scores(gen, prompt)
        results["clap_scores"] = [float(s) for s in scores]
        results["clap_score_mean"] = float(np.mean(scores))
    if reference_dir:
        ref = _load_dir_48k(scorer, reference_dir, limit)
        results["num_reference"] = len(ref)
        results["kad"] = scorer.kad(ref, gen)
    return results
