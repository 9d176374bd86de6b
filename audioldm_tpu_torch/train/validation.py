"""Validation during training (port of audioldm_tpu/train/validation.py):
generate clips from the validation prompt with the adapters and with the
frozen base, from the same seed, log both as wavs and mel-spectrogram
images, and, given a ``scorer`` (``eval.scoring.ClapScorer``), score both
against the prompt (CLAP) and against a reference corpus (KAD).

Both passes run ``pipeline.generate.generate``: the first with ``lora=`` the
unmerged adapters, the second without.
"""

from __future__ import annotations

import io
from typing import Optional, Sequence

import numpy as np
import torch

from audioldm_tpu_torch.config import LoRAConfig, MelConfig
from audioldm_tpu_torch.pipeline.generate import AudioLDMModules, generate


def spectrogram_image(waveform: np.ndarray, sample_rate: int = 16000) -> bytes:
    """PNG bytes of the clip's log-mel (the port's mel front end, on the
    host), drawn with matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from audioldm_tpu_torch.ops.mel import log_mel_spectrogram

    cfg = MelConfig(sampling_rate=sample_rate, duration=len(waveform) / sample_rate)
    mel = log_mel_spectrogram(torch.from_numpy(np.asarray(waveform, np.float32))[None], cfg)[0].T.numpy()
    fig, ax = plt.subplots(figsize=(10, 4))
    im = ax.imshow(mel, origin="lower", aspect="auto", cmap="viridis")
    fig.colorbar(im, ax=ax, format="%+2.0f")
    ax.set_xlabel("frames")
    ax.set_ylabel("mel bin")
    fig.tight_layout()
    buf = io.BytesIO()
    fig.savefig(buf, format="png")
    plt.close(fig)
    return buf.getvalue()


def _can_draw() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def log_validation(
    modules: AudioLDMModules,
    lora,
    lora_cfg: LoRAConfig,
    tokenizer,
    prompt: str,
    num_clips: int = 5,
    num_inference_steps: int = 50,
    audio_length_in_s: float = 4.0,
    guidance_scale: float = 2.5,
    scorer=None,
    ref_audios_16k: Optional[Sequence[np.ndarray]] = None,
    logger=None,
    step: int = 0,
    seed: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    latents: Optional[torch.Tensor] = None,
    device="cuda",
) -> dict:
    """``{"audios", "original_audios"}`` and, with a ``scorer``,
    ``"clap_score"`` and ``"original_clap_score"`` (the mean CLAP score of
    each pass against ``prompt``) and ``"kad_score_lora"`` and
    ``"kad_score_original"`` (each pass's KAD against ``ref_audios_16k``,
    when that and the passes hold at least 2 clips; else a note is printed);
    the names are the reference's wandb keys. ``num_clips`` clips of ``prompt``
    with the adapters ``lora`` (``LoRAAdapters``, at ``lora_cfg.scale``) and
    the same without them, fp32 numpy ``[num_clips, samples]``. With a
    ``logger``, each clip goes to ``log_audio`` and its mel-spectrogram to
    ``log_image`` (left out, with a note, where matplotlib is missing).

    ``generate`` casts the UNet's and VAE's weights to ``dtype`` in place,
    so a trainer passes its own dtype. ``latents`` (NCHW) replaces the
    seeded init noise of both passes. Runs on ``device`` (default
    ``"cuda"``; it raises without a GPU unless the caller passes ``"cpu"``).
    The clips are resampled to 48 kHz for scoring on the scorer's device."""
    tok, unc = tokenizer([prompt] * num_clips), tokenizer([""])
    args = (modules, tok["input_ids"], tok["attention_mask"], unc["input_ids"], unc["attention_mask"])
    kw = dict(seed=seed, num_inference_steps=num_inference_steps, audio_length_in_s=audio_length_in_s,
              guidance_scale=guidance_scale, dtype=dtype, latents=latents, device=device)
    audios = generate(*args, lora=lora, lora_scale=lora_cfg.scale, **kw).cpu().numpy()
    original = generate(*args, **kw).cpu().numpy()
    if logger is not None:
        sr = modules.vocoder.cfg.sampling_rate
        draw = hasattr(logger, "log_image") and _can_draw()
        if hasattr(logger, "log_image") and not draw:
            print("validation: matplotlib is not installed; no mel-spectrogram images")
        for i in range(num_clips):
            logger.log_audio(f"validation/{i}", audios[i], sr, step)
            logger.log_audio(f"original_validation/{i}", original[i], sr, step)
            if draw:
                logger.log_image(f"validation_mel/{i}", spectrogram_image(audios[i], sr), step)
                logger.log_image(f"original_validation_mel/{i}", spectrogram_image(original[i], sr), step)
    results = {"audios": audios, "original_audios": original}
    if scorer is not None:
        from audioldm_tpu_torch.eval.metrics import clap_similarity, kernel_audio_distance

        sr = modules.vocoder.cfg.sampling_rate
        t_emb = scorer.embed_text([prompt])
        g_emb = scorer.embed_audio(scorer.to_48k(audios, sr))
        o_emb = scorer.embed_audio(scorer.to_48k(original, sr))
        results["clap_score"] = float(clap_similarity(g_emb, t_emb.expand_as(g_emb)).mean())
        results["original_clap_score"] = float(clap_similarity(o_emb, t_emb.expand_as(o_emb)).mean())
        if ref_audios_16k is not None and len(ref_audios_16k) >= 2 and len(audios) >= 2:
            r_emb = scorer.embed_audio(scorer.to_48k(ref_audios_16k, sr))
            results["kad_score_lora"] = float(kernel_audio_distance(r_emb, g_emb))
            results["kad_score_original"] = float(kernel_audio_distance(r_emb, o_emb))
        elif ref_audios_16k is not None:
            # the unbiased estimator needs 2 embeddings a set: skip, rather
            # than end a training run over a small validation set
            print("validation: skipping KAD (needs >= 2 clips per set, got "
                  f"{len(ref_audios_16k)} ref / {len(audios)} generated)")
    return results
