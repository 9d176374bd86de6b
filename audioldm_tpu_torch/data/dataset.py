"""Dataset ingestion and the batched feature pipeline (port of
audioldm_tpu/data/dataset.py).

Per item, on the host: a random 10.24 s segment (up to 10 draws past
silence), resample to 16 kHz, normalise (mean-centre, peak to 0.5), zero-pad
to 163 840 samples; per batch, on the device: STFT, log-mel ``[B, 1, 1024,
64]`` and the SpecAugment masks; the captions RoBERTa-tokenised, padded to
the smallest multiple of 64 that holds the batch's longest. Plugin add-ons,
selected by name, add fields to the batch.

Host-side randomness is a seeded ``numpy.random.Generator``, drawn in the
JAX package's order, so one seed gives the same segments, permutation and
masks in both packages. The log-mel is NCHW ``[B, 1, T, F]``, the layout the
port's trainer reads (the JAX package emits NHWC ``[B, T, F, 1]``). The
DSP add-ons live here (48 kHz waveform, relative bandwidth, bandwidth
channel, Kaldi fbank); the metadata add-ons are in ``data/plugins_meta.py``.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from audioldm_tpu_torch import resolve_device
from audioldm_tpu_torch.config import MelConfig
from audioldm_tpu_torch.data.wavio import read_wav
from audioldm_tpu_torch.ops.mel import log_mel_spectrogram, normalize_wav, pad_wav
from audioldm_tpu_torch.ops.resample import resample, resample_np

# ---------------------------------------------------------------------------
# Plugin registry: add-on name -> fn(item, mel_cfg) -> dict of new fields
# ---------------------------------------------------------------------------

PLUGINS: dict[str, Callable] = {}


def register_plugin(name: str):
    def deco(fn):
        PLUGINS[name] = fn
        return fn

    return deco


@register_plugin("waveform_rs_48k")
def waveform_rs_48k(item: dict, cfg: MelConfig) -> dict:
    """The clip resampled to 48 kHz (on the host)."""
    wav = torch.from_numpy(np.asarray(item["waveform"], np.float32))
    return {"waveform_48k": resample(wav, cfg.sampling_rate, 48000).numpy()}


@register_plugin("calculate_relative_bandwidth")
def calculate_relative_bandwidth(item: dict, cfg: MelConfig) -> dict:
    """The 5th and 95th percentile frequency bins of the STFT energy, scaled
    to [0, 1000)."""
    stft = np.asarray(item["stft"])  # [T, F]
    freq_dim = stft.shape[-1]
    dist = np.cumsum(stft.sum(axis=0))
    total = dist[-1]
    lower = int(np.argmin(np.abs(total * 0.05 - dist)))
    higher = int(np.argmin(np.abs(total * 0.95 - dist)))
    return {"freq_energy_percentile": np.asarray([int(lower / freq_dim * 1000), int(higher / freq_dim * 1000)], np.int64)}


@register_plugin("calculate_mel_spec_relative_bandwidth_as_extra_channel")
def mel_bandwidth_extra_channel(
    item: dict, cfg: MelConfig, latent_t_size: Optional[int] = None, latent_f_size: Optional[int] = None,
) -> dict:
    """A band mask on the latent grid (the mel geometry over the VAE's 4x
    downsampling by default) between the mel energy's 5th and 95th
    percentile bins."""
    if latent_t_size is None:
        latent_t_size = cfg.target_length // 4
    if latent_f_size is None:
        latent_f_size = cfg.n_mel // 4
    mel = np.exp(np.clip(np.asarray(item["log_mel_spec"]), None, 10))
    freq_dim = mel.shape[-1]
    dist = np.cumsum(mel.sum(axis=0))
    total = dist[-1]
    lower = int(latent_f_size * (np.argmin(np.abs(total * 0.05 - dist)) / freq_dim))
    higher = int(latent_f_size * (np.argmin(np.abs(total * 0.95 - dist)) / freq_dim))
    mask = np.zeros((latent_t_size, latent_f_size), np.float32)
    mask[:, lower:higher] = 1.0
    return {"mel_spec_bandwidth_cond_extra_channel": mask, "freq_energy_percentile": np.asarray([lower, higher], np.int64)}


_KALDI_NORM_MEAN = -4.2677393
_KALDI_NORM_STD = 4.5689974


def _kaldi_plugin(item: dict, cfg: MelConfig, target_sr: int) -> dict:
    """Resample to ``target_sr`` -> mean-subtract -> 128-bin Kaldi fbank ->
    pad or crop to the mel target length -> (x - mean) / (2 std)."""
    from audioldm_tpu_torch.ops.kaldi import kaldi_fbank

    wav = np.asarray(item["waveform"], np.float32)
    if cfg.sampling_rate != target_sr:
        wav = resample(torch.from_numpy(wav), cfg.sampling_rate, target_sr).numpy()
    wav = wav - wav.mean()
    fbank = kaldi_fbank(wav, sample_frequency=float(target_sr), num_mel_bins=128)
    p = cfg.target_length - fbank.shape[0]
    if p > 0:
        fbank = np.pad(fbank, ((0, p), (0, 0)))
    elif p < 0:
        fbank = fbank[: cfg.target_length]
    fbank = (fbank - _KALDI_NORM_MEAN) / (_KALDI_NORM_STD * 2)
    return {"ta_kaldi_fbank": fbank.astype(np.float32)}


@register_plugin("extract_kaldi_fbank_feature")
def extract_fbank(item: dict, cfg: MelConfig) -> dict:
    """128-bin Kaldi log filterbank at 16 kHz."""
    return _kaldi_plugin(item, cfg, 16000)


@register_plugin("extract_kaldi_fbank_feature_32k")
def extract_fbank_32k(item: dict, cfg: MelConfig) -> dict:
    """128-bin Kaldi log filterbank at 32 kHz."""
    return _kaldi_plugin(item, cfg, 32000)


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------


class AudioCaptionDataset:
    """An index-lazy view of (waveform, sample rate, caption) triples from a
    map-style HuggingFace dataset (rows with ``audio.array``,
    ``audio.sampling_rate``, ``caption``), a list of dicts (``wav`` and
    ``sr``, or ``path``; ``caption``; ``metadata``), or a directory of
    ``*.wav`` with same-stem ``*.txt`` captions and optional ``*.json``
    metadata. Construction decodes nothing; ``get_raw`` decodes one item. An
    HF row is kept for the next access, so ``get_raw(i)`` and
    ``get_metadata(i)`` decode it once."""

    def __init__(self, source):
        self.items: Optional[list[dict]] = None
        self._hf = None
        self._dir = None
        if isinstance(source, str):
            self._dir = source
            self._stems = [os.path.splitext(n)[0] for n in sorted(os.listdir(source)) if n.endswith(".wav")]
        elif hasattr(source, "features"):  # a HF dataset
            if not hasattr(source, "__getitem__") or not hasattr(source, "__len__"):
                raise ValueError(
                    "HF dataset source must be indexable (map-style); for a streaming IterableDataset, "
                    "materialize a split first"
                )
            self._hf = source
            self._hf_memo: tuple[int, dict] | None = None
        elif isinstance(source, (list, tuple)):
            self.items = list(source)
        else:
            raise ValueError(f"unsupported dataset source: {type(source)}")

    def __len__(self) -> int:
        if self.items is not None:
            return len(self.items)
        if self._hf is not None:
            return len(self._hf)
        return len(self._stems)

    def get_raw(self, i: int) -> tuple[np.ndarray, int, str]:
        """Decode item ``i``: (waveform float32, sample rate, caption)."""
        if self._dir is not None:
            stem = self._stems[i]
            wav, sr = read_wav(os.path.join(self._dir, stem + ".wav"))
            cap_path = os.path.join(self._dir, stem + ".txt")
            caption = ""
            if os.path.exists(cap_path):
                with open(cap_path) as f:
                    caption = f.read().strip()
            return wav, sr, caption
        if self._hf is not None:
            item = self._hf_row(int(i))
            return np.asarray(item["audio"]["array"], np.float32), int(item["audio"]["sampling_rate"]), item.get("caption", "")
        item = self.items[i]
        if "path" in item:
            wav, sr = read_wav(item["path"])
        else:
            wav, sr = np.asarray(item["wav"], np.float32), item["sr"]
        return wav, sr, item.get("caption", "")

    def get_metadata(self, i: int) -> dict:
        """Item ``i``'s metadata (phonemes, beats, labels); a directory
        source reads the same-stem ``.json``."""
        if self._dir is not None:
            meta_path = os.path.join(self._dir, self._stems[i] + ".json")
            if os.path.exists(meta_path):
                import json

                with open(meta_path) as f:
                    return json.load(f)
            return {}
        if self._hf is not None:
            return self._hf_row(int(i)).get("metadata", {}) or {}
        return self.items[i].get("metadata", {}) or {}

    def _hf_row(self, i: int) -> dict:
        if self._hf_memo is not None and self._hf_memo[0] == i:
            return self._hf_memo[1]
        item = self._hf[i]
        self._hf_memo = (i, item)
        return item


def random_segment(wav: np.ndarray, target: int, rng: np.random.Generator, retries: int = 10) -> tuple[np.ndarray, int]:
    """A random ``target``-sample segment and its start; up to ``retries``
    draws until one is not silent (peak > 1e-4). Clips no longer than
    ``target`` come back whole from 0."""
    n = wav.shape[-1]
    if n <= target:
        return wav, 0
    start = 0
    for _ in range(retries):
        start = int(rng.uniform(0, n - target))
        if np.max(np.abs(wav[start : start + target])) > 1e-4:
            break
    return wav[start : start + target], start


def _draw_mask_params(dim: int, max_len: int, batch: int, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """One (start, length) a batch item for a SpecAugment mask: length
    uniform in [max_len / 8, max_len), start uniform over what is left."""
    lens = rng.uniform(max_len // 8, max_len, size=batch).astype(np.int32)
    starts = np.stack([rng.uniform(0, max(dim - int(n), 1)) for n in lens]).astype(np.int32)
    return starts, lens


def _apply_masks(log_mel: torch.Tensor, f_start, f_len, t_start, t_len) -> torch.Tensor:
    """Per-item frequency and time masks over ``[B, T, F]`` on its device
    (item i's mask covers ``[start_i, start_i + len_i)``; length 0 is none)."""
    dev = log_mel.device
    f_start, f_len, t_start, t_len = (torch.as_tensor(np.asarray(a), device=dev)[:, None] for a in (f_start, f_len, t_start, t_len))
    _, t, f = log_mel.shape
    fi, ti = torch.arange(f, device=dev)[None, :], torch.arange(t, device=dev)[None, :]
    keep_f = (fi < f_start) | (fi >= f_start + f_len)  # [B, F]
    keep_t = (ti < t_start) | (ti >= t_start + t_len)  # [B, T]
    return log_mel * keep_f[:, None, :].to(log_mel.dtype) * keep_t[:, :, None].to(log_mel.dtype)


def frequency_masking(log_mel: torch.Tensor, freqm: int, rng: np.random.Generator) -> torch.Tensor:
    """SpecAugment frequency mask a batch item over ``[B, T, F]``, length
    uniform in [freqm / 8, freqm)."""
    b, _, f = log_mel.shape
    starts, lens = _draw_mask_params(f, freqm, b, rng)
    zeros = np.zeros(b, np.int32)
    return _apply_masks(log_mel, starts, lens, zeros, zeros)


def time_masking(log_mel: torch.Tensor, timem: int, rng: np.random.Generator) -> torch.Tensor:
    """SpecAugment time mask a batch item over ``[B, T, F]``."""
    b, t, _ = log_mel.shape
    starts, lens = _draw_mask_params(t, timem, b, rng)
    zeros = np.zeros(b, np.int32)
    return _apply_masks(log_mel, zeros, zeros, starts, lens)


def label_vector(labels: str, index_dict: dict[str, int], num_classes: int) -> np.ndarray:
    """Comma-separated label string -> multi-hot float vector."""
    out = np.zeros(num_classes, np.float32)
    if labels:
        for s in labels.split(","):
            s = s.strip()
            if s in index_dict:
                out[int(index_dict[s])] = 1.0
    return out


def trim_silence(wav: np.ndarray, threshold: float = 1e-4, chunk: int = 1000) -> np.ndarray:
    """Drop leading and trailing ``chunk``-sample blocks whose peak is under
    ``threshold`` (a silent clip comes back whole). Off by default, as in the
    reference, whose trim never runs."""
    if np.max(np.abs(wav)) < threshold:
        return wav
    n = len(wav)
    start = 0
    while start + chunk < n and np.max(np.abs(wav[start : start + chunk])) < threshold:
        start += chunk
    end = n
    while end - chunk > 0 and np.max(np.abs(wav[end - chunk : end])) < threshold:
        end -= chunk
    return wav[start:end]


class DataPipeline:
    """Training batches: ``log_mel_spec`` NCHW ``[B, 1, T, F]``, ``stft``
    ``[B, T, n_fft / 2]``, ``input_ids`` and ``attention_mask`` as tensors on
    ``device``; ``waveform`` ``[B, samples]``, ``random_start``, and the
    add-ons' numeric fields as numpy arrays on the host (string fields as
    lists). Runs on ``device`` (default ``"cuda"``; it raises without a GPU
    unless the caller passes ``"cpu"``)."""

    def __init__(
        self,
        dataset: AudioCaptionDataset,
        tokenizer,
        mel_cfg: MelConfig = MelConfig(),
        add_ons: Sequence[str] = (),
        trim: bool = False,
        max_text_length: int = 512,
        freqm: int = 0,
        timem: int = 0,
        bucket_text: bool = True,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.dataset = dataset
        self.tokenizer = tokenizer
        self.mel_cfg = mel_cfg
        self.add_ons = [PLUGINS[a] for a in add_ons]
        self.trim = trim
        self.max_text_length = max_text_length
        self.bucket_text = bucket_text
        self.freqm = freqm
        self.timem = timem

    def prepare_waveform(self, wav: np.ndarray, sr: int, rng: np.random.Generator) -> tuple[np.ndarray, int]:
        """Host prep of one clip: segment -> resample -> normalise -> (trim)
        -> pad. Returns (waveform, segment start). The loops run in the
        native library (``data/native.py``), in numpy without it."""
        from audioldm_tpu_torch.data import native

        cfg = self.mel_cfg
        seg, start = random_segment(wav, int(sr * cfg.duration), rng)
        if sr != cfg.sampling_rate:
            seg = native.resample_native(seg, sr, cfg.sampling_rate) if native.available() else resample_np(seg, sr, cfg.sampling_rate)
        seg = native.normalize_native(seg) if native.available() else normalize_wav(seg)
        if self.trim:
            seg = trim_silence(seg)
        return pad_wav(seg, cfg.num_samples), start

    @torch.no_grad()
    def make_batch(self, indices: Sequence[int], rng: np.random.Generator, with_plugins: bool = True) -> dict:
        """One batch of the dataset's ``indices``: host prep a clip at a
        time, then the log-mel, the masks and the token ids on the device."""
        want_meta = with_plugins and bool(self.add_ons)
        wavs, captions, starts, metas = [], [], [], []
        for i in indices:
            wav, sr, caption = self.dataset.get_raw(i)
            if want_meta:  # the HF row memo makes this free right after get_raw
                metas.append(self.dataset.get_metadata(i))
            prepared, start = self.prepare_waveform(wav, sr, rng)
            wavs.append(prepared)
            captions.append(caption)
            starts.append(start)
        waveforms = np.stack(wavs)  # [B, num_samples]
        log_mel, stft = log_mel_spectrogram(torch.from_numpy(waveforms).to(self.device), self.mel_cfg, return_stft=True)
        if self.freqm > 0 or self.timem > 0:
            bsz, t_dim, f_dim = log_mel.shape
            zeros = np.zeros(bsz, np.int32)
            f_s, f_l = _draw_mask_params(f_dim, self.freqm, bsz, rng) if self.freqm > 0 else (zeros, zeros)
            t_s, t_l = _draw_mask_params(t_dim, self.timem, bsz, rng) if self.timem > 0 else (zeros, zeros)
            log_mel = _apply_masks(log_mel, f_s, f_l, t_s, t_l)
        tok = self.tokenizer(captions, max_length=self.max_text_length)
        ids, mask = np.asarray(tok["input_ids"]), np.asarray(tok["attention_mask"])
        if self.bucket_text:
            # pad to the smallest multiple of 64 that holds the longest caption, not to 512: pad-aware
            # position ids and the masked attention give the same pooled embedding, and the text tower's
            # forward shrinks
            longest = int(np.max(np.sum(mask, axis=-1)))
            bucket = min(self.max_text_length, max(64, ((longest + 63) // 64) * 64))
            ids, mask = ids[:, :bucket], mask[:, :bucket]
        batch = {
            "log_mel_spec": log_mel[:, None],  # NCHW
            "stft": stft,
            "waveform": waveforms,
            "input_ids": torch.as_tensor(ids, device=self.device),
            "attention_mask": torch.as_tensor(mask, device=self.device),
            "random_start": np.asarray(starts),
            "duration": self.mel_cfg.duration,
            "sampling_rate": self.mel_cfg.sampling_rate,
        }
        if with_plugins and self.add_ons:
            log_mel_np, stft_np = log_mel.cpu().numpy(), stft.cpu().numpy()
            rows: list[dict] = []
            for b in range(len(indices)):
                item = {
                    "waveform": waveforms[b], "log_mel_spec": log_mel_np[b], "stft": stft_np[b], "metadata": metas[b],
                    "random_start": starts[b], "duration": self.mel_cfg.duration, "sampling_rate": self.mel_cfg.sampling_rate,
                }
                row: dict = {}
                for fn in self.add_ons:
                    row.update(fn(item, self.mel_cfg))
                rows.append(row)
            for k in {k for r in rows for k in r}:
                vals = [r.get(k) for r in rows]
                if k == "text":  # the phoneme dispatch blanks only TTS items; caption items keep theirs
                    batch[k] = [captions[b] if v is None else v for b, v in enumerate(vals)]
                    continue
                if any(v is None for v in vals):
                    raise ValueError(f"add-on output {k!r} produced for only some batch items")
                batch[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else list(vals)
        return batch

    def batches(
        self,
        batch_size: int,
        rng: np.random.Generator,
        shuffle: bool = True,
        drop_last: bool = True,
        epochs: Optional[int] = None,
        prefetch: int = 0,
    ) -> Iterator[dict]:
        """Batches of a permutation of the dataset an epoch (``rng`` draws
        the permutation, then each batch's segments and masks), for
        ``epochs`` epochs or forever. Raises ``ValueError`` when no batch can
        be formed (an empty dataset, or fewer items than ``batch_size`` with
        ``drop_last``).

        ``prefetch > 0`` builds up to that many batches ahead in a daemon
        thread, device work included. That thread launches its kernels on
        the current stream of ``device``, the default stream unless the
        caller set another: the one the training step's kernels run on, so
        a batch's tensors are ready for any kernel launched after it without
        an event, and its mel kernels take their turn between the step's.
        The worker's exceptions reach the consumer; a consumer that stops
        early (``close()``, or dropping the iterator) stops the worker."""

        def gen():
            epoch = 0
            n = len(self.dataset)
            if n == 0 or (drop_last and n < batch_size):
                raise ValueError(
                    f"dataset has {n} items < batch_size {batch_size}" + (" with drop_last" if drop_last else "")
                    + " — no full batch can ever be formed"
                )
            while epochs is None or epoch < epochs:
                order = rng.permutation(n) if shuffle else np.arange(n)
                for i in range(0, n - (batch_size - 1 if drop_last else 0), batch_size):
                    yield self.make_batch(list(order[i : i + batch_size]), rng)
                epoch += 1

        if prefetch <= 0:
            yield from gen()
            return

        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = object()
        closed = threading.Event()

        def _put(item) -> bool:
            # a bounded put: a worker blocked in q.put after the consumer left would hold prefetch + 1
            # batches and a thread for the rest of the process
            while not closed.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:  # an exception must reach the consumer, not look like the end of the data
                for item in gen():
                    if not _put(item):
                        return
                _put(stop)
            except BaseException as e:  # noqa: BLE001 - raised again in the consumer
                _put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # on GeneratorExit too: tell the worker, and drain so that a worker inside q.put wakes and ends
            closed.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
