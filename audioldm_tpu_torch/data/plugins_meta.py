"""Metadata-driven dataset plugins: phoneme conditioning + drum beats (the
port's copy of audioldm_tpu/data/plugins_meta.py, registered into the port's
``data.dataset.PLUGINS``).

These complete the reference's add-on registry (script/data/dataset_plugin.py).
None of them runs a model — every one is a deterministic transform of
*metadata the dataset already carries* (phoneme strings produced offline by
VITS/g2p_en tooling, beat/downbeat sample indices from a beat tracker), so
they are exactly reproducible here:

- ``get_vits_phoneme_ids``            (dataset_plugin.py:31-54)
- ``get_vits_phoneme_ids_no_padding`` (dataset_plugin.py:57-78)
- ``extract_vits_phoneme_and_flant5_text`` (dataset_plugin.py:148-160)
- ``extract_fs2_phoneme_and_flant5_text``  (dataset_plugin.py:163-170)
- ``extract_fs2_phoneme_g2p_en_feature``   (dataset_plugin.py:173-271)
- ``extract_phoneme_g2p_en_feature``       (dataset_plugin.py:274-342)
- ``extract_drum_beat``                    (dataset_plugin.py:422-508)

The symbol inventories are fixed vocabularies (data, not code): the VITS
symbol set is the public VITS `text.symbols` table; the fs2/g2p tables pin
the exact id assignment the reference's checkpoints were trained with.

Plugins receive the per-item dict built by ``DataPipeline.make_batch``
(waveform/log_mel_spec/stft + ``metadata``/``random_start``/``duration``/
``sampling_rate``) and the MelConfig.
"""

from __future__ import annotations

import numpy as np

from audioldm_tpu_torch.config import MelConfig
from audioldm_tpu_torch.data.dataset import register_plugin

# -- VITS symbol inventory (public VITS text/symbols.py table; the reference
#    embeds the same table at dataset_plugin.py:7-28) ------------------------
_VITS_PAD = "_"
_VITS_PUNCTUATION = ';:,.!?¡¿—…"«»“” '
_VITS_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_VITS_LETTERS_IPA = (
    "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ"
)
_VITS_SPECIAL = "♪☎☒☝⚠"
VITS_SYMBOLS = (
    [_VITS_PAD]
    + list(_VITS_PUNCTUATION)
    + list(_VITS_LETTERS)
    + list(_VITS_LETTERS_IPA)
    + list(_VITS_SPECIAL)
)
_VITS_SYMBOL_TO_ID = {s: i for i, s in enumerate(VITS_SYMBOLS)}
_VITS_PAD_LENGTH = 310  # dataset_plugin.py:9


def _pad_to(ids: list[int], length: int, pad_id: int) -> np.ndarray:
    out = ids + [pad_id] * (length - len(ids))
    return np.asarray(out, np.int64)


@register_plugin("get_vits_phoneme_ids")
def get_vits_phoneme_ids(item: dict, cfg: MelConfig) -> dict:
    """VITS phoneme ids with interleaved blanks: ``[0, p1, 0, p2, ..., 0]``,
    zero-padded to 310 (dataset_plugin.py:31-54). Strict lookup — an unknown
    symbol is an error, as in the reference."""
    meta = item.get("metadata") or {}
    assert "phonemes" in meta, (
        "get_vits_phoneme_ids requires 'phonemes' in the item metadata"
    )
    seq = [_VITS_SYMBOL_TO_ID[s] for s in meta["phonemes"]]
    interleaved: list[int] = [0] * (2 * len(seq) + 1)
    interleaved[1::2] = seq
    # >154 phonemes would overflow the 310 slot; the reference would emit an
    # over-length row here (dataset_plugin.py:47-54 never truncates) and
    # crash at collate — truncate instead so batching stays well-formed
    return {"phoneme_idx": _pad_to(interleaved[:_VITS_PAD_LENGTH], _VITS_PAD_LENGTH, 0)}


@register_plugin("get_vits_phoneme_ids_no_padding")
def get_vits_phoneme_ids_no_padding(item: dict, cfg: MelConfig) -> dict:
    """VITS phoneme ids without blank interleaving: text + '⚠' end marker,
    unknown symbols mapped to '_', truncated then zero-padded to 310
    (dataset_plugin.py:57-78)."""
    meta = item.get("metadata") or {}
    assert "phonemes" in meta, (
        "get_vits_phoneme_ids_no_padding requires 'phonemes' in metadata"
    )
    text = meta["phonemes"] + "⚠"
    seq = [_VITS_SYMBOL_TO_ID.get(s, _VITS_SYMBOL_TO_ID["_"]) for s in text]
    return {"phoneme_idx": _pad_to(seq[:_VITS_PAD_LENGTH], _VITS_PAD_LENGTH, 0)}


@register_plugin("extract_vits_phoneme_and_flant5_text")
def extract_vits_phoneme_and_flant5_text(item: dict, cfg: MelConfig) -> dict:
    """TTS-vs-caption dispatch (dataset_plugin.py:148-160): items with VITS
    ``phonemes`` get phoneme ids AND an empty text (TTS data has no caption);
    caption-only items get an empty phoneme sequence and keep their caption
    (``text`` is only set in the has-phonemes branch, :155-156)."""
    meta = item.get("metadata") or {}
    assert "phoneme" not in meta, (
        "metadata has fastspeech 'phoneme'; use extract_fs2_phoneme_and_flant5_text"
    )
    if "phonemes" in meta:
        out = get_vits_phoneme_ids_no_padding(item, cfg)
        out["text"] = ""
        return out
    sub = dict(item)
    sub["metadata"] = {"phonemes": ""}
    return get_vits_phoneme_ids_no_padding(sub, cfg)


# -- fs2 / g2p_en phoneme tables ---------------------------------------------
# Stressed ARPAbet inventory in the exact (non-alphabetical) id order the
# reference's FastSpeech2 checkpoints use (dataset_plugin.py:176-250).
_FS2_PHONEMES = (
    "K IH2 NG OW2 AH2 F AE0 IY0 SH G W UW1 AO2 AW2 UW0 EY2 UW2 AE2 IH0 P D "
    "ER1 AA1 EH0 UH1 N V AY1 EY1 UH2 EH1 L AA2 R OY1 Y ER2 S AE1 AH1 JH ER0 "
    "EH2 IY2 OY2 AW1 IH1 IY1 OW0 AO0 AY0 EY0 AY2 UH0 M TH T OY0 AW0 DH Z "
    "spn AH0 sp AO1 OW1 ZH B AA0 CH HH"
).split()
_FS2_LOOKUP = {p: i for i, p in enumerate(_FS2_PHONEMES)}
_FS2_PAD_LENGTH = 135  # dataset_plugin.py:174

# Unstressed ARPAbet, alphabetical with leading space (dataset_plugin.py:277-317).
_G2P_PHONEMES = [" "] + (
    "AA AE AH AO AW AY B CH D DH EH ER EY F G HH IH IY JH K L M N NG OW OY "
    "P R S SH T TH UH UW V W Y Z ZH"
).split()
_G2P_LOOKUP = {p: i for i, p in enumerate(_G2P_PHONEMES)}
_G2P_PAD_LENGTH = 250  # dataset_plugin.py:275


def _phoneme_ids(meta: dict, lookup: dict, pad_length: int) -> np.ndarray:
    assert "phoneme" in meta, (
        "phoneme add-on requires a 'phoneme' list in the item metadata"
    )
    ids = [lookup[p] for p in meta["phoneme"] if p in lookup]
    # truncation happens at ANY overflow; the warning fires only past 5x,
    # matching the reference exactly (dataset_plugin.py:261-263,331-333)
    if len(ids) / pad_length > 5:
        print(f"Warning: phoneme sequence is too long and is truncated too "
              f"much ({len(ids)} -> {pad_length})")
    return _pad_to(ids[:pad_length], pad_length, len(lookup))


@register_plugin("extract_fs2_phoneme_g2p_en_feature")
def extract_fs2_phoneme_g2p_en_feature(item: dict, cfg: MelConfig) -> dict:
    """FastSpeech2 stressed-phoneme ids, pad id 71, length 135
    (dataset_plugin.py:173-271)."""
    meta = item.get("metadata") or {}
    return {"phoneme_idx": _phoneme_ids(meta, _FS2_LOOKUP, _FS2_PAD_LENGTH)}


@register_plugin("extract_fs2_phoneme_and_flant5_text")
def extract_fs2_phoneme_and_flant5_text(item: dict, cfg: MelConfig) -> dict:
    """fs2 analogue of the VITS/flan-t5 dispatch (dataset_plugin.py:163-170);
    like the VITS variant, ``text`` is blanked only for phoneme items."""
    meta = item.get("metadata") or {}
    if "phoneme" in meta:
        out = extract_fs2_phoneme_g2p_en_feature(item, cfg)
        out["text"] = ""
        return out
    sub = dict(item)
    sub["metadata"] = {"phoneme": []}
    return extract_fs2_phoneme_g2p_en_feature(sub, cfg)


@register_plugin("extract_phoneme_g2p_en_feature")
def extract_phoneme_g2p_en_feature(item: dict, cfg: MelConfig) -> dict:
    """Unstressed g2p_en phoneme ids, pad id 40, length 250
    (dataset_plugin.py:274-342)."""
    meta = item.get("metadata") or {}
    return {"phoneme_idx": _phoneme_ids(meta, _G2P_LOOKUP, _G2P_PAD_LENGTH)}


@register_plugin("extract_drum_beat")
def extract_drum_beat(
    item: dict,
    cfg: MelConfig,
    latent_t_size: int | None = None,
    latent_f_size: int | None = None,
) -> dict:
    """Beat/downbeat conditioning signal on the latent grid
    (dataset_plugin.py:422-508): beat rows get -0.5, downbeat rows +1.0
    (so a coinciding downbeat+beat reads +0.5). Beat positions are sample
    indices in the ORIGINAL file at ``metadata['sample_rate']``; they are
    shifted by the random segment start and mapped onto latent time rows.

    The reference reads latent_t/f_size from the model config (:480-483);
    here they default to the mel geometry over the audioldm-s VAE's 4x
    downsampling (1024x64 mel -> 256x16 latent), so they track cfg.duration
    / cfg.n_mel instead of being frozen at the 10.24 s values."""
    if latent_t_size is None:
        latent_t_size = cfg.target_length // 4
    if latent_f_size is None:
        latent_f_size = cfg.n_mel // 4
    meta = item.get("metadata") or {}
    assert (
        "sample_rate" in meta and "beat" in meta and "downbeat" in meta
    ), "extract_drum_beat requires sample_rate/beat/downbeat metadata"
    seg_len = int(meta["sample_rate"] * item["duration"])
    start = int(item["random_start"])
    cond = np.zeros((latent_t_size, latent_f_size), np.float32)
    for positions, value in ((meta["beat"], -0.5), (meta["downbeat"], 1.0)):
        rel = np.asarray(positions, np.float64) - start
        rel = rel[(rel >= 0) & (rel <= seg_len)]
        rows = np.minimum((rel / seg_len * latent_t_size).astype(np.int64), latent_t_size - 1)
        for r in rows:
            cond[r, :] += value
    return {"cond_beat_downbeat": cond}
