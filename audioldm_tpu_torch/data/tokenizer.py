"""RoBERTa byte-level BPE tokenizer (host-side, numpy only).

The port's own copy of the JAX package's tokenizer: captions are tokenized
as ``RobertaTokenizerFast`` does with ``padding="max_length",
truncation=True, max_length=512``.

- ``RobertaBPETokenizer``, a pure-python byte-level BPE, loads the
  checkpoint's ``tokenizer/vocab.json`` and ``merges.txt``;
- ``load_tokenizer`` prefers the Rust ``tokenizers`` wheel when it is
  installed (identical output, faster) and falls back to the pure-python one.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Optional

import numpy as np

try:
    import regex as _regex

    _PAT = _regex.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
    )
except ImportError:  # pragma: no cover - regex is in the image
    _regex = None
    _PAT = None


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2/RoBERTa reversible byte<->unicode map."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1)) + list(range(ord("\xae"), ord("\xff") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class RobertaBPETokenizer:
    """Byte-level BPE with RoBERTa special-token conventions
    (<s>=bos, <pad>, </s>=eos wrap every sequence)."""

    def __init__(
        self,
        vocab: dict[str, int],
        merges: list[tuple[str, str]],
        bos_token: str = "<s>",
        eos_token: str = "</s>",
        pad_token: str = "<pad>",
        unk_token: str = "<unk>",
        model_max_length: int = 512,
    ):
        self.vocab = vocab
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bos_token_id = vocab[bos_token]
        self.eos_token_id = vocab[eos_token]
        self.pad_token_id = vocab[pad_token]
        self.unk_token_id = vocab.get(unk_token, vocab[pad_token])
        self.model_max_length = model_max_length
        self._cache: dict[str, tuple[str, ...]] = {}

    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str, **kw) -> "RobertaBPETokenizer":
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(merges_file, encoding="utf-8") as f:
            for line in f.read().split("\n"):
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                if b:
                    merges.append((a, b))
        return cls(vocab, merges, **kw)

    @classmethod
    def from_pretrained_dir(cls, folder: str, **kw) -> "RobertaBPETokenizer":
        return cls.from_files(os.path.join(folder, "vocab.json"), os.path.join(folder, "merges.txt"), **kw)

    # -- BPE core ------------------------------------------------------------
    def _bpe(self, token: str) -> tuple[str, ...]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            a, b = best
            merged = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self._cache[token] = word
        return word

    def encode_text(self, text: str) -> list[int]:
        """BPE ids without special tokens."""
        if _PAT is None:
            raise RuntimeError("regex module unavailable")
        ids: list[int] = []
        for tok in _PAT.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(mapped):
                ids.append(self.vocab.get(piece, self.unk_token_id))
        return ids

    def decode(self, ids) -> str:
        pieces = [self.decoder.get(int(i), "") for i in ids]
        special = {self.bos_token_id, self.eos_token_id, self.pad_token_id}
        text = "".join(p for i, p in zip(ids, pieces) if int(i) not in special)
        raw = bytearray(self.byte_decoder.get(c, 32) for c in text)
        return raw.decode("utf-8", errors="replace")

    # -- HF-style call ---------------------------------------------------------
    def __call__(
        self,
        texts,
        max_length: Optional[int] = None,
        padding: str = "max_length",
        truncation: bool = True,
    ) -> dict[str, np.ndarray]:
        """Wrap with <s>...</s>, truncate, pad to max_length with <pad>."""
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        all_ids, all_mask = [], []
        for t in texts:
            ids = self.encode_text(t)
            if truncation and len(ids) > max_length - 2:
                ids = ids[: max_length - 2]
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
            mask = [1] * len(ids)
            if padding == "max_length" and len(ids) < max_length:
                pad_n = max_length - len(ids)
                ids = ids + [self.pad_token_id] * pad_n
                mask = mask + [0] * pad_n
            all_ids.append(ids)
            all_mask.append(mask)
        if padding != "max_length":
            longest = max(len(x) for x in all_ids)
            all_ids = [x + [self.pad_token_id] * (longest - len(x)) for x in all_ids]
            all_mask = [m + [0] * (longest - len(m)) for m in all_mask]
        return {
            "input_ids": np.asarray(all_ids, np.int32),
            "attention_mask": np.asarray(all_mask, np.int32),
        }


def load_tokenizer(folder: str, model_max_length: int = 512):
    """Prefer the Rust `tokenizers` wheel (identical byte-level BPE), fall
    back to the vendored implementation."""
    vocab = os.path.join(folder, "vocab.json")
    merges = os.path.join(folder, "merges.txt")
    try:
        from tokenizers.implementations import ByteLevelBPETokenizer

        rust = ByteLevelBPETokenizer(vocab, merges)

        class _Wrap:
            pad_token_id = rust.token_to_id("<pad>")
            bos_token_id = rust.token_to_id("<s>")
            eos_token_id = rust.token_to_id("</s>")
            model_max_length_ = model_max_length

            def __call__(self, texts, max_length=None, padding="max_length", truncation=True):
                if isinstance(texts, str):
                    texts = [texts]
                L = max_length or self.model_max_length_
                ids_list = []
                for t in texts:
                    ids = rust.encode(t).ids
                    if truncation and len(ids) > L - 2:
                        ids = ids[: L - 2]
                    ids_list.append([self.bos_token_id] + ids + [self.eos_token_id])
                if padding != "max_length":
                    # pad to the batch longest, as the pure-python tokenizer does
                    L = max(len(ids) for ids in ids_list)
                out_ids = np.full((len(ids_list), L), self.pad_token_id, np.int32)
                out_mask = np.zeros((len(ids_list), L), np.int32)
                for i, ids in enumerate(ids_list):
                    out_ids[i, : len(ids)] = ids
                    out_mask[i, : len(ids)] = 1
                return {"input_ids": out_ids, "attention_mask": out_mask}

        return _Wrap()
    except Exception:
        return RobertaBPETokenizer.from_pretrained_dir(folder, model_max_length=model_max_length)
