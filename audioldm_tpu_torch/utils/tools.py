"""General utilities (port of audioldm_tpu/utils/tools.py): the prompt-list
to JSON dataset conversion, checkpoint-step discovery, file integrity, nested
config lookup, and the MD5-checked downloader of the auxiliary checkpoints.
The downloader uses the standard library's urllib, so ``file://`` URLs work
offline; where a fetch fails it raises with a clear message."""

from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Any, Optional, Sequence


def build_dataset_json_from_list(prompts: Sequence[str], path: Optional[str] = None) -> dict:
    """Prompt list -> ``{"data": [{"wav": "", "caption": ...}]}``, written to
    ``path`` when given."""
    data = {"data": [{"wav": "", "caption": p} for p in prompts]}
    if path:
        with open(path, "w") as f:
            json.dump(data, f, indent=2)
    return data


def get_restore_step(checkpoint_dir: str) -> Optional[int]:
    """The largest step among ``checkpoint-{N}`` and bare ``{N}`` subdirs,
    or None."""
    if not os.path.isdir(checkpoint_dir):
        return None
    steps = []
    for name in os.listdir(checkpoint_dir):
        m = re.fullmatch(r"checkpoint-(\d+)", name) or re.fullmatch(r"(\d+)", name)
        if m:
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def md5_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def verify_checkpoint(path: str, expected_md5: str) -> bool:
    """Whether ``path`` exists and has the MD5 ``expected_md5``."""
    return os.path.exists(path) and md5_file(path) == expected_md5


def retrieve(obj: Any, path: str, default: Any = None, sep: str = "/") -> Any:
    """Nested lookup, ``retrieve(cfg, "train/learning_rate")``, over dicts,
    lists and attributes; ``default`` where a key is missing."""
    cur = obj
    for key in path.split(sep):
        if isinstance(cur, dict):
            if key not in cur:
                return default
            cur = cur[key]
        elif isinstance(cur, (list, tuple)):
            try:
                cur = cur[int(key)]
            except (ValueError, IndexError):
                return default
        elif hasattr(cur, key):
            cur = getattr(cur, key)
        else:
            return default
    return cur


# the auxiliary checkpoints of the reference (vggishish, melception): the
# same names resolve to the same files and MD5s as in the JAX package
URL_MAP = {
    "vggishish_lpaps": "https://a3s.fi/swift/v1/AUTH_a235c0f452d648828f745589cde1219a/specvqgan_public/vggishish16.pt",
    "vggishish_mean_std_melspec_10s_22050hz": "https://a3s.fi/swift/v1/AUTH_a235c0f452d648828f745589cde1219a/specvqgan_public/train_means_stds_melspec_10s_22050hz.txt",
    "melception": "https://a3s.fi/swift/v1/AUTH_a235c0f452d648828f745589cde1219a/specvqgan_public/melception-21-05-10T09-28-40.pt",
}
CKPT_MAP = {
    "vggishish_lpaps": "vggishish16.pt",
    "vggishish_mean_std_melspec_10s_22050hz": "train_means_stds_melspec_10s_22050hz.txt",
    "melception": "melception-21-05-10T09-28-40.pt",
}
MD5_MAP = {
    "vggishish_lpaps": "197040c524a07ccacf7715d7080a80bd",
    "vggishish_mean_std_melspec_10s_22050hz": "f449c6fd0e248936c16f6d22492bb625",
    "melception": "a71a41041e945b457c7d3d814bbcf72d",
}


def download(url: str, local_path: str, chunk_size: int = 1 << 20) -> str:
    """Stream ``url`` (``file://`` included) to ``local_path``; raises
    RuntimeError naming the URL when it cannot be fetched."""
    import urllib.error
    import urllib.request

    parent = os.path.split(local_path)[0]
    if parent:
        os.makedirs(parent, exist_ok=True)
    try:
        with urllib.request.urlopen(url) as r, open(local_path, "wb") as f:
            while True:
                block = r.read(chunk_size)
                if not block:
                    break
                f.write(block)
    except (urllib.error.URLError, OSError) as e:
        raise RuntimeError(
            f"could not download {url}: {e}; without network access, place the file at {local_path} by hand"
        ) from e
    return local_path


def get_ckpt_path(name: str, root: str, check: bool = False) -> str:
    """The path of the auxiliary checkpoint ``name`` under ``root``,
    downloaded and MD5-checked when missing (or, with ``check``, corrupt)."""
    if name not in URL_MAP:
        raise KeyError(f"unknown checkpoint {name!r}; known: {sorted(URL_MAP)}")
    path = os.path.join(root, CKPT_MAP[name])
    if not os.path.exists(path) or (check and md5_file(path) != MD5_MAP[name]):
        download(URL_MAP[name], path)
        md5 = md5_file(path)
        if md5 != MD5_MAP[name]:
            raise ValueError(f"md5 mismatch for {name}: got {md5}, want {MD5_MAP[name]}")
    return path
