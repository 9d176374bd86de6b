"""Build and load the port's CUDA kernels.

Each ``audioldm_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled at first use by ``nvcc`` for Hopper (``sm_90a``) into its own shared
library, then loaded with ``ctypes``. Libraries are cached in
``audioldm_tpu_torch/_build/`` keyed by a hash of the source and of the
shared ``*.cuh`` headers, so a changed source is rebuilt. ``build_all`` starts one ``nvcc`` per source at once.
A failed build raises; nothing falls back. Extra ``nvcc`` flags (for example
``-Xptxas -v``) come from the environment variable ``AUDIOLDM_NVCC_FLAGS``;
what the compiler printed is kept in ``logs``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shlex
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("flash_fwd_sm90", "flash_bwd_sm90", "flash_attention", "flash_attention_bwd", "flash_attention_one", "mrf_conv",
           "attn_diag_sm90", "attn_diag_grid3_sm90", "attn_diag_k8_k10_sm90", "attn_diag_f32")

_libs: dict = {}
_fns: dict = {}  # (source name, function name) -> ctypes function with its signature set
logs: dict = {}  # source name -> nvcc's output of this process's build
seconds: dict = {}  # source name -> seconds its nvcc took in this process's build
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _lib_path(src: str) -> str:
    """Where the library built from ``src`` lives (keyed by its content)."""
    digest = hashlib.sha1()
    headers = sorted(os.path.join(CSRC, n) for n in os.listdir(CSRC) if n.endswith(".cuh"))
    for path in [src] + headers:
        with open(path, "rb") as f:
            digest.update(f.read())
    digest = digest.hexdigest()[:12]
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def command(src: str, out: str) -> list:
    """The ``nvcc`` command that builds ``src`` into the shared library ``out``."""
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", *shlex.split(os.environ.get("AUDIOLDM_NVCC_FLAGS", "")), "-o", out, src,
    ]


def _start(src: str):
    """Start nvcc for one source; returns (lib_path, process or None)."""
    lib = _lib_path(src)
    if os.path.exists(lib):
        return lib, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    log = open(f"{tmp}.log", "w+")  # a file, not a pipe: nvcc never blocks on its output
    proc = subprocess.Popen(command(src, tmp), stdout=log, stderr=subprocess.STDOUT, text=True)
    proc.tmp, proc.log, proc.t0 = tmp, log, time.perf_counter()
    return lib, proc


def _finish(src: str, lib: str, proc) -> ctypes.CDLL:
    if proc is not None:
        proc.wait()
        proc.log.seek(0)
        out = proc.log.read()
        proc.log.close()
        os.remove(proc.log.name)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src} (exit {proc.returncode}):\n{out}")
        os.replace(proc.tmp, lib)
        logs[os.path.splitext(os.path.basename(src))[0]] = out
    return ctypes.CDLL(lib)


def build_all(names=SOURCES) -> None:
    """Compile every kernel source of the port in parallel (one nvcc each)
    and load them; ``seconds`` gets each build's time as it ends."""
    with _lock:
        srcs = {n: os.path.join(CSRC, f"{n}.cu") for n in names if n not in _libs}
        pending = {n: _start(src) for n, src in srcs.items()}
        while pending:
            for n, (lib, proc) in list(pending.items()):
                if proc is None or proc.poll() is not None:
                    if proc is not None:
                        seconds[n] = time.perf_counter() - proc.t0
                    _libs[n] = _finish(srcs[n], lib, proc)
                    del pending[n]
            if pending:
                time.sleep(0.05)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _libs:
        build_all((name,))
    return _libs[name]


def function(name: str, fn: str, argtypes: list):
    """``fn`` of the library built from ``csrc/<name>.cu``, its ``restype``
    (a ``cudaError_t`` as ``int``) and ``argtypes`` set once, when first asked for."""
    key = (name, fn)
    if key not in _fns:
        f = getattr(load(name), fn)
        f.restype = ctypes.c_int
        f.argtypes = argtypes
        _fns[key] = f
    return _fns[key]


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


SASS_OPS = ("HGMMA", "UTMALDG", "UBLKCP", "MUFU.EX2", "F2FP", "HMMA", "LDSM", "LDS", "LDL", "STL")


def sass(lib: str) -> dict:
    """Per kernel function of the built library ``lib`` (mangled names): the
    counts of ``SASS_OPS`` in its SASS (``cuobjdump -sass``), ``ALL`` its
    instructions, and ``REG`` its registers a thread (``cuobjdump
    -res-usage``)."""
    tool = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, timeout=300).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict.fromkeys(SASS_OPS + ("ALL", "REG"), 0)
        elif fn is not None:
            m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+(?:\.[A-Z0-9_]+)*)", line)
            if m:
                op = m.group(1)
                counts[fn]["ALL"] += 1
                for name in SASS_OPS:
                    if op == name or op.startswith(name + "."):
                        counts[fn][name] += 1
    res = subprocess.run([tool, "-res-usage", lib], capture_output=True, text=True, timeout=300).stdout
    for name, regs in re.findall(r"Function ([^\s:]+):\s*REG:(\d+)", res):
        if name in counts:
            counts[name]["REG"] = int(regs)
    return counts
