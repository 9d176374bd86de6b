"""Do the bounds of ``chip_smoke.py`` catch a faulty kernel?

    python3 -m audioldm_tpu_torch.kernels.fault_check [--source SOURCE]     (from the repo root, on the GPU)

For each fault below this copies the package and ``chip_smoke.py`` into a
temporary directory, breaks one line (or a few, each found once) of a CUDA
source there (never in the repo), builds the copy and runs ``chip_smoke``'s
kernel-vs-plain cases of the kernels in that source (K1, K6 and K3 in
``flash_fwd_sm90.cu`` and the loop they share with K7-K10,
``flash_fwd_sm90.cuh``, where a fault that breaks only a diagnostic kernel
names the diagnostic cases; fp32 K1, K3 and K6 in ``flash_attention.cu``
and the loop they share with the fp32 K7-K10 (``attn_diag_f32.cu``),
``flash_fwd_f32.cuh``, where each fault names the cases of the kernels it
breaks; K4 and K5 in ``flash_bwd_sm90.cu`` (bf16) and
``flash_attention_bwd.cu`` (fp32); the diagnostic kernels K7 in
``attn_diag_sm90.cu``, K9 in ``attn_diag_grid3_sm90.cu`` and K8 and K10 in
``attn_diag_k8_k10_sm90.cu`` (their kernel in ``attn_diag_sm90.cuh``); K2
in ``mrf_conv.cu``) in it,
``JOBS`` copies at a time on the one card. A fault is caught
when at least one check fails, or when the copy hangs: each run has
``TIME_LIMIT`` seconds, after which it is killed and reported as a hang.
The script prints which checks failed for each fault, and exits nonzero
if a fault slipped through or the unbroken copy failed a check or hung.
``--source flash_attention_bwd.cu`` runs only the faults of that source
(and the unbroken copy).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

JOBS = 4  # copies built and run at once
TIME_LIMIT = 900  # seconds a copy may take, its build included

# the cases that hold the kernels of each source (a fault may name its own)
CASES = {
    "flash_fwd_sm90.cuh": ["flash_cases", "one_cases", "flash_train_cases"],
    "flash_fwd_sm90.cu": ["flash_cases", "one_cases", "flash_train_cases"],
    "flash_fwd_f32.cuh": ["flash_cases", "one_cases", "flash_train_cases", "diag_cases"],
    "flash_attention.cu": ["flash_cases", "one_cases", "flash_train_cases"],
    "flash_bwd_sm90.cu": ["flash_train_cases"],
    "flash_attention_bwd.cu": ["flash_train_cases"],
    "attn_diag_sm90.cuh": ["diag_cases"],
    "attn_diag_sm90.cu": ["diag_cases"],
    "attn_diag_grid3_sm90.cu": ["diag_cases"],
    "attn_diag_k8_k10_sm90.cu": ["diag_cases"],
    "attn_diag_f32.cu": ["diag_cases"],
    "mrf_conv.cu": ["mrf_cases"],
}
DIAG = ["diag_cases"]  # the faults of the shared forward loop that break only a diagnostic kernel
# the cases of the fp32 loop's kernels (flash_fwd_f32.cuh): K1 and K3, K6, K7-K10
F32_K1_K3, F32_K6, F32_DIAG = ["flash_cases", "flash_train_cases"], ["one_cases"], ["diag_f32_cases"]

# K8 with each kv stage freed as soon as its S is in (the first tile's and
# each next tile's), before its P V: the producer may refill the stage with
# tile t + 2 while P V of tile t has yet to read it
_K8_EARLY_FREE = (
    ("      fence_regs(sc);\n", "      fence_regs(sn);\n", "      release(it0 + t - 1);\n", "      release(it0 + nt - 1);\n"),
    ("      fence_regs(sc);\n      if (V == Fwd::K8) release(it0);\n",
     "      fence_regs(sn);\n      if (V == Fwd::K8) release(it0 + t);\n",
     "      if (V != Fwd::K8) release(it0 + t - 1);\n", "      if (V != Fwd::K8) release(it0 + nt - 1);\n"),
)

# name -> (source, line to find, its faulty replacement[, the cases to run]);
# a tuple of lines and one of replacements break several lines at once
FAULTS = {
    "none": None,
    "K1/K6 bf16: ragged kv tail not masked": (
        "flash_fwd_sm90.cuh", "if (lim >= BN) return;  // whole tile in range", "return;  // whole tile in range"),
    "K1/K6 bf16: kv tile 1 skipped": (
        "flash_fwd_sm90.cuh", "mask_tail(sn, M - (t0 + t) * BN, tg);", "mask_tail(sn, t == 1 ? 0 : M - (t0 + t) * BN, tg);"),
    "K1/K6 bf16: q pre-scaled twice": (
        "flash_fwd_sm90.cuh", "qa[kk][i] = prescale(raw, qscale);", "qa[kk][i] = prescale(prescale(raw, qscale), qscale);"),
    "K1 bf16: no rescale when a row's max grows": (
        "flash_fwd_sm90.cuh", "alpha[r] = V != Fwd::FULL ? ex2(m[r] - mn[r])", "alpha[r] = V != Fwd::FULL ? 1.f"),
    "K6 bf16: sweep-1 max over the first tile only": (
        "flash_fwd_sm90.cuh", "row_max_upto(cur, mx, M - (t1 + t) * BN, tg);  // sweep-1 max",
        "if (t == 0) row_max_upto(cur, mx, M - (t1 + t) * BN, tg);  // sweep-1 max"),
    "K6 bf16: ones block zero": (
        "flash_fwd_sm90.cuh", "w[i] = 0x3F803F80u;", "w[i] = 0u;"),
    "K3 bf16: ragged kv tail not masked": (
        "flash_fwd_sm90.cuh", "mask_tail(sn, M - (t0 + t) * BN, tg);", "if (!W::LSE) mask_tail(sn, M - (t0 + t) * BN, tg);"),
    "K3 bf16: kv tile 1 skipped": (
        "flash_fwd_sm90.cuh", "mask_tail(sn, M - (t0 + t) * BN, tg);", "mask_tail(sn, W::LSE && t == 1 ? 0 : M - (t0 + t) * BN, tg);"),
    "K3 bf16: log2(l) left out of lse2": (
        "flash_fwd_sm90.cuh", "= m[r] + log2f(l[r]);", "= m[r];"),
    "K3 bf16: lse2 of the neighbouring row": (
        "flash_fwd_sm90.cuh", "= m[r] + log2f(l[r]);", "= m[r ^ 1] + log2f(l[r ^ 1]);"),
    "K1/K3 fp32: ragged kv tail not masked": (
        "flash_fwd_f32.cuh", "const int lim = M - t * BN;", "const int lim = BN;", F32_K1_K3),
    "K4 bf16: q tile 1 skipped": (
        "flash_bwd_sm90.cu", "const int lo = t * BQ - q0, hi = N - q0;", "const int lo = t * BQ - q0, hi = t == 1 ? 0 : N - q0;"),
    "K5 bf16: kv tile 1 skipped": (
        "flash_bwd_sm90.cu", "const int lo = t * BN - kv0, hi = M - kv0;", "const int lo = t * BN - kv0, hi = t == 1 ? 0 : M - kv0;"),
    "K4 bf16: lse2 read from the neighbouring q column": (
        "flash_bwd_sm90.cu", "l2[4 * j + i] = i & 1 ? lj.y : lj.x;", "l2[4 * j + i] = i & 1 ? lj.x : lj.y;"),
    "K5 bf16: lse2 of the neighbouring q row": (
        "flash_bwd_sm90.cu", "l2[i] = lr[(i >> 1) & 1];", "l2[i] = lr[((i >> 1) & 1) ^ 1];"),
    "K4/K5 bf16: delta left out of dS": (
        "flash_bwd_sm90.cu", "ds[i] = p[i] * (dp[a] - dl[a]) * scale;", "ds[i] = p[i] * dp[a] * scale;"),
    "K4 bf16: dk_scale dropped": (
        "flash_bwd_sm90.cu", "pack_bf16(dka[4 * j + 2 * r] * dk_scale, dka[4 * j + 2 * r + 1] * dk_scale)",
        "pack_bf16(dka[4 * j + 2 * r], dka[4 * j + 2 * r + 1])"),
    "K5 bf16: ragged last kv tile's repeated columns not masked": (
        "flash_bwd_sm90.cu", "const int lo = t * BN - kv0, hi = M - kv0;", "const int lo = 0, hi = M - kv0;"),
    "K4 bf16: ragged last q tile's repeated columns not masked": (
        "flash_bwd_sm90.cu", "const int lo = t * BQ - q0, hi = N - q0;", "const int lo = 0, hi = N - q0;"),
    "K6 fp32: ragged kv tail not masked": (
        "flash_fwd_f32.cuh", "    if (lim < BN) {", "    if (lim < BN && !W::TWO) {", F32_K6),
    "K6 fp32: ones column missing": (
        "flash_fwd_f32.cuh", "if constexpr (W::SUM) rs[(i >> 1) & 1] += sc[i];",
        "if constexpr (W::SUM) rs[(i >> 1) & 1] += W::TWO ? 0.f : sc[i];", F32_K6),
    "K6 fp32: P's lo products dropped (P in TF32)": (
        "flash_fwd_f32.cuh",
        "for (int i = 0; i < 4; ++i) split(sc[4 * j + i], ph[j][i == 1 ? 2 : i == 2 ? 1 : i], pl[j][i == 1 ? 2 : i == 2 ? 1 : i]);",
        "for (int i = 0; i < 4; ++i) {\n        split(sc[4 * j + i], ph[j][i == 1 ? 2 : i == 2 ? 1 : i], pl[j][i == 1 ? 2 : i == 2 ? 1 : i]);\n"
        "        if (W::TWO) pl[j][i == 1 ? 2 : i == 2 ? 1 : i] = 0u;\n      }", F32_K6),
    "K7 exp2 fp32: the max committed a tile, not a block": (
        "flash_fwd_f32.cuh", "const bool blocks = W::BLOCKS && kb > 1;", "const bool blocks = false;", F32_DIAG),
    "K8 fp32: the running max starts at 0, not -1e30": (
        "flash_fwd_f32.cuh", "static constexpr float M0 = V == F32::K8 || V == F32::K9 || V == F32::K10 ? -1e30f : -INFINITY;",
        "static constexpr float M0 = V == F32::K8 ? 0.f : V == F32::K9 || V == F32::K10 ? -1e30f : -INFINITY;", F32_DIAG),
    "K10 fp32: ones group zero (d <= 32)": (
        "flash_fwd_f32.cuh", "C::VTHI - C::ONESG) / 4 + i % (C::ONESG / 4)] = 1.f;", "C::VTHI - C::ONESG) / 4 + i % (C::ONESG / 4)] = 0.f;",
        F32_DIAG),
    "K5 fp32: delta left out": (
        "flash_attention_bwd.cu", "dl = dr[(i >> 1) & 1];  // K5: delta of the q row", "dl = 0.f;  // K5: delta of the q row"),
    "K4/K5 fp32: lo products dropped (TF32 alone)": (
        "flash_attention_bwd.cu",
        ("  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]), __uint_as_float(l[3]));",
         "      op[C::OWN / 4 + off] = __uint_as_float(lo);", "      op[3 * C::OWN / 4 + off] = __uint_as_float(lo);",
         "        split(x[4 * j + i], fh[j][f], fl[j][f]);"),
        ("  lo = make_float4(0.f, 0.f, 0.f, 0.f);", "      op[C::OWN / 4 + off] = 0.f;", "      op[3 * C::OWN / 4 + off] = 0.f;",
         "        split(x[4 * j + i], fh[j][f], fl[j][f]);\n        fl[j][f] = 0u;")),
    "K4 fp32: dk_scale dropped": (
        "flash_attention_bwd.cu", "make_float2(acc1[4 * j + 2 * r] * a.out1_scale, acc1[4 * j + 2 * r + 1] * a.out1_scale)",
        "make_float2(acc1[4 * j + 2 * r], acc1[4 * j + 2 * r + 1])"),
    "K4/K5 fp32: ragged last tile's repeated columns not masked": (
        "flash_attention_bwd.cu", "const int lo = t * T - s0, hi = a.NS - s0;", "const int lo = 0, hi = a.NS - s0;"),
    "K4/K5 fp32: streamed tile 1 skipped": (
        "flash_attention_bwd.cu", "const int lo = t * T - s0, hi = a.NS - s0;",
        "const int lo = t * T - s0, hi = t == 1 ? 0 : a.NS - s0;"),
    "K7 exp2: rescale applied (it becomes full)": (
        "flash_fwd_sm90.cuh", "static constexpr bool RESCALE = V == Fwd::K1 ||",
        "static constexpr bool RESCALE = V == Fwd::EXP2 || V == Fwd::K1 ||", DIAG),
    "K9: kv tile 1 skipped": (
        "flash_fwd_sm90.cuh", "mask_tail(sn, M - (t0 + t) * BN, tg);", "mask_tail(sn, V == Fwd::K9 && t == 1 ? 0 : M - (t0 + t) * BN, tg);",
        DIAG),
    "K10: ones block zero": (
        "flash_fwd_sm90.cuh", "w[i] = 0x3F803F80u;", "w[i] = V == Fwd::K10 ? 0u : 0x3F803F80u;", DIAG),
    "K10: the rescale skips the ones columns (d <= 64)": (
        "flash_fwd_sm90.cuh", "for (int i = 0; i < NV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];",
        "for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];", DIAG),
    "K10: the ones product left unrescaled (d = 128)": (
        "flash_fwd_sm90.cuh", "for (int i = 0; i < 4; ++i) lsum[i] *= alpha[(i >> 1) & 1];",
        "for (int i = 0; i < 4; ++i) lsum[i] *= 1.f;", DIAG),
    "K8: a kv stage freed before its P V": ("flash_fwd_sm90.cuh", *_K8_EARLY_FREE, DIAG),
    "K8: the running max starts at 0, not -1e30": (
        "flash_fwd_sm90.cuh", "static constexpr float M0 = V == Fwd::K8 || V == Fwd::K9 || V == Fwd::K10 ? -1e30f : -INFINITY;",
        "static constexpr float M0 = V == Fwd::K8 ? 0.f : V == Fwd::K9 || V == Fwd::K10 ? -1e30f : -INFINITY;", DIAG),
    "K10: the running max starts at 0, not -1e30": (
        "flash_fwd_sm90.cuh", "static constexpr float M0 = V == Fwd::K8 || V == Fwd::K9 || V == Fwd::K10 ? -1e30f : -INFINITY;",
        "static constexpr float M0 = V == Fwd::K10 ? 0.f : V == Fwd::K8 || V == Fwd::K9 ? -1e30f : -INFINITY;", DIAG),
    "K2: lo products dropped (TF32 alone)": (
        "mrf_conv.cu", "          WgmmaTF32<CP>::run(acc[i], al[set][kk], dh, 1);\n          WgmmaTF32<CP>::run(acc[i], ah[set][kk], dl, 1);\n",
        ""),
    "K2: signal-edge mask dropped": (
        "mrf_conv.cu", "const bool sig = p >= 0 && p < cfg.T;", "const bool sig = true;"),
    "K2: tap 1 of every conv skipped": (
        "mrf_conv.cu", "    for (int i = 0; i < NT; ++i) {\n#pragma unroll\n      for (int gq = 0;",
        "    for (int i = 0; i < NT && tap != 1; ++i) {\n#pragma unroll\n      for (int gq = 0;"),
    "K7 no_exp: 1e-20 guard dropped": (
        "flash_fwd_sm90.cuh", "inv[r] = 1.f / (W::K7 ? fmaxf(l[r], 1e-20f) : l[r]);",
        "inv[r] = 1.f / (W::K7 && V != Fwd::NO_EXP ? fmaxf(l[r], 1e-20f) : l[r]);", DIAG),
    "K7 exp2: sweep 1 skips tile 1 of every block": (
        "flash_fwd_sm90.cuh", "row_max_upto(sa, mx, M - (t1 + t) * BN, tg);",
        "if (t != 1) row_max_upto(sa, mx, M - (t1 + t) * BN, tg);", DIAG),
    "K7 exp2: blocks of one tile whatever block_k": (
        "attn_diag_sm90.cu", "s, 1.f, scale, block_k / BN, st);", "s, 1.f, scale, 1, st);"),
    "K7 matmul_only: the logit scale applied": (
        "flash_fwd_sm90.cuh", "static constexpr bool LSCALE = V == Fwd::FULL ||",
        "static constexpr bool LSCALE = V == Fwd::MATMUL_ONLY || V == Fwd::FULL ||", DIAG),
    "K9: the running max starts at 0, not -1e30": (
        "flash_fwd_sm90.cuh", "static constexpr float M0 = V == Fwd::K8 || V == Fwd::K9 || V == Fwd::K10 ? -1e30f : -INFINITY;",
        "static constexpr float M0 = V == Fwd::K9 ? 0.f : V == Fwd::K8 || V == Fwd::K10 ? -1e30f : -INFINITY;", DIAG),
    "K9 64-row instance: q offset off by a tile": (
        "flash_fwd_sm90.cuh", "const int row0 = blockIdx.x * T::BM +", "const int row0 = (blockIdx.x + (NWG == 1)) * T::BM +", DIAG),
    "K9: a ragged q tail's rows dropped": (
        "flash_fwd_sm90.cuh", "if (row < N && col < D)", "if (row < (V == Fwd::K9 ? N / T::BM * T::BM : N) && col < D)", DIAG),
}

_RUN = """
import json, sys, torch, chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
for cases in sys.argv[1:]:
    getattr(cs, cases)(torch)
print("FAILED " + json.dumps(cs.failures))
"""


def edits(line, faulty) -> list:
    """A fault's (line, replacement) pairs: one, or one a line of a tuple."""
    return list(zip(line, faulty)) if isinstance(line, tuple) else [(line, faulty)]


def run_fault(name: str) -> list[str] | None:
    """The checks that failed in the copy broken by fault ``name``, or None
    if it hung (ran past ``TIME_LIMIT`` seconds and was killed)."""
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(os.path.join(REPO, "audioldm_tpu_torch"), os.path.join(tmp, "audioldm_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp)
        cases = sorted({c for cs in CASES.values() for c in cs})
        if FAULTS[name] is not None:
            source, line, faulty, *own = FAULTS[name]
            cases = own[0] if own else CASES[source]
            path = os.path.join(tmp, "audioldm_tpu_torch", "csrc", source)
            with open(path) as f:
                text = f.read()
            for old, new in edits(line, faulty):
                if text.count(old) != 1:
                    raise SystemExit(f"fault {name!r}: the line to break occurs {text.count(old)} times in {source}")
                text = text.replace(old, new)
            with open(path, "w") as f:
                f.write(text)
        try:
            proc = subprocess.run([sys.executable, "-c", _RUN, *cases], cwd=tmp, capture_output=True, text=True,
                                  timeout=TIME_LIMIT)
        except subprocess.TimeoutExpired:
            return None
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("FAILED ")]
    if proc.returncode != 0 or not lines:
        raise SystemExit(f"fault {name!r}: the run did not finish (exit {proc.returncode}):\n{proc.stderr[-2000:]}")
    return json.loads(lines[-1][len("FAILED "):])


def selected(source: str | None = None) -> list[str]:
    """The faults to run: all, or the unbroken copy and those of ``source``."""
    return [n for n, f in FAULTS.items() if f is None or source in (None, f[0])]


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--source", choices=sorted(CASES), help="only the faults of this source (and the unbroken copy)")
    names = selected(p.parse_args(argv).source)
    slipped = []
    with ThreadPoolExecutor(JOBS) as pool:
        for name, failed in zip(names, pool.map(run_fault, names)):
            hung = failed is None
            caught = name != "none" if hung else bool(failed) != (name == "none")
            print(json.dumps({"fault": name, "hung": hung, "checks_failed": None if hung else len(failed),
                              "as_expected": caught, "failed": [] if hung else [f[:160] for f in failed]}), flush=True)
            if not caught:
                slipped.append(name)
    if slipped:
        print(f"fault_check: not as expected: {slipped}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
