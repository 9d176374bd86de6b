"""Time design variants of the bf16 K4/K5 kernels (``csrc/flash_bwd_sm90.cu``)
against the shipped ones, on one NVIDIA GPU.

    python -m audioldm_tpu_torch.tools.flash_bwd_sm90_variants [variant ...]

Each variant is a copy of ``csrc/`` with a few lines of the kernels
replaced, built by ``kernels._build`` into its own directory under
``_build/`` and timed in its own process: K4 (``flash_bwd_dkv``) and K5
(``flash_bwd_dq``) at the shapes below, as the profiler's device time of a
call (the mean over 20), after a check against ``flash_bwd_plain`` where the
variant still computes the gradients. One JSON line per variant and shape,
with the card's name and power limit (and, built with
``AUDIOLDM_NVCC_FLAGS="-Xptxas -v"``, ptxas's registers, spills and
warnings of each variant). ``no_exp2``, ``no_ds_pack``, ``no_packs`` and
``products_only`` take work out of the elementwise step (they compute no
gradients), so that the split says whether the SFU's exp2, the bf16 packs
or the products set the floor; ``products_only_ss_acc`` times K4's
accumulating products with A read from shared memory instead of
registers.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from audioldm_tpu_torch.tools.flash_sm90_variants import device_ms

SHAPES = ((2, 8, 4096, 16), (2, 8, 4000, 16))
_EXP = ("      p[i] = ex2(s[a] - l2[a]);\n", "      p[i] = s[a] - l2[a];\n")
_PACK_P = ("      pa[jj][k] = pack_bf16(p[2 * k], p[2 * k + 1]);\n",
           "      pa[jj][k] = __float_as_uint(p[2 * k]) ^ __float_as_uint(p[2 * k + 1]);\n")
_PACK_DS = ("      da[jj][k] = pack_bf16(ds[2 * k], ds[2 * k + 1]);\n",
            "      da[jj][k] = __float_as_uint(ds[2 * k]) ^ __float_as_uint(ds[2 * k + 1]);\n")
_NARROW_Q = ("static constexpr int BQ = DP <= 32 ? 64 : DP == 64 ? 32 : 16;", "static constexpr int BQ = DP <= 64 ? 32 : 16;")
_NARROW_KV = ("static constexpr int BN = DP <= 64 ? 64 : 32;", "static constexpr int BN = DP <= 32 ? 32 : DP <= 64 ? 64 : 32;")
_TWO_CTAS = [("__launch_bounds__(NTHREADS, 1) flash_bwd_dkv_sm90_kernel(", "__launch_bounds__(NTHREADS, 2) flash_bwd_dkv_sm90_kernel("),
             ("__launch_bounds__(NTHREADS, 1) flash_bwd_dq_sm90_kernel(", "__launch_bounds__(NTHREADS, 2) flash_bwd_dq_sm90_kernel(")]
_THREE_WG = ("constexpr int NWG = 2;", "constexpr int NWG = 3;")
_PRODUCTS_ONLY = [("      p[i] = ex2(s[a] - l2[a]);\n      ds[i] = p[i] * (dp[a] - dl[a]) * scale;\n"
                   "      if (!whole && (c < lo || c >= hi)) p[i] = ds[i] = 0.f;  // masked column\n",
                   "      p[i] = s[a];\n      ds[i] = dp[a];\n"),
                  _PACK_P, _PACK_DS]
# K4's dV and dK products at d = 16 with A read from shared memory (the q2
# and dO tiles, so the values are wrong): does a wgmma with A from a
# descriptor cost less than one with A from registers?
_SS_ACC = [("namespace {\n\nusing namespace sm90;\n", """namespace {

using namespace sm90;

__device__ __forceinline__ void wgmma_ss_n16_tb1(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
    "{\\n.reg .pred p;\\nsetp.ne.b32 p, %10, 0;\\n"
    "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
    "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 1;\\n}\\n"
    : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
    : "l"(a), "l"(b), "r"(1));
}
"""), ("""      Wgmma<DP, 1>::run(dva, pa[j], mo[j], 1);
      Wgmma<DP, 1>::run(dka, da[j], mq[j], 1);""", """      if constexpr (DP == 16) {
        wgmma_ss_n16_tb1(dva, mq[j], mo[j]);
        wgmma_ss_n16_tb1(dka, mo[j], mq[j]);
      } else {
        Wgmma<DP, 1>::run(dva, pa[j], mo[j], 1);
        Wgmma<DP, 1>::run(dka, da[j], mq[j], 1);
      }""")]
# name -> [(text of the shipped source, its replacement)]
VARIANTS = {
    "shipped": [],
    # P = s - lse2 without the exp2 (no MUFU.EX2)
    "no_exp2": [_EXP],
    # dS kept as two fp32 words xor-ed into one, no cvt.rn.bf16x2 (F2FP) for it
    "no_ds_pack": [_PACK_DS],
    # neither P nor dS packed
    "no_packs": [_PACK_P, _PACK_DS],
    # the products and the ring alone: P = S, dS = dP, no mask, no packs
    "products_only": _PRODUCTS_ONLY,
    # the same, K4's dV and dK products with A from shared memory at d = 16
    # (the q2 and dO tiles stand in for P^T and dS^T: wrong values)
    "products_only_ss_acc": _PRODUCTS_ONLY + _SS_ACC,
    # a 2-stage ring instead of 4
    "two_stages": [("constexpr int STAGES = 4;", "constexpr int STAGES = 2;")],
    # one P/dS register set: no elementwise work under the accumulating products
    "no_overlap": [("  static constexpr bool OVL = DP <= 64;  // two P/dS register sets in turn\n",
                    "  static constexpr bool OVL = false;  // two P/dS register sets in turn\n"),
                   ("  static constexpr bool OVL = DP <= 64;\n  using T = Tile<DP, BN>;\n",
                    "  static constexpr bool OVL = false;\n  using T = Tile<DP, BN>;\n")],
    # the two consumer warpgroups issue their products whenever they are ready
    "no_pingpong": [('  asm volatile("bar.sync %0, 256;\\n" ::"r"(1 + wg) : "memory");\n', ""),
                    ('  asm volatile("bar.arrive %0, 256;\\n" ::"r"(1 + (wg + 1) % NWG) : "memory");\n', "")],
    # three consumer warpgroups a CTA (192 rows; registers capped at 152 a thread)
    "three_wg": [_THREE_WG],
    # 32-row tiles at d <= 32 (K4's q tile, K5's kv tile): fewer registers
    "narrow": [_NARROW_Q, _NARROW_KV],
    # registers sized for two CTAs an SM (112 a thread)
    "two_ctas": _TWO_CTAS,
    # both
    "narrow_two_ctas": [_NARROW_Q, _NARROW_KV, *_TWO_CTAS],
}
COMPUTES_GRADIENTS = {"shipped", "two_stages", "no_overlap", "no_pingpong", "three_wg", "narrow", "two_ctas", "narrow_two_ctas"}


def run_variant(name: str) -> None:
    import torch

    from audioldm_tpu_torch.kernels import _build
    from audioldm_tpu_torch.kernels import flash_attention as fa

    if VARIANTS[name]:
        root = os.path.join(_build.BUILD_DIR, "variants_bwd", name)
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(_build.CSRC, os.path.join(root, "csrc"))
        path = os.path.join(root, "csrc", "flash_bwd_sm90.cu")
        with open(path) as f:
            text = f.read()
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: the text to replace occurs {text.count(old)} times")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        _build.CSRC, _build.BUILD_DIR = os.path.join(root, "csrc"), os.path.join(root, "build")
    _build.build_all(("flash_bwd_sm90",))
    ptxas = [ln.strip() for ln in _build.logs.get("flash_bwd_sm90", "").splitlines()
             if "registers" in ln or "spill" in ln or "warning" in ln.lower()]
    if ptxas:  # with AUDIOLDM_NVCC_FLAGS="-Xptxas -v"
        print(json.dumps({"variant": name, "ptxas": ptxas}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, h, n, d in SHAPES:
        q, k, v, dout = (torch.randn(b, n, h * d, device="cuda", generator=gen).bfloat16().view(b, n, h, d).transpose(1, 2)
                         for _ in range(4))
        q2 = fa.prescale(q)
        o, lse = fa.flash_fwd_lse_plain(q2, k, v)
        delta = (dout.float() * o.float()).sum(dim=-1).contiguous()
        out = {"variant": name, "shape": [b, h, n, d]}
        if name in COMPUTES_GRADIENTS:
            dk, dv = fa.flash_bwd_dkv(q2, k, v, dout, lse, delta)
            dq = fa.flash_bwd_dq(q2, k, v, dout, lse, delta)
            for key, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), fa.flash_bwd_plain(q2, k, v, o, lse, dout)):
                out[f"{key}_max_abs_err"] = (got.double() - ref.double()).abs().max().item()
        out["k4_device_ms"] = device_ms(torch, lambda: fa.flash_bwd_dkv(q2, k, v, dout, lse, delta))
        out["k5_device_ms"] = device_ms(torch, lambda: fa.flash_bwd_dq(q2, k, v, dout, lse, delta))
        print(json.dumps(out), flush=True)


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_sm90_variants: no CUDA GPU available", file=sys.stderr)
        return 1
    if len(argv) == 2 and argv[0] == "--one":
        run_variant(argv[1])
        return 0
    names = argv or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"flash_bwd_sm90_variants: variants are {', '.join(VARIANTS)}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi.stdout.strip()}), flush=True)
    rc = 0
    for name in names:  # one process a variant: the library of a source is loaded once a process
        try:
            rc = subprocess.run([sys.executable, "-m", "audioldm_tpu_torch.tools.flash_bwd_sm90_variants", "--one", name],
                                timeout=600).returncode or rc
        except subprocess.TimeoutExpired:
            print(json.dumps({"variant": name, "error": "did not finish in 600 s"}), flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
