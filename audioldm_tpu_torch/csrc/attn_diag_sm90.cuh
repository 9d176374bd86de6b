// The kernel of K7-K10 on the Hopper forward loop (flash_fwd_sm90.cuh
// `fwd_body`, the loop that K1 runs), its launch and its head-dim dispatch,
// shared by attn_diag_sm90.cu (K7), attn_diag_grid3_sm90.cu (K9) and
// attn_diag_k8_k10_sm90.cu (K8, K10): three sources, so that nvcc builds
// them at once.
#pragma once

#include "flash_fwd_sm90.cuh"

namespace fwd_sm90 {

// CTAs an SM the registers are sized for: Cfg::MINB with two consumer
// warpgroups a CTA (K1's instance), twice as many with one
template <int DP, Fwd V, int NWG>
constexpr int min_blocks() {
  return NWG == 2 ? Cfg<DP>::MINB : 2 * Cfg<DP>::MINB;
}

template <int DP, Fwd V, int NWG>
__global__ void __launch_bounds__(Team<NWG>::NTHREADS, min_blocks<DP, V, NWG>()) attn_diag_sm90_kernel(
    const __grid_constant__ CUtensorMap tmk, const __grid_constant__ CUtensorMap tmv,
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o, int H, int N, int D, Strides s, float qscale,
    float lscale, int kb) {
  fwd_body<DP, V, NWG>(tmk, tmv, q, o, nullptr, H, N, N, D, s, qscale, lscale, kb);
}

template <int DP, Fwd V, int NWG>
int launch(const CUtensorMap& tk, const CUtensorMap& tv, const __nv_bfloat16* q, __nv_bfloat16* o, int B, int H, int N,
           int D, const Strides& s, float qscale, float lscale, int kb, cudaStream_t st) {
  constexpr int smem = CfgOf<DP, V>::SMEM;
  static const cudaError_t attr =
      cudaFuncSetAttribute(attn_diag_sm90_kernel<DP, V, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((N + Team<NWG>::BM - 1) / Team<NWG>::BM, B * H);
  attn_diag_sm90_kernel<DP, V, NWG><<<grid, Team<NWG>::NTHREADS, smem, st>>>(tk, tv, q, o, H, N, D, s, qscale, lscale,
                                                                              kb);
  return (int)cudaGetLastError();
}

template <Fwd V, int NWG>
int dispatch(const CUtensorMap& tk, const CUtensorMap& tv, const __nv_bfloat16* q, __nv_bfloat16* o, int B, int H,
             int N, int D, const Strides& s, float qscale, float lscale, int kb, cudaStream_t st) {
  if (D <= 16) return launch<16, V, NWG>(tk, tv, q, o, B, H, N, D, s, qscale, lscale, kb, st);
  if (D <= 32) return launch<32, V, NWG>(tk, tv, q, o, B, H, N, D, s, qscale, lscale, kb, st);
  if (D <= 64) return launch<64, V, NWG>(tk, tv, q, o, B, H, N, D, s, qscale, lscale, kb, st);
  return launch<128, V, NWG>(tk, tv, q, o, B, H, N, D, s, qscale, lscale, kb, st);
}

}  // namespace fwd_sm90
