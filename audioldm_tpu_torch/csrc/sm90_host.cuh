// Host side of the TMA kernels (flash_fwd_sm90.cu, flash_bwd_sm90.cu,
// flash_attention.cu): the encoding of a tensor map over a bf16 or fp32
// head view, with libcuda's cuTensorMapEncodeTiled looked up at run time
// through the CUDA runtime, so that no -lcuda link is needed.
#pragma once

#include <cuda.h>  // CUtensorMap and the encoder's argument types (nothing of libcuda is linked)
#include <cuda_runtime.h>

namespace sm90 {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the installed libcuda, looked up through the
// runtime; null if it has none
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// the 4-D map (d, h, n, b) of a [B, H, N, D] head view with element
// strides sb, sh, sn, boxes of (box_d, 1, box_n, 1); `elem` bytes an element
// (2: bf16, 4: fp32); swizzled to the box row (32, 64 or 128 bytes), or not
// at all with `swizzle` false; elements past N and D read as zeros
inline int encode(CUtensorMap* map, const void* ptr, int B, int H, int N, int D, long long sb, long long sh,
                  long long sn, int box_d, int box_n, int elem = 2, bool swizzle = true) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(sh * elem), (cuuint64_t)(sn * elem), (cuuint64_t)(sb * elem)};
  const cuuint32_t box[4] = {(cuuint32_t)box_d, 1, (cuuint32_t)box_n, 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const int row = box_d * elem;
  const CUtensorMapSwizzle sw = !swizzle ? CU_TENSOR_MAP_SWIZZLE_NONE
                                : row == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                : row == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_128B;
  const CUresult r = fn(map, elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace sm90
