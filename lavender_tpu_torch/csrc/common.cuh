// Shared definitions of the port's CUDA kernels (sm_90a).
//
// Every entry point has a plain C interface (bound from Python with ctypes,
// lavender_tpu_torch/ops/_build.py), launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError() so that a refused launch
// is reported where it happened.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define LVT_EXPORT extern "C" __attribute__((visibility("default")))

namespace lvt {

// The widest row of the row-resident primitives: the scalar and chunk LNs
// (layernorm.cu) and the tile GEMM's row kernel (gemm_tc.cu) each have a
// template instance for C <= 1024 (Swin-B) and one for C <= kMaxRowC
// (Swin-L's stage 4, C = 1536); wider rows are refused.  Mirrored by
// lavender_tpu_torch/ops/_build.py MAX_ROW_C.
constexpr int kMaxRowC = 2048;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 8 bf16 (one 16-byte vector) <-> 8 floats.
__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float2 t = __bfloat1622float2(p[e]);
    f[2 * e] = t.x;
    f[2 * e + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) p[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
  return u;
}

}  // namespace lvt
