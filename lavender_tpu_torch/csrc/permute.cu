// Row permutation with zeroed rows (K2):  out[b, r, :] = index[r] < 0 ? 0 : in[b, index[r], :].
//
// Replaces lavender_tpu/ops/wm_permute.py _perm_kernel: the Swin cyclic shift
// in window-major coordinates [B, nW * Npad, C] is one static row permutation
// whose window tail-pad rows are zero, and its vjp is the same gather with the
// inverse index.  The TPU kernel unrolled a list of contiguous row runs at
// trace time; here the host builds the int32 index once per (geometry, shift,
// direction) and the kernel gathers rows by it.
//
// Bound on the card: device-memory bandwidth, one read and one write of the
// tensor (8.1 MB at Swin-B stage 3, B = 4, bf16: 2.4 us at 3.35 TB/s).
// Design: a flat grid over the output's 16-byte vectors.  A block of 256
// threads owns a fixed span of whole output rows (1024 vectors, 16 KB: 64
// rows of a 256-byte stage-1 bf16 row, 16 of a 1 KB stage-3 one), stages the
// span's source-row offsets in shared memory once, and every thread issues
// its 4 vector loads before its first store, so all 32 lanes of a warp work
// at any row width and 16 KB is in flight per block even where the shift is
// short (stage 3 and 2: 248 and 496 blocks).  A zero row is stored without a
// load.  The element type does not matter (bf16 or f32 rows), only that a
// row is a multiple of 16 bytes.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;                   // 16-byte loads a thread issues before it stores
constexpr int kSpan = kThreads * kVecs;    // vectors a block owns (at most)

__global__ void __launch_bounds__(kThreads)
    permute_rows_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                        const int* __restrict__ index, int R, int V, int rows_per_block,
                        long rows) {
  __shared__ long from[kSpan];  // vector offset of each owned row's source, -1 for a zero row
  const long row0 = (long)blockIdx.x * rows_per_block;
  const int n_rows = (int)min((long)rows_per_block, rows - row0);
  for (int i = threadIdx.x; i < n_rows; i += kThreads) {
    const long row = row0 + i;
    const long b = row / R;
    const int s = index[row - b * R];
    from[i] = s < 0 ? -1 : (b * R + s) * V;
  }
  __syncthreads();
  const int span = n_rows * V;
  uint4* out = dst + row0 * V;
  for (int e0 = 0; e0 < span; e0 += kSpan) {
    uint4 v[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int e = e0 + threadIdx.x + u * kThreads;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (e < span) {
        const int r = e / V;
        const long s = from[r];
        if (s >= 0) v[u] = __ldg(src + s + (e - r * V));
      }
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int e = e0 + threadIdx.x + u * kThreads;
      if (e < span) out[e] = v[u];
    }
  }
}

}  // namespace

// src, dst [B, R, row_bytes / 16] 16-byte vectors; index int32 [R] with
// -1 for a zeroed row.  row_bytes % 16 == 0.
LVT_EXPORT int lvt_permute_rows(const void* src, void* dst, const void* index, int B, int R,
                                int row_bytes, void* stream) {
  if (B <= 0 || R <= 0 || row_bytes <= 0 || row_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  const int V = row_bytes / 16;
  const int rows_per_block = V >= kSpan ? 1 : kSpan / V;
  const long rows = (long)B * R;
  const long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  permute_rows_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), static_cast<const int*>(index), R,
      V, rows_per_block, rows);
  return (int)cudaGetLastError();
}
