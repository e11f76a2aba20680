// Row permutation with zeroed rows (K2):  out[b, r, :] = index[r] < 0 ? 0 : in[b, index[r], :].
//
// Replaces lavender_tpu/ops/wm_permute.py _perm_kernel: the Swin cyclic shift
// in window-major coordinates [B, nW * Npad, C] is one static row permutation
// whose window tail-pad rows are zero, and its vjp is the same gather with the
// inverse index.  The TPU kernel unrolled a list of contiguous row runs at
// trace time; here the host builds the int32 index once per (geometry, shift,
// direction) and each warp copies one row.
//
// Bound on the card: device-memory bandwidth, one read and one write of the
// tensor.  Design: one warp per output row, its lanes on consecutive 16-byte
// vectors of the row (coalesced on both sides; a Swin row is 256 B to 4 KB),
// the row's source read once per warp, no division per vector.  The element
// type does not matter (bf16 or f32 rows), only that a row is a multiple of
// 16 bytes.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
    permute_rows_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                        const int* __restrict__ index, int R, int V, long rows) {
  const long row = blockIdx.x * (long)kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long b = row / R;
  const int s = index[row - b * R];
  uint4* out = dst + row * V;
  if (s < 0) {
    for (int v = lane; v < V; v += 32) out[v] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const uint4* in = src + (b * R + s) * V;
  for (int v = lane; v < V; v += 32) out[v] = in[v];
}

}  // namespace

// src, dst [B, R, row_bytes / 16] 16-byte vectors; index int32 [R] with
// -1 for a zeroed row.  row_bytes % 16 == 0.
LVT_EXPORT int lvt_permute_rows(const void* src, void* dst, const void* index, int B, int R,
                                int row_bytes, void* stream) {
  if (B <= 0 || R <= 0 || row_bytes <= 0 || row_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  const long rows = (long)B * R;
  const long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  permute_rows_kernel<<<(unsigned)blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), static_cast<const int*>(index), R,
      row_bytes / 16, rows);
  return (int)cudaGetLastError();
}
