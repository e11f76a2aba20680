// Probe of the dropout hash (dropout.cuh): writes the bits of a grid of
// (stream, index) counters, so that a test can hold the kernels' bits
// against the PyTorch version (lavender_tpu_torch/ops/dropout.py) bit for
// bit.  Not on any model path.
#include "common.cuh"
#include "dropout.cuh"

namespace {

__global__ void dropout_bits_kernel(const int64_t* __restrict__ seed, uint32_t* __restrict__ out,
                                    int n_stream, int n_index) {
  const size_t n = (size_t)n_stream * n_index;
  const uint32_t s = (uint32_t)(*seed);
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const uint32_t stream = (uint32_t)(e / n_index), index = (uint32_t)(e % n_index);
    out[e] = lvt::dropout_bits(lvt::dropout_key(s, stream), index);
  }
}

}  // namespace

// out[s * n_index + i] = bits(key(*seed, s), i) for s < n_stream, i < n_index;
// seed is an int64 on the device (its low 32 bits are used).
LVT_EXPORT int lvt_dropout_bits(const void* seed, void* out, int n_stream, int n_index,
                                void* stream) {
  if (n_stream <= 0 || n_index <= 0) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)n_stream * n_index;
  const int blocks = (int)((n + 255) / 256 < 132 * 8 ? (n + 255) / 256 : 132 * 8);
  dropout_bits_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(seed), static_cast<uint32_t*>(out), n_stream, n_index);
  return (int)cudaGetLastError();
}
