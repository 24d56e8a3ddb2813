// Planar -> blocked relayout of the motion search's window field.
//
// Replaces the Pallas TPU kernel tiler_tpu/kernels/blockify.py::
// blockify_field (the call at :46). F [HP, WP, K] -> out [mh, mw, 64, K]
// with HP = 8 mh, WP = 8 mw: output row (m, n, 8 sy + sx) is input row
// (8 m + sy, 8 n + sx). The TPU kernel moved [1, 8, tw, 8, K] blocks
// through VMEM with K on lanes; here there is no staging at all.
//
// What bounds it on an H100: bytes. It computes nothing, so its least
// time is 2 * HP * WP * K * 2 bytes over the memory rate (808 MB at 720p,
// radius 32, K = 192: about 0.24 ms at 3.35 TB/s). K is contiguous on
// both sides and a row is K * 2 = 384 bytes, so each thread moves one
// 16-byte vector of a row, and consecutive threads move consecutive
// vectors: consecutive output rows (sx = 0..7) come from consecutive
// input rows, so a warp reads and writes whole 512-byte runs. The grid
// strides over all vectors; nothing is reused, so shared memory is not
// used.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
blockify_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                int mw, int vec_per_row, int n_vec) {
  // 32-bit index math: the launcher keeps n_vec + the grid's stride
  // below INT_MAX
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n_vec;
       i += gridDim.x * kThreads) {
    const int row = i / vec_per_row;  // output row (m, n, s)
    const int v = i - row * vec_per_row;
    const int s = row & 63;
    const int mn = row >> 6;
    const int m = mn / mw;
    const int n = mn - m * mw;
    const int src = (m * 8 + (s >> 3)) * (mw * 8) + n * 8 + (s & 7);
    out[i] = in[src * vec_per_row + v];
  }
}

}  // namespace

// in: [8 mh, 8 mw, K] 2-byte elements; out: [mh, mw, 64, K]. K * 2 must
// be a multiple of 16 bytes (the wrapper checks it, and the alignment).
extern "C" int blockify_launch(const void* in, void* out, int mh, int mw,
                               int K, void* stream) {
  if (mh <= 0 || mw <= 0 || K <= 0) return 0;
  if ((K * 2) % 16) return (int)cudaErrorInvalidValue;
  const int vec_per_row = K * 2 / 16;
  const long long n_vec = (long long)mh * mw * 64 * vec_per_row;
  const long long max_blocks = 132LL * 16;  // 16 blocks per SM
  if (n_vec > INT_MAX - max_blocks * kThreads) return (int)cudaErrorInvalidValue;
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  blockify_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)in, (uint4*)out, mw, vec_per_row, (int)n_vec);
  return (int)cudaGetLastError();
}
