// Planar -> blocked relayout of the motion search's window field.
//
// Replaces the Pallas TPU kernel tiler_tpu/kernels/blockify.py::
// blockify_field (the call at :46). F [HP, WP, K] -> out [mh, mw, 64, K]
// with HP = 8 mh, WP = 8 mw: output row (m, n, 8 sy + sx) is input row
// (8 m + sy, 8 n + sx). The TPU kernel moved [1, 8, tw, 8, K] blocks
// through VMEM with K on lanes; here there is no staging at all. K is the
// motion search's ranking depth, 3 r^2 for r = 1..8 (3, 12, ..., 192).
//
// What bounds it on an H100: bytes. It computes nothing, so its least
// time is 2 * HP * WP * K * 2 bytes over the memory rate (808 MB at 720p,
// radius 32, K = 192: about 0.24 ms at 3.35 TB/s; 12.6 MB at K = 3,
// about 4 us, less than the launch from the host takes).
//
// The design moves runs of eight rows. The output rows (m, n, 8 sy + 0..7)
// are the input rows (8 m + sy, 8 n + 0..7): eight rows, contiguous on
// both sides, 8 * K * 2 = 16 K bytes, and both runs start at a multiple
// of 16 K bytes from their tensor's base. So a run is exactly K 16-byte
// vectors on both sides, for any K: each thread moves one vector, and
// consecutive threads move consecutive vectors of a run, then of the next
// output run, so the writes are one contiguous stream and the reads whole
// runs. No depth needs a 2-byte tail. The grid strides over all vectors;
// nothing is reused, so shared memory is not used.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
blockify_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                int mw, int K, int n_vec) {
  // 32-bit index math: the launcher keeps n_vec + the grid's stride
  // below INT_MAX
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n_vec;
       i += gridDim.x * kThreads) {
    const int run = i / K;  // output run (m, n, sy): 8 rows, K vectors
    const int v = i - run * K;
    const int sy = run & 7;
    const int mn = run >> 3;
    const int m = mn / mw;
    const int n = mn - m * mw;
    out[i] = in[((m * 8 + sy) * mw + n) * K + v];
  }
}

}  // namespace

// in: [8 mh, 8 mw, K] 2-byte elements; out: [mh, mw, 64, K]; any K >= 1.
// Both must start on a 16-byte boundary (the wrapper checks it).
extern "C" int blockify_launch(const void* in, void* out, int mh, int mw,
                               int K, void* stream) {
  if (mh <= 0 || mw <= 0 || K <= 0) return 0;
  // a run of 8 rows is 16 K bytes: K vectors of 16 bytes
  const long long n_vec = (long long)mh * mw * 8 * K;
  const long long max_blocks = 132LL * 16;  // 16 blocks per SM
  if (n_vec > INT_MAX - max_blocks * kThreads) return (int)cudaErrorInvalidValue;
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  blockify_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)in, (uint4*)out, mw, K, (int)n_vec);
  return (int)cudaGetLastError();
}
