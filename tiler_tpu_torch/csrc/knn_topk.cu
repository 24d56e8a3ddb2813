// Fused corpus distance + per-bucket top-2 for the phase-A KNN.
//
// Replaces the Pallas TPU kernel tiler_tpu/kernels/knn_topk.py::
// knn_bucket_topk2 (the call at :149, body _kernel2). The folded bf16
// operands make the GEMM emit the true squared distance: cell rows are
// [-2f, |f|^2 hi, |f|^2 lo, 1, 1, 0...] and corpus columns
// [ds, 1, 1, |ds|^2 hi, |ds|^2 lo, 0...] over KDA = 208. Each distance is
// clamped at 0 and packed into the key (float bits & ~0x1FF) | lane
// (lane = index inside its 512-tile bucket, so ties go to the low index);
// per cell and bucket only the smallest and second-smallest key leave the
// kernel. The [cells, T] distance matrix never reaches device memory.
//
// What bounds it on an H100: arithmetic. 2 * 208 flops per (cell, tile)
// pair against 2 bytes of output per pair-bucket; at 14,400 cells and
// 80k tiles that is ~0.5 TFLOP per frame. This first version runs the
// GEMM on the fp32 FMA pipes (bf16 products are exact in fp32, and the
// sum accumulates in fp32): a block of 256 threads owns 64 cells x one
// 512-tile bucket, walks the bucket in 128-column sub-tiles, and stages
// K-chunks of 16 of both operands in shared memory (converted to fp32
// once per chunk). Each thread holds a 4 x 8 accumulator and a running
// top-2 for its 4 cells; the 16 threads that share a cell merge their
// top-2s with warp shuffles. Tensor cores (mma/wgmma) and TMA are later
// work.
//
// The same kernel, instantiated with kV1 = true, replaces the v1 Pallas
// kernel tiler_tpu/kernels/knn_topk.py::knn_bucket_topk (the call at
// :204, body _kernel :47, _sortable :41), which the knn_backend
// "pallas_v1" setting selects. It multiplies the plain bf16 features
// [Np, 192] by the transposed corpus [192, Tp] (12 K-chunks of 16) and
// ranks on d = d2[t] - 2 <f, ds_t> in f32, without the |f|^2 term, so d
// is often negative: the key takes the sortable image of the float bits,
// u ^ ((u >> 31) & 0x7FFFFFFF), which orders as the floats do under a
// signed int compare, before the lane goes into its low 9 bits. Its
// bound is the same as B2's: 2 * 192 flops per (cell, tile) pair, ~0.45
// TFLOP at 14,400 cells x 81,920 padded tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kKDA = 208;  // folded contraction depth (B2)
constexpr int kKD = 192;   // plain feature depth (v1)
constexpr int kTB = 512;   // corpus tiles per bucket
constexpr int kBM = 64;    // cells per block
constexpr int kBN = 128;   // bucket columns per sub-tile
constexpr int kKC = 16;    // K chunk staged in shared memory
constexpr int kThreads = 256;

__device__ __forceinline__ void top2_insert(int key, int& m1, int& m2) {
  if (key < m1) {
    m2 = m1;
    m1 = key;
  } else if (key < m2) {
    m2 = key;
  }
}

// kV1 = false: B2 on the folded operands, fa [Np, KDA] and dsTa [KDA,
// Tp], key of max(d, 0). kV1 = true: v1 on fa [Np, KD] and dsTa [KD, Tp]
// with d = d2[t] - 2 * dot and the sortable key (d2 is unused by B2).
template <bool kV1>
__global__ void __launch_bounds__(kThreads)
knn_bucket_top2_kernel(const __nv_bfloat16* __restrict__ fa,    // [Np, depth]
                       const __nv_bfloat16* __restrict__ dsTa,  // [depth, Tp]
                       const float* __restrict__ d2,            // [Tp] (v1)
                       int* __restrict__ k1,                    // [nb, Np]
                       int* __restrict__ k2,                    // [nb, Np]
                       int Np, int Tp) {
  constexpr int kDepth = kV1 ? kKD : kKDA;
  __shared__ float As[kKC][kBM];
  __shared__ float Bs[kKC][kBN];
  const int cell0 = blockIdx.x * kBM;
  const int bucket = blockIdx.y;
  const int tx = threadIdx.x & 15;  // column group: cols tx + 16 j
  const int ty = threadIdx.x >> 4;  // row group: rows 4 ty + i

  int m1[4], m2[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m1[i] = m2[i] = INT_MAX;

  for (int sub = 0; sub < kTB / kBN; ++sub) {
    const int col0 = bucket * kTB + sub * kBN;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < kDepth; k0 += kKC) {
      for (int e = threadIdx.x; e < kBM * kKC; e += kThreads) {
        const int r = e / kKC, k = e % kKC;
        As[k][r] = __bfloat162float(fa[(size_t)(cell0 + r) * kDepth + k0 + k]);
      }
      for (int e = threadIdx.x; e < kKC * kBN; e += kThreads) {
        const int k = e / kBN, c = e % kBN;
        Bs[k][c] = __bfloat162float(dsTa[(size_t)(k0 + k) * Tp + col0 + c]);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kKC; ++k) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int lane = sub * kBN + tx + 16 * j;
        int u;
        if (kV1) {
          // 2 * dot is exact, so this is the one f32 rounding of d2 - 2 dot
          u = __float_as_int(d2[col0 + tx + 16 * j] - 2.f * acc[i][j]);
          u ^= (u >> 31) & 0x7FFFFFFF;  // sortable: signed order = float order
        } else {
          u = __float_as_int(fmaxf(acc[i][j], 0.f));
        }
        top2_insert((u & ~0x1FF) | lane, m1[i], m2[i]);
      }
  }

  // merge the 16 column groups of each row (lanes tx of one half-warp)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const int o1 = __shfl_xor_sync(0xffffffffu, m1[i], off);
      const int o2 = __shfl_xor_sync(0xffffffffu, m2[i], off);
      const int n2 = min(max(m1[i], o1), min(m2[i], o2));
      m1[i] = min(m1[i], o1);
      m2[i] = n2;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t o = (size_t)bucket * Np + cell0 + ty * 4 + i;
      k1[o] = m1[i];
      k2[o] = m2[i];
    }
  }
}

}  // namespace

extern "C" int knn_bucket_top2_launch(const void* fa, const void* dsTa,
                                      void* k1, void* k2, int Np, int Tp,
                                      void* stream) {
  if (Np <= 0 || Tp <= 0) return 0;
  if (Np % kBM || Tp % kTB) return (int)cudaErrorInvalidValue;
  const dim3 grid(Np / kBM, Tp / kTB);
  knn_bucket_top2_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)fa, (const __nv_bfloat16*)dsTa, nullptr,
      (int*)k1, (int*)k2, Np, Tp);
  return (int)cudaGetLastError();
}

extern "C" int knn_bucket_top2_v1_launch(const void* fb, const void* dsT,
                                         const void* d2, void* k1, void* k2,
                                         int Np, int Tp, void* stream) {
  if (Np <= 0 || Tp <= 0) return 0;
  if (Np % kBM || Tp % kTB) return (int)cudaErrorInvalidValue;
  const dim3 grid(Np / kBM, Tp / kTB);
  knn_bucket_top2_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)fb, (const __nv_bfloat16*)dsT, (const float*)d2,
      (int*)k1, (int*)k2, Np, Tp);
  return (int)cudaGetLastError();
}
