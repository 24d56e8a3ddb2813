// Fused corpus distance + per-bucket top-2 for the phase-A KNN, on
// Hopper's tensor cores.
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
// The same kernel, instantiated with kV1 = true, replaces the v1 Pallas
// kernel tiler_tpu/kernels/knn_topk.py::knn_bucket_topk (the call at
// :204, body _kernel :47, _sortable :41), which the knn_backend
// "pallas_v1" setting selects: plain bf16 features [Np, 192] times the
// transposed corpus [192, Tp], ranked on d = d2[t] - 2 <f, ds_t> in f32
// (one rounding: 2 * dot is exact), whose sortable image
// u ^ ((u >> 31) & 0x7FFFFFFF) orders as the floats do under a signed
// compare, before the lane goes into its low 9 bits.
//
// What bounds it on an H100: the product, 2 * 208 (B2) or 2 * 192 (v1)
// flops per (cell, tile) pair, ~0.4 TFLOP a launch at 8,192 cells x
// 118,784 padded tiles, against ~5 integer operations of key packing and
// top-2 per pair. The design:
// - The product runs on the tensor cores: bf16 wgmma.m64n128k16 with f32
//   accumulators in registers. A (the cells) is K-major, B (the corpus
//   [depth, Tp], tiles contiguous) is MN-major through wgmma's transpose
//   bit, so the corpus needs no relayout.
// - A block owns 256 cells (kBM) and a contiguous range of buckets. Its
//   cell tile stays resident in shared memory for the whole range, laid
//   out by TMA as k16 slabs [256 rows x 32 B] with the 32-byte swizzle,
//   so a depth of 208 (13 slabs, not a multiple of the 128-byte swizzle)
//   needs no padding. The corpus streams through a 2-stage ring of
//   [depth x 128] tiles (two TMA boxes of 64 columns, 128-byte swizzle),
//   fed by one producer thread; mbarriers count the bytes in and the
//   consumers out.
// - The grid is 256-cell blocks x bucket ranges, sized to one wave of the
//   SMs; the blocks of one range walk the same buckets in the same order,
//   so each corpus bucket comes from device memory about once and from L2
//   for the other cell blocks. 256 cells a block halve the L2 -> SM
//   traffic of 128 (~1.5 GB a launch for the corpus instead of ~3.1 GB).
// - Two consumer warpgroups own 128 cells each (two m64 tiles, 128 f32
//   accumulators a thread) and run free of each other, within the one
//   tile of slack the 2-stage ring allows. On an H100 the epilogue does
//   not hide behind the other warpgroup's MMAs: the kernel takes about
//   the product's time plus the epilogue's (`scripts/torch_profile.py
//   --knn-breakdown`). Strict turns on the tensor cores through named
//   barriers (signalled after the MMAs completed, or after they were
//   issued) and two partial top-2 chains per row measured no faster.
// - The epilogue keeps a running top-2 per row in registers across the
//   bucket's four column tiles (each row's 128 columns are spread over the
//   4 threads of a quad); two shuffles merge the quad at the bucket's end,
//   and each quad lane stores one of its four rows, so a warp's store is
//   four full 32-byte sectors along the cells.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kKDA = 208;  // folded contraction depth (B2)
constexpr int kKD = 192;   // plain feature depth (v1)
constexpr int kTB = 512;   // corpus tiles per bucket
constexpr int kBM = 256;   // cells per block (two consumer warpgroups)
constexpr int kBN = 128;   // corpus columns per streamed tile
constexpr int kStages = 2;
constexpr int kThreads = 384;  // 2 consumer warpgroups + 1 producer warpgroup
constexpr int kSlab = kBM * 32;  // one k16 slab of the cell tile, bytes

template <int kDepth>
struct Smem {
  static constexpr int kSteps = kDepth / 16;
  static constexpr int kBox = kDepth * 128;  // [depth x 64 columns] bf16
  static constexpr int kStage = 2 * kBox;
  static constexpr int kA = kSteps * kSlab;
  static constexpr int kBars = kA + kStages * kStage;  // 5 mbarriers
  static constexpr int kBytes = kBars + 64 + 1024;     // + alignment slack
};

// kV1 = false: B2 on the folded operands, fa [Np, KDA] and dsTa [KDA,
// Tp], key of max(d, 0). kV1 = true: v1 on fb [Np, KD] and dsT [KD, Tp]
// with d = d2[t] - 2 * dot and the sortable key.
template <int kDepth, bool kV1>
__global__ void __launch_bounds__(kThreads, 1)
knn_top2_wgmma(const __grid_constant__ CUtensorMap map_a,  // cells [Np, depth]
               const __grid_constant__ CUtensorMap map_b,  // corpus [depth, Tp]
               const float* __restrict__ d2,                // [Tp] (v1)
               int* __restrict__ k1, int* __restrict__ k2,  // [nb, Np]
               int Np, int nb, int nsplit) {
  using S = Smem<kDepth>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_a = sm90::smem_u32(smem);
  const uint32_t s_b = s_a + S::kA;
  const uint32_t bar = s_a + S::kBars;  // full[2], empty[2], a_full
  auto full = [&](int st) { return bar + 8 * st; };
  auto empty = [&](int st) { return bar + 16 + 8 * st; };
  const uint32_t a_full = bar + 32;

  const int ncb = Np / kBM;
  const int cb = blockIdx.x % ncb;
  const int split = blockIdx.x / ncb;
  const int b0 = (int)((long long)nb * split / nsplit);
  const int b1 = (int)((long long)nb * (split + 1) / nsplit);
  constexpr int kTilesPerBucket = kTB / kBN;
  const int ntiles = (b1 - b0) * kTilesPerBucket;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      sm90::mbar_init(full(st), 1);
      sm90::mbar_init(empty(st), 256);
    }
    sm90::mbar_init(a_full, 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // producer: the cell tile once, then the bucket range's corpus tiles
    sm90::setmaxnreg_dec<40>();
    if (tid == 256) {
      sm90::mbar_expect_tx(a_full, S::kA);
      for (int s = 0; s < S::kSteps; ++s)
        sm90::tma_load_2d(s_a + s * kSlab, &map_a, a_full, 16 * s, cb * kBM);
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % kStages;
        if (i >= kStages) sm90::mbar_wait(empty(st), ((i / kStages) - 1) & 1);
        const int col = b0 * kTB + i * kBN;
        const uint32_t dst = s_b + st * S::kStage;
        sm90::mbar_expect_tx(full(st), S::kStage);
        sm90::tma_load_2d(dst, &map_b, full(st), col, 0);
        sm90::tma_load_2d(dst + S::kBox, &map_b, full(st), col + 64, 0);
      }
    }
  } else {
    // consumers: warpgroup wg owns cells wg*128 .. wg*128+127 of the block
    sm90::setmaxnreg_inc<232>();
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int quad = lane & 3;
    // A: K-major k16 slabs, rows 32 B apart, 8-row groups 256 B apart
    const uint64_t desc_a = sm90::make_desc(s_a + wg * 128 * 32, 16, 256, sm90::kSwizzle32B);
    constexpr uint64_t kA64 = (64 * 32) >> 4;    // next 64 rows
    constexpr uint64_t kASlab = kSlab >> 4;      // next k16 slab
    // B: MN-major, 64-column boxes kBox apart (leading), 8 K rows 1024 B
    // apart (stride); a k16 step is 16 rows of 128 B
    const uint64_t desc_b0 = sm90::make_desc(s_b, S::kBox, 1024, sm90::kSwizzle128B);
    constexpr uint64_t kBStage = S::kStage >> 4;
    constexpr uint64_t kBStep = 2048 >> 4;

    float acc0[64], acc1[64];
    int m1[4], m2[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) m1[r] = m2[r] = INT_MAX;
#pragma unroll
    for (int r = 0; r < 64; ++r) acc0[r] = acc1[r] = 0.f;

    sm90::mbar_wait(a_full, 0);
    for (int i = 0; i < ntiles; ++i) {
      const int st = i % kStages;
      sm90::mbar_wait(full(st), (i / kStages) & 1);
      sm90::fence_regs(acc0);
      sm90::fence_regs(acc1);
      sm90::wgmma_fence();
      const uint64_t db = desc_b0 + st * kBStage;
#pragma unroll
      for (int s = 0; s < S::kSteps; ++s) {
        const uint64_t da = desc_a + s * kASlab;
        sm90::wgmma_m64n128k16_bf16_tb(acc0, da, db + s * kBStep, s > 0);
        sm90::wgmma_m64n128k16_bf16_tb(acc1, da + kA64, db + s * kBStep, s > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(acc0);
      sm90::fence_regs(acc1);
      sm90::mbar_arrive(empty(st));

      // epilogue: accumulator 4j + 2h + c of m64 tile mi holds row
      // 64 mi + 16 warp + lane/4 + 8 h, column 8j + 2 quad + c
      const int t = i % kTilesPerBucket;
      const int bucket = b0 + i / kTilesPerBucket;
      const int lane0 = t * kBN + 2 * quad;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float2 dd = make_float2(0.f, 0.f);
        if (kV1) dd = __ldg(reinterpret_cast<const float2*>(d2 + bucket * kTB + lane0 + 8 * j));
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int lane_idx = lane0 + 8 * j + c;
#pragma unroll
          for (int slot = 0; slot < 4; ++slot) {
            const int r = 4 * j + 2 * (slot & 1) + c;
            const float v = slot < 2 ? acc0[r] : acc1[r];
            int u;
            if (kV1) {
              // 2 * v is exact, so this is the one f32 rounding of d2 - 2 dot
              u = __float_as_int((c ? dd.y : dd.x) - 2.f * v);
              u ^= (u >> 31) & 0x7FFFFFFF;  // sortable: signed order = float order
            } else {
              u = max(__float_as_int(v), 0);  // the bits of max(v, 0)
            }
            const int key = (u & ~0x1FF) | lane_idx;
            m2[slot] = min(m2[slot], max(m1[slot], key));
            m1[slot] = min(m1[slot], key);
          }
        }
      }

      if (t == kTilesPerBucket - 1) {
        // merge the quad's four column sets, then lane `quad` stores row slot `quad`
#pragma unroll
        for (int slot = 0; slot < 4; ++slot) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            const int o1 = __shfl_xor_sync(0xffffffffu, m1[slot], off);
            const int o2 = __shfl_xor_sync(0xffffffffu, m2[slot], off);
            m2[slot] = min(max(m1[slot], o1), min(m2[slot], o2));
            m1[slot] = min(m1[slot], o1);
          }
        }
        const int v1 = quad == 0 ? m1[0] : quad == 1 ? m1[1] : quad == 2 ? m1[2] : m1[3];
        const int v2 = quad == 0 ? m2[0] : quad == 1 ? m2[1] : quad == 2 ? m2[2] : m2[3];
        const int row = wg * 128 + 64 * (quad >> 1) + 16 * warp + (lane >> 2) + 8 * (quad & 1);
        const size_t o = (size_t)bucket * Np + (size_t)cb * kBM + row;
        k1[o] = v1;
        k2[o] = v2;
#pragma unroll
        for (int r = 0; r < 4; ++r) m1[r] = m2[r] = INT_MAX;
      }
    }
  }
}

template <int kDepth, bool kV1>
int launch(const void* cells, const void* corpus, const void* d2, void* k1, void* k2, int Np,
           int Tp, void* stream) {
  if (Np <= 0 || Tp <= 0) return 0;
  if (Np % kBM || Tp % kTB) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)cells | (uintptr_t)corpus | (uintptr_t)d2) % 16)
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap map_a, map_b;
  if (!sm90::bf16_map_2d(&map_a, cells, Np, kDepth, kBM, 16, CU_TENSOR_MAP_SWIZZLE_32B) ||
      !sm90::bf16_map_2d(&map_b, corpus, kDepth, Tp, kDepth, 64, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(knn_top2_wgmma<kDepth, kV1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<kDepth>::kBytes);
  if (err != cudaSuccess) return (int)err;
  // one wave: the cell blocks times as many bucket ranges as the SMs allow
  const int ncb = Np / kBM, nb = Tp / kTB;
  const int nsplit = max(1, min(nb, sms / ncb));
  knn_top2_wgmma<kDepth, kV1><<<ncb * nsplit, kThreads, Smem<kDepth>::kBytes,
                                (cudaStream_t)stream>>>(map_a, map_b, (const float*)d2, (int*)k1,
                                                        (int*)k2, Np, nb, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int knn_bucket_top2_launch(const void* fa, const void* dsTa, void* k1, void* k2,
                                      int Np, int Tp, void* stream) {
  return launch<kKDA, false>(fa, dsTa, nullptr, k1, k2, Np, Tp, stream);
}

extern "C" int knn_bucket_top2_v1_launch(const void* fb, const void* dsT, const void* d2,
                                         void* k1, void* k2, int Np, int Tp, void* stream) {
  return launch<kKD, true>(fb, dsT, d2, k1, k2, Np, Tp, stream);
}
