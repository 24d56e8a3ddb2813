// Yliluoma2 ordered dithering of corpus tiles through their palettes.
//
// The JAX package runs this ditherer as plain XLA passes
// (tiler_tpu/pipeline/dither.py::yliluoma2_lists) and has no kernel for
// it; this kernel is the port's own. Per pixel it builds the mixing plan
// of DeviseBestMixingPlanYliluoma as the reference's x64 assembly runs it,
// then picks the plan entry at the pixel's mirrored Bayer value:
//
//   while count < mixed:
//     max_test = max(count, 1)
//     for each valid color c (slot order), each k in 1..max_test
//       (total t = count + k):
//       sum  = so_far + k * c4 + k (k - 1) / 2          (4 lanes)
//       mix  = (sum * (65536 div t)) >> 16
//       pen  = 13 |mix.rgb - tgt.rgb|^2 + 32 (mix.l - tgt.l)^2
//     the first least pen (color-major, total-minor) adds k copies of c
//   sort the plan stably by luma; slot = plan[(bayer * count) >> 6]
//
// with c4 = (r, g, b, luma div 1000), tgt = (r, g, b, luma div 1000) of
// the pixel, luma = 299 r + 587 g + 114 b. Bit-identical to the plain
// passes (kernels/yl2_dither.py::yliluoma2_lists).
//
// What bounds it on an H100: instruction issue, as tk_dither.cu. At
// T = 36,307 tiles and S = 256 a plan of 4 takes 4 S or 7 S (color, total)
// trials a pixel, 2.4e9..4.2e9 in all, against 4 bytes a pixel of memory.
//
// 1. Ranges (int32). so_far holds count <= mixed - 1 <= 15 entries of at
//    most 255 a lane, and k <= max_test <= 15. With count >= 1 the total
//    t = count + k >= 2 k, so sum = so_far + k c + k (k - 1) / 2 <= 255 t
//    + t (k - 1) / 4 and mix <= sum / t <= 258 (count = 0 tries k = 1 alone:
//    mix <= 255); mix >= 0. So |mix - tgt| <= 258 and pen <= 258^2 *
//    (3 * 13 + 32) = 4,726,044 < 2^23. Every int32 value of a trial lies in
//    (-2^24, 2^25): sum * (65536 div t) <= 2^16 * 258.5, c * k * (65536
//    div t) <= 255 * 2^16, tgt * 2^16 <= 255 * 2^16. A white palette
//    against a black pixel at mixed = 16 reaches mix = 258 and that pen
//    (the tests' numpy model of this kernel checks it).
// 2. One multiply-add a lane. sum * inv = (so_far + k (k - 1) / 2) * inv
//    + c * (k * inv), and floor(x / 2^16) - tgt = (x - tgt * 2^16) >> 16
//    (arithmetic shift), so per (k, lane) the thread forms once
//    kinv = k * inv and base = (so_far + k (k - 1) / 2) * inv - tgt << 16,
//    and a trial is d = (c * kinv + base) >> 16 on each lane.
// 3. One min a trial. pen < 2^23 leaves 9 bits of a 32-bit word: the key
//    512 pen + 16 j + (k - 1) <= 2,419,735,039 < 2^32, j the color's place
//    in a group of 32 (5 bits) and k - 1 <= 14 (4 bits), is unsigned and
//    ordered as the first minimum in (color, total) order within the
//    group. Once a group, its least key replaces the running best if its
//    pen is strictly lower (the best's low 9 bits cleared), so a tie keeps
//    the earlier group, which holds the lower slots.
// 4. Only valid colors, in slot order. A warp's ballots place each valid
//    slot among the nv valid ones (the plain passes' invalid slots never
//    win: their pen is 2^30); positions nv.. up to the next multiple of 32
//    copy the last valid color, so they lose every tie to it. A byte map
//    turns a position back into its slot. A palette without a valid color
//    gives slot 0 everywhere (the plain passes choose slot 0, amount 1,
//    every round) and makes no trial.
// 5. Only admitted totals: k in 1..max_test, never all 2 mixed.
// 6. Palette in shared memory: the compacted rows (int4, read as one
//    broadcast LDS.128 a trial), their full lumas and slots, ~5.4 KB; the
//    plan as runs (position, amount), one a round, in shared memory
//    (2 KB). One tile a block, one pixel a thread (64 threads); no host
//    synchronisation: the trials are summed on the device (one 64-bit
//    atomic add a warp).
// 7. The pick without a sort. A run i of amount a_i starts at rank
//    sum of a_j over runs j with lum_j < lum_i, or lum_j = lum_i and
//    j < i (the stable order), and the pixel takes the run whose ranks
//    hold (bayer * count) >> 6.
//
// Issue slots a trial: 4 IMAD (lanes), 4 shifts, 4 squares (IMUL/IMAD),
// 2 IMAD for the key, a min and the row load: ~26, two of every
// multiply-add's issue slots counted.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;  // one pixel a thread, one tile a block
constexpr int kGroup = 32;    // colors a group: 5 bits of the key
constexpr int kMaxS = 256;
constexpr int kMaxMixed = 16;  // at most one run a round, mixed rounds

__constant__ int c_bayer[64] = {
    0, 48, 12, 60, 3, 51, 15, 63,
    32, 16, 44, 28, 35, 19, 47, 31,
    8, 56, 4, 52, 11, 59, 7, 55,
    40, 24, 36, 20, 43, 27, 39, 23,
    2, 50, 14, 62, 1, 49, 13, 61,
    34, 18, 46, 30, 33, 17, 45, 29,
    10, 58, 6, 54, 9, 57, 5, 53,
    42, 26, 38, 22, 41, 25, 37, 21,
};

__global__ void __launch_bounds__(kThreads)
yl2_select_kernel(const uint8_t* __restrict__ pix,     // [T, 64, 3]
                  const uint8_t* __restrict__ mirror,  // [T] h | v << 1
                  const int* __restrict__ pal_idx,     // [T]
                  const int4* __restrict__ pal4,       // [P, S] (r, g, b, luma div 1000)
                  const uint8_t* __restrict__ valid,   // [P, S]
                  uint8_t* __restrict__ out,           // [T, 64]
                  unsigned long long* __restrict__ trials,
                  int S, int mixed) {
  __shared__ int4 row[kMaxS];        // valid colors in slot order, padded
  __shared__ int row_lum[kMaxS];     // their lumas (the plan's sort key)
  __shared__ uint8_t row_slot[kMaxS];
  __shared__ uint8_t run_pos[kMaxMixed][kThreads];
  __shared__ uint8_t run_amt[kMaxMixed][kThreads];
  __shared__ int s_nv;
  const int tile = blockIdx.x;
  const int px = threadIdx.x;
  const int lane = px & 31;
  const int p = pal_idx[tile];

  // --- the tile's valid colors, compacted in slot order (point 4) --------
  if (px < 32) {
    int nv = 0;
    for (int base = 0; base < S; base += 32) {
      const int slot = base + lane;
      const bool v = slot < S && valid[(size_t)p * S + slot] != 0;
      const unsigned mask = __ballot_sync(0xffffffffu, v);
      if (v) {
        const int pos = nv + __popc(mask & ((1u << lane) - 1u));
        const int4 c = pal4[(size_t)p * S + slot];
        row[pos] = c;
        row_lum[pos] = c.x * 299 + c.y * 587 + c.z * 114;
        row_slot[pos] = (uint8_t)slot;
      }
      nv += __popc(mask);
    }
    __syncwarp();
    const int padded = (nv + kGroup - 1) / kGroup * kGroup;
    if (nv > 0 && nv + lane < padded) {
      row[nv + lane] = row[nv - 1];
      row_lum[nv + lane] = row_lum[nv - 1];
      row_slot[nv + lane] = row_slot[nv - 1];
    }
    if (lane == 0) s_nv = nv;
  }
  __syncthreads();
  const int nv = s_nv;
  if (nv == 0) {
    out[(size_t)tile * 64 + px] = 0;
    return;
  }
  const int groups = (nv + kGroup - 1) / kGroup;

  // --- the plan ------------------------------------------------------------
  const uint8_t* q = pix + ((size_t)tile * 64 + px) * 3;
  const int tr = q[0], tg = q[1], tb = q[2];
  const int tl = (tr * 299 + tg * 587 + tb * 114) / 1000;
  int so_r = 0, so_g = 0, so_b = 0, so_l = 0;
  int count = 0, runs = 0;
  unsigned my_trials = 0;
  while (count < mixed) {
    const int max_test = count > 0 ? count : 1;
    uint32_t best = 0xffffffffu;
    int best_group = 0;
#pragma unroll 1
    for (int g = 0; g < groups; ++g) {
      uint32_t gmin = 0xffffffffu;
      const int4* grow = row + g * kGroup;
#pragma unroll 1
      for (int k = 1; k <= max_test; ++k) {
        const int inv = 65536 / (count + k);
        const int kinv = k * inv;
        const int bias = (k * (k - 1)) >> 1;
        const int br = (so_r + bias) * inv - (tr << 16);
        const int bg = (so_g + bias) * inv - (tg << 16);
        const int bb = (so_b + bias) * inv - (tb << 16);
        const int bl = (so_l + bias) * inv - (tl << 16);
        const uint32_t kk = (uint32_t)(k - 1);
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const int4 c = grow[j];
          const int dr = (c.x * kinv + br) >> 16;
          const int dg = (c.y * kinv + bg) >> 16;
          const int db = (c.z * kinv + bb) >> 16;
          const int dl = (c.w * kinv + bl) >> 16;
          const uint32_t rgb = (uint32_t)(dr * dr + dg * dg + db * db);
          const uint32_t key = rgb * (13u << 9) + (uint32_t)(dl * dl) * (32u << 9) +
                               (((uint32_t)j << 4) | kk);
          gmin = min(gmin, key);
        }
      }
      if (gmin < (best & ~511u)) {  // point 3: strictly lower pen
        best = gmin;
        best_group = g;
      }
    }
    const int pos = best_group * kGroup + (int)((best >> 4) & 31u);
    const int amount = (int)(best & 15u) + 1;
    const int4 c = row[pos];
    so_r += c.x * amount;
    so_g += c.y * amount;
    so_b += c.z * amount;
    so_l += c.w * amount;
    run_pos[runs][px] = (uint8_t)pos;
    run_amt[runs][px] = (uint8_t)amount;
    ++runs;
    count += amount;
    my_trials += (unsigned)(nv * max_test);
  }

  // --- the pick: the run holding rank (bayer * count) >> 6 (point 7) -------
  const int m = mirror[tile];
  const int y = (m & 2) ? 7 - (px >> 3) : (px >> 3);
  const int x = (m & 1) ? 7 - (px & 7) : (px & 7);
  const int rank = (c_bayer[y * 8 + x] * count) >> 6;
  int sel = 0;
  for (int i = 0; i < runs; ++i) {
    const int li = row_lum[run_pos[i][px]];
    int start = 0;
    for (int j = 0; j < runs; ++j) {
      const int lj = row_lum[run_pos[j][px]];
      start += (lj < li || (lj == li && j < i)) ? run_amt[j][px] : 0;
    }
    if (start <= rank && rank < start + run_amt[i][px]) sel = row_slot[run_pos[i][px]];
  }
  out[(size_t)tile * 64 + px] = (uint8_t)sel;

  unsigned long long sum = my_trials;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
  if (lane == 0) atomicAdd(trials, sum);
}

}  // namespace

// Slots for every pixel of T tiles in one launch; adds the (color, total)
// trials made to *trials (a device counter the caller zeroes).
extern "C" int yl2_select_launch(const void* pix, const void* mirror, const void* pal_idx,
                                 const void* pal4, const void* valid, void* out,
                                 void* trials, int T, int P, int S, int mixed,
                                 void* stream) {
  (void)P;
  if (T <= 0) return 0;
  if (S <= 0 || S > kMaxS || mixed < 1 || mixed > kMaxMixed) return (int)cudaErrorInvalidValue;
  yl2_select_kernel<<<T, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)pix, (const uint8_t*)mirror, (const int*)pal_idx, (const int4*)pal4,
      (const uint8_t*)valid, (uint8_t*)out, (unsigned long long*)trials, S, mixed);
  return (int)cudaGetLastError();
}
