// Thomas Knoll ordered dithering of corpus tiles through their palettes.
//
// Replaces the Pallas TPU kernel tiler_tpu/kernels/tk_dither.py::tk_select
// (body _make_kernel). Per pixel: 64 error-feedback steps, each a scan of
// the tile's S palette colors for the first minimum of
//   pen = (dr^2 + dg^2 + db^2) * 13 + trunc(dluma / 1000)^2 * 32
// against the target t = src + trunc(err * 9 / 100); the pick's luma and
// step form the key luma * 64 + step (distinct), and the output is the pick
// whose key has rank equal to the pixel's mirrored Bayer value. All
// integer, bit-identical to the plain version; C's `/` truncates toward
// zero like Pascal `div`.
//
// What bounds it on an H100: instruction issue. A launch at T = 116,097
// tiles, S = 16 scans 7.6e9 (pixel, step, color) triples and moves 4 bytes
// a pixel, so memory is idle and every instruction of the color scan
// counts. Each of an SM's four schedulers issues one warp instruction a
// clock; measured on this kernel's variants, an integer multiply-add
// (IMAD) holds the scheduler for two clocks and every other instruction
// of the scan for one (the loop's time is its IMADs x 2 + the rest,
// within 2%). So the design counts issue slots, and an IMAD twice.
//
// The design: 10.5 issue slots a triple (the first version took ~30
// instructions, half of them IMADs, compares and selects).
//
// 1. Ranges. |err| <= 63 * 255 = 16,065 when a target is formed, so
//    t = src + trunc(err * 9 / 100) lies in [-1,445, 1,700]. Colors are
//    0..255 and their luma 299 r + 587 g + 114 b <= 255,000, so |d| <=
//    1,700 per channel, dist = dr^2 + dg^2 + db^2 <= 8.67e6, |dluma| <=
//    1.7e6, q = |trunc(dluma / 1000)| <= 1,700, and
//    pen <= 13 * 8.67e6 + 32 * 1,700^2 = 205,190,000 < 2^28.
// 2. One min a color. With S <= 16 the scan keeps min(16 * pen + slot) in
//    one unsigned word (< 2^32 by 1.): the lower slot wins a tie, which is
//    the first minimum of the strict `<` scan. For S in 17..32 the slot
//    needs 5 bits and the key is 64 bits wide (a slower instantiation).
// 3. The distance as an fp32 dot product. dist = |t|^2 + |p|^2 - 2 t.p,
//    and |t|^2 is the same for every color of a step. A color's row is
//    (|p|^2 + 1.5 * 2^23, -2 r, -2 g, -2 b) as floats; three fused
//    multiply-adds with the target leave 1.5 * 2^23 + d, d = |p|^2 - 2 t.p
//    in [-2.6e6, 2.4e6], and every partial sum is an integer in [2^23,
//    2^24): exact, and the float's bit pattern is 0x4B400000 + d. The
//    integer side takes the bits as they are: 208 * bits = 208 d + 208 *
//    0x4B400000 (mod 2^32), and the constant joins the step's bias (4.).
// 4. trunc(dluma / 1000) without a division. Only its square is used, so
//    q = floor(|dluma| / 1000). dluma is formed in fp32 (both lumas are
//    integers below 2^24: exact), and one fused multiply-add rounding
//    toward zero, fma_rz(|dluma|, 0.001f, 2^23), leaves 2^23 + q in a
//    float whose bit pattern is B = 0x4B000000 + q: the fp32 nearest to
//    0.001 is 0.001 * (1 + 4.75e-8), above 0.001, so n * 0.001f lies in
//    [n / 1000, n / 1000 + 1e-4) for n <= 1.7e6 and its floor is exact at
//    and between the multiples of 1000. B * B = q^2 + (junk << 24) in 32
//    bits, and the junk leaves through the top when shifted left by 9:
//    key = 208 * bits + ((B * B + bias) << 9 | slot)  (mod 2^32), with
//    bias = ceil((208 |t|^2 - 208 * 0x4B400000 mod 2^32) / 512) once per
//    step, is 16 * pen + slot plus a slack below 512 that is a multiple of
//    16 and the same for every color of the step: order, ties and the slot
//    bits are those of 16 * pen + slot, and 16 * 205,190,000 + 526 < 2^32.
//    The shift is a funnel shift whose other word holds slot << 23, so
//    that it cannot become a third IMAD.
// 5. Invalid colors leave the scan without a test: an invalid row is a
//    copy of the first valid row, slot included, so it never changes the
//    minimum. A palette without a valid color scans black rows of slot 0,
//    the TPU kernel's result.
// 6. No key list. A pick determines its luma, so a pixel keeps a count per
//    slot (and its 64 picks as bytes, both in shared memory) instead of 64
//    keys in registers: the rank-th key is found by walking the tile's
//    slots in luma order over the counts (S steps instead of 24 x 64
//    compares); only a tile that holds two valid colors of equal luma,
//    whose picks interleave by step, also walks its 64 picks.
// 7. Two pixels a thread: a warp is exactly one tile, the two dependent
//    chains overlap, and the 16 rows of the narrow scan stay in registers
//    for all 64 steps (168 registers a thread, no spill; three blocks of
//    four warps an SM, which the scan's independent colors keep busy:
//    capping the registers to raise the occupancy changed nothing at 126
//    and cost 2x with spills at 96 and below).
// 8. The step outside the scan in fp32 as well. Sources, errors and
//    targets are integers below 2^15, exact in fp32; trunc(err * 9 / 100)
//    is copysign(fma_rz(|err|, 0.09f, 2^23) - 2^23, err): the fp32 nearest
//    to 0.09 is 0.09 * (1 + 4e-8), above 0.09, and 9 |err| / 100 has a
//    fraction that is a multiple of 0.01, so the floor is exact for |err|
//    <= 16,320. Luma and |t|^2 (<= 8.67e6) are exact fp32 sums.
//
// Issue slots a triple: 3 FFMA (dot), FADD (dluma), FFMA.RZ (q), IMAD
// (B * B + bias: 2), funnel shift, IMAD (208 * bits + that: 2), half a
// three-input min: 10.5, of which 3 instructions give an int32 result;
// about 45 slots a (pixel, step) outside the scan.
//
// S = 33..256: tk_select_wide_kernel, one kernel for every S of the range
// (GTM writes a slot as a byte), S a run-time argument. Points 1, 3, 4 and
// 8 hold as they are; where the narrow design does not stretch:
// 9. Valid rows compacted in slot order. ceil(S / 32) ballots give each
//    valid slot its position among the nv valid ones; the scan runs over
//    16 * ceil(nv / 16) positions, and a byte map in shared memory turns
//    the picked position back into its slot, once a pick. Positions past
//    nv copy the last valid row, so they lose every tie to it; a palette
//    without a valid color scans 16 black rows of slot 0, the TPU
//    kernel's result. (Point 5's copy of the first valid row cannot stand
//    here: with the slot implicit in the position, an invalid slot below
//    the first valid one would win its ties.) Palettes with unused colors
//    scan fewer rows. The feedback color is read back from the picked
//    row, (r, g, b) = -(row.y, row.z, row.w) / 2, exact.
// 10. Slot bits in the key, by groups of 16 rows. In a group, unrolled, a
//    row's position j is a constant: it rides in the low 4 bits of 16 *
//    pen + slack through the funnel shift's other word (j << 23, as in
//    point 4), and the group's minimum is a plain unsigned min, two keys a
//    three-input min. Once a group, its minimum replaces the running best
//    if it is below the best with the position bits cleared: a strict `<`
//    on 16 * pen + slack, so that a tie keeps the earlier group, which is
//    the lower slot (a compare of whole keys would let a later group's
//    lower position win the tie). The pick is position 16 * group + (best
//    & 15). The slot no longer rides beside every key (3 issue slots a
//    triple before: a compare and two selects).
// 11. No count walk. A pixel's 64 picks are stored as keys
//    ((luma * 64 + step) << 8) | slot; luma <= 255,000, so luma * 64 + 63
//    < 2^24 and a key < 2^32. The 24-bit prefixes are distinct (the step),
//    and the pick of rank mapv is found as the TPU kernel finds it: the
//    greatest prefix v with #{keys < v << 8} <= mapv, built bit by bit
//    (24 x 64 compares on the 64 keys in registers; S x 64 for a walk).
// 12. Shared memory, dynamic: 16 KB of keys a warp, and per scan row its
//    float4, its luma (read four to an LDS.128) and its slot byte, for 16 *
//    ceil(S / 16) rows, four warps (one tile each) a block: 69,824 B at
//    S = 33, 87,296 B at S = 256, above the 48 KB static limit, so the
//    launch opts in (cudaFuncAttributeMaxDynamicSharedMemorySize). At
//    S = 256 two blocks fit an SM (8 warps). The rows are read from shared
//    memory (a broadcast: every lane reads the same row).
// Issue slots a triple in the wide scan: the narrow scan's 10.5, plus its
// row loads (16 LDS.128 of rows and 4 of lumas a group, for the thread's
// two pixels: 0.625) and the group merge (LOP, compare, two selects a
// pixel and group: 0.25): about 11.4, against about 14.5 before points 9
// and 10.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSteps = 64;
constexpr int kWarps = 4;  // tiles per block: a warp owns one tile
constexpr int kNoLuma = 1 << 30;  // luma key of a slot no step can pick
constexpr float kTwo23 = 8388608.0f;

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

// floor(|dluma| / 1000) + 0x4B000000 (point 4 of the header); both lumas
// are integers below 2^24 in magnitude.
__device__ __forceinline__ uint32_t luma_quotient(float lum_t, float lum) {
  return (uint32_t)__float_as_int(__fmaf_rz(fabsf(lum_t - lum), 0.001f, kTwo23));
}

// trunc(err * 9 / 100) of an integer |err| <= 16,320 held in fp32 (point 8)
__device__ __forceinline__ float feedback(float err) {
  return copysignf(__fmaf_rz(fabsf(err), 0.09f, kTwo23) - kTwo23, err);
}

// which = 0: floor(|n| / 1000) of the scan; 1: trunc(n * 9 / 100) of the
// feedback; for n = lo + i
__global__ void trunc_probe_kernel(int* __restrict__ out, int lo, int count, int which) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const float n = (float)(lo + i);
  out[i] = which == 0 ? (int)(luma_quotient(n, 0.0f) - 0x4B000000u) : (int)feedback(n);
}

// One tile's working set. NS is the scan's length (16 or 32 rows).
template <int NS>
struct TileShared {
  float4 row[NS];  // scan rows: (|p|^2 + 1.5 * 2^23, -2 r, -2 g, -2 b)
  float4 fed[NS];  // by slot: the (r, g, b) a pick feeds back
  float lum[NS];   // scan rows: luma
  int row_slot[NS];              // scan rows: slot (NS = 16: slot << 23)
  int luma_key[NS];              // by slot: luma, or kNoLuma + slot if invalid
  uint8_t order[NS];             // slots sorted by (luma key, slot)
  uint8_t count[NS][64];         // per pixel: steps that picked the slot
  uint8_t picks[kSteps][64];     // per pixel: the pick of every step
};

// NS = 16: S <= 16, 32-bit keys 16 * pen + slot. NS = 32: S <= 32, 64-bit.
template <int NS>
__global__ void __launch_bounds__(32 * kWarps)
tk_select_kernel(const uint8_t* __restrict__ pix,      // [T, 64, 3]
                 const uint8_t* __restrict__ mirror,   // [T] h | v << 1
                 const int* __restrict__ pal_idx,      // [T]
                 const int* __restrict__ table,        // [P, S, 8]
                 uint8_t* __restrict__ out,            // [T, 64]
                 int T, int S) {
  constexpr bool kWide = NS > 16;
  __shared__ TileShared<NS> shared[kWarps];
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (tile >= T) return;  // whole warps leave; the rest only sync as warps
  TileShared<NS>& sh = shared[threadIdx.x >> 5];

  // --- the tile's palette: scan rows, feedback colors, luma order --------
  const int* pal = table + (size_t)pal_idx[tile] * S * 8;
  const bool valid = lane < S && pal[lane * 8 + 4] > 0;
  const unsigned vmask = __ballot_sync(0xFFFFFFFFu, valid);
  if (lane < NS) {
    const int src = valid ? lane : (vmask ? __ffs(vmask) - 1 : -1);
    int r = 0, g = 0, b = 0, l = 0, slot = 0;
    if (src >= 0) {
      r = pal[src * 8 + 0];
      g = pal[src * 8 + 1];
      b = pal[src * 8 + 2];
      l = pal[src * 8 + 3];
      slot = src;
    }
    sh.row[lane] = make_float4((float)(r * r + g * g + b * b) + 1.5f * kTwo23,
                               (float)(-2 * r), (float)(-2 * g), (float)(-2 * b));
    sh.lum[lane] = (float)l;
    sh.row_slot[lane] = kWide ? slot : slot << 23;
    sh.fed[lane] = valid ? make_float4((float)r, (float)g, (float)b, 0.0f)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    sh.luma_key[lane] = valid ? l : kNoLuma + lane;
  }
  for (int i = lane; i < NS * 64 / 4; i += 32) ((uint32_t*)sh.count)[i] = 0;
  __syncwarp();
  bool twin = false;  // another slot of the same luma key
  if (lane < NS) {
    const int mine = sh.luma_key[lane];
    int rank = 0;
    for (int s = 0; s < NS; ++s) {
      const int other = sh.luma_key[s];
      rank += other < mine || (other == mine && s < lane);
      twin |= other == mine && s != lane;
    }
    sh.order[rank] = (uint8_t)lane;
  }
  const bool equal_lumas = __any_sync(0xFFFFFFFFu, twin);
  __syncwarp();

  // --- 64 steps for the thread's two pixels ------------------------------
  float sr[2], sg[2], sb[2], er[2], eg[2], eb[2];  // integers, exact in fp32
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t p = (size_t)tile * 64 + lane + 32 * i;
    sr[i] = (float)pix[p * 3 + 0];
    sg[i] = (float)pix[p * 3 + 1];
    sb[i] = (float)pix[p * 3 + 2];
    er[i] = eg[i] = eb[i] = 0.0f;
  }
  // the narrow scan keeps its 16 rows in registers for all 64 steps (96
  // registers); the wide one reads them from shared memory as it goes
  constexpr int kHeld = kWide ? 1 : NS;
  float4 held_row[kHeld];
  float held_lum[kHeld];
  uint32_t held_slot[kHeld];
  if (!kWide) {
#pragma unroll
    for (int s = 0; s < kHeld; ++s) {
      held_row[s] = sh.row[s];
      held_lum[s] = sh.lum[s];
      held_slot[s] = (uint32_t)sh.row_slot[s];
    }
  }
#pragma unroll 1
  for (int c = 0; c < kSteps; ++c) {
    uint32_t bias[2], best[2];
    uint64_t best64[2];
    float tr[2], tg[2], tb[2], lum_t[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tr[i] = sr[i] + feedback(er[i]);
      tg[i] = sg[i] + feedback(eg[i]);
      tb[i] = sb[i] + feedback(eb[i]);
      lum_t[i] = fmaf(tb[i], 114.0f, fmaf(tg[i], 587.0f, tr[i] * 299.0f));
      const float t2 = fmaf(tb[i], tb[i], fmaf(tg[i], tg[i], tr[i] * tr[i]));
      // 208 * 0x4B400000 = 0x24000000 (mod 2^32) rides in on the dot's bits
      bias[i] = ((uint32_t)(208 * __float2int_rz(t2)) - 0x24000000u + 511u) >> 9;
      best[i] = 0xFFFFFFFFu;
      best64[i] = ~0ull;
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float4 row = kWide ? sh.row[s] : held_row[s];
      const float lum = kWide ? sh.lum[s] : held_lum[s];
      // row_slot holds the slot where a funnel shift by 9 drops it into the
      // low bits (slot << 23): the shift stays off the multiplier's pipe
      // (an IMAD costs two issue slots on this card, a shift one)
      const uint32_t slot = kWide ? (uint32_t)sh.row_slot[s] : held_slot[s];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t q = luma_quotient(lum_t[i], lum);
        const uint32_t dot = (uint32_t)__float_as_int(
            fmaf(tb[i], row.w, fmaf(tg[i], row.z, fmaf(tr[i], row.y, row.x))));
        const uint32_t key = dot * 208u
            + __funnelshift_l(kWide ? 0u : slot, q * q + bias[i], 9);
        if (kWide) {
          const uint64_t key64 = ((uint64_t)key << 5) | slot;
          best64[i] = key64 < best64[i] ? key64 : best64[i];
        } else {
          best[i] = min(best[i], key);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int pick = kWide ? (int)(best64[i] & 31) : (int)(best[i] & 15);
      const float4 fed = sh.fed[pick];
      er[i] += sr[i] - fed.x;
      eg[i] += sg[i] - fed.y;
      eb[i] += sb[i] - fed.z;
      sh.count[pick][lane + 32 * i] += 1;
      sh.picks[c][lane + 32 * i] = (uint8_t)pick;
    }
  }

  // --- the pick of rank mapv in the (luma, step) order --------------------
  const int m = mirror[tile];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int px = lane + 32 * i;
    // canonical pixels against a mirrored Bayer map (screen orientation)
    const int y = (m & 2) ? 7 - (px >> 3) : (px >> 3);
    const int x = (m & 1) ? 7 - (px & 7) : (px & 7);
    const int mapv = c_bayer[y * 8 + x];
    // walk the slots in luma order: the first whose running count passes
    // mapv holds the rank; `below` counts the steps of smaller luma
    int seen = 0, below = 0, last_luma = -1, sel = -1, luma = 0, rest = 0;
    for (int j = 0; j < NS; ++j) {
      const int s = sh.order[j];
      const int l = sh.luma_key[s];
      if (l != last_luma) below = seen;
      last_luma = l;
      seen += sh.count[s][px];
      if (sel < 0 && seen > mapv) {
        sel = s;
        luma = l;
        rest = mapv - below;
      }
    }
    if (equal_lumas) {
      // slots of one luma interleave by step: the rest-th of their picks
      for (int c = 0; c < kSteps; ++c) {
        const int pick = sh.picks[c][px];
        if (sh.luma_key[pick] == luma && rest-- == 0) sel = pick;
      }
    }
    out[(size_t)tile * 64 + px] = (uint8_t)sel;
  }
}

constexpr int kWideWarps = 4;  // tiles per block of the wide kernel
constexpr int kGroup = 16;  // rows of a scan group: the slot bits of a key
constexpr int kKeyBytes = kSteps * 64 * 4;  // a warp's keys: [step][pixel]

// the wide kernel's scan rows at palette size S (a whole number of groups)
// and one warp's shared memory: its keys, then per row a float4, a luma
// and a slot byte, then the 16 words j << 23 (points 10 and 12)
__host__ __device__ constexpr int wide_rows(int S) {
  return (S + kGroup - 1) / kGroup * kGroup;
}
__host__ __device__ constexpr int wide_warp_bytes(int S) {
  return kKeyBytes + 21 * wide_rows(S) + 4 * kGroup;
}

// S = 33..256 (points 9-12 of the header); dynamic shared memory of
// kWideWarps * wide_warp_bytes(S) bytes
__global__ void __launch_bounds__(32 * kWideWarps)
tk_select_wide_kernel(const uint8_t* __restrict__ pix,      // [T, 64, 3]
                      const uint8_t* __restrict__ mirror,   // [T] h | v << 1
                      const int* __restrict__ pal_idx,      // [T]
                      const int* __restrict__ table,        // [P, S, 8]
                      uint8_t* __restrict__ out,            // [T, 64]
                      int T, int S) {
  extern __shared__ float4 wide_shared[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.x * kWideWarps + warp;
  if (tile >= T) return;  // whole warps leave; the rest only sync as warps
  const int R = wide_rows(S);
  char* base = reinterpret_cast<char*>(wide_shared) + warp * wide_warp_bytes(S);
  uint32_t* keys = reinterpret_cast<uint32_t*>(base);
  float4* row = reinterpret_cast<float4*>(base + kKeyBytes);
  float* lum = reinterpret_cast<float*>(base + kKeyBytes + 16 * R);
  uint32_t* slot_word = reinterpret_cast<uint32_t*>(base + kKeyBytes + 20 * R);
  uint8_t* slot_of = reinterpret_cast<uint8_t*>(base + kKeyBytes + 20 * R + 4 * kGroup);

  // --- the tile's palette: its valid rows compacted in slot order ---------
  const int* pal = table + (size_t)pal_idx[tile] * S * 8;
  // position pos of the scan holds slot src's color (src < 0: black, slot 0)
  auto put = [&](int pos, int src) {
    int r = 0, g = 0, b = 0, l = 0;
    if (src >= 0) {
      r = pal[src * 8 + 0];
      g = pal[src * 8 + 1];
      b = pal[src * 8 + 2];
      l = pal[src * 8 + 3];
    }
    row[pos] = make_float4((float)(r * r + g * g + b * b) + 1.5f * kTwo23,
                           (float)(-2 * r), (float)(-2 * g), (float)(-2 * b));
    lum[pos] = (float)l;
    slot_of[pos] = (uint8_t)max(src, 0);
  };
  int nv = 0, last = -1;  // the same in every lane: the ballots are the warp's
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const bool valid = s < S && pal[s * 8 + 4] > 0;
    const unsigned vmask = __ballot_sync(0xFFFFFFFFu, valid);
    if (valid) put(nv + __popc(vmask & ((1u << lane) - 1u)), s);
    if (vmask) last = s0 + 31 - __clz((int)vmask);
    nv += __popc(vmask);
  }
  // pad to whole groups with copies of the last valid row (they lose its
  // ties); no valid color: one group of black rows of slot 0
  const int rows = nv ? (nv + kGroup - 1) / kGroup * kGroup : kGroup;
  for (int pos = nv + lane; pos < rows; pos += 32) put(pos, last);
  if (lane < kGroup) slot_word[lane] = (uint32_t)lane << 23;
  __syncwarp();
  // a group's position j rides into the key's low bits through the funnel
  // shift's other word; read from shared memory, so that the compiler
  // cannot fold the constant into a third IMAD (point 10)
  uint32_t word[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) word[j] = slot_word[j];

  // --- 64 steps for the thread's two pixels ------------------------------
  float sr[2], sg[2], sb[2], er[2], eg[2], eb[2];  // integers, exact in fp32
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t p = (size_t)tile * 64 + lane + 32 * i;
    sr[i] = (float)pix[p * 3 + 0];
    sg[i] = (float)pix[p * 3 + 1];
    sb[i] = (float)pix[p * 3 + 2];
    er[i] = eg[i] = eb[i] = 0.0f;
  }
  const int groups = rows / kGroup;
#pragma unroll 1
  for (int c = 0; c < kSteps; ++c) {
    uint32_t bias[2], best[2];
    int best_group[2];
    float tr[2], tg[2], tb[2], lum_t[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tr[i] = sr[i] + feedback(er[i]);
      tg[i] = sg[i] + feedback(eg[i]);
      tb[i] = sb[i] + feedback(eb[i]);
      lum_t[i] = fmaf(tb[i], 114.0f, fmaf(tg[i], 587.0f, tr[i] * 299.0f));
      const float t2 = fmaf(tb[i], tb[i], fmaf(tg[i], tg[i], tr[i] * tr[i]));
      bias[i] = ((uint32_t)(208 * __float2int_rz(t2)) - 0x24000000u + 511u) >> 9;
      best[i] = 0xFFFFFFFFu;  // above every key (point 4): group 0 always wins
      best_group[i] = 0;
    }
#pragma unroll 1
    for (int g = 0; g < groups; ++g) {
      const float4* rg = row + g * kGroup;
      const float4* lg = reinterpret_cast<const float4*>(lum) + g * (kGroup / 4);
      uint32_t gmin[2] = {0xFFFFFFFFu, 0xFFFFFFFFu};
#pragma unroll
      for (int j4 = 0; j4 < kGroup / 4; ++j4) {
        const float4 l4 = lg[j4];  // four rows' lumas in one load
        const float lj[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
        for (int k = 0; k < 4; k += 2) {
          uint32_t key[2][2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = 4 * j4 + k + h;
            const float4 rw = rg[j];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const uint32_t q = luma_quotient(lum_t[i], lj[k + h]);
              const uint32_t dot = (uint32_t)__float_as_int(
                  fmaf(tb[i], rw.w, fmaf(tg[i], rw.z, fmaf(tr[i], rw.y, rw.x))));
              key[i][h] = dot * 208u + __funnelshift_l(word[j], q * q + bias[i], 9);
            }
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) gmin[i] = min(gmin[i], min(key[i][0], key[i][1]));
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // 16 * pen + slack against the best's, position bits cleared: a
        // tie keeps the earlier group (point 10)
        const bool lt = gmin[i] < (best[i] & ~(uint32_t)(kGroup - 1));
        best[i] = lt ? gmin[i] : best[i];
        best_group[i] = lt ? g : best_group[i];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int pos = best_group[i] * kGroup + (int)(best[i] & (kGroup - 1));
      const float4 fed = row[pos];  // (.., -2 r, -2 g, -2 b) of the pick
      er[i] += fmaf(0.5f, fed.y, sr[i]);
      eg[i] += fmaf(0.5f, fed.z, sg[i]);
      eb[i] += fmaf(0.5f, fed.w, sb[i]);
      keys[c * 64 + lane + 32 * i] =
          ((uint32_t)((int)lum[pos] * kSteps + c) << 8) | (uint32_t)slot_of[pos];
    }
  }
  __syncwarp();

  // --- the pick of rank mapv in the (luma, step) order --------------------
  const int m = mirror[tile];
#pragma unroll 1
  for (int i = 0; i < 2; ++i) {
    const int px = lane + 32 * i;
    const int y = (m & 2) ? 7 - (px >> 3) : (px >> 3);
    const int x = (m & 1) ? 7 - (px & 7) : (px & 7);
    const int mapv = c_bayer[y * 8 + x];
    uint32_t k[kSteps];
#pragma unroll
    for (int c = 0; c < kSteps; ++c) k[c] = keys[c * 64 + px];
    uint32_t lo = 0;  // the greatest prefix with at most mapv keys below it
#pragma unroll 1
    for (int bit = 23; bit >= 0; --bit) {
      const uint32_t mid = lo | (1u << bit);
      int below = 0;
#pragma unroll
      for (int c = 0; c < kSteps; ++c) below += k[c] < (mid << 8);
      if (below <= mapv) lo = mid;
    }
    int sel = 0;
#pragma unroll
    for (int c = 0; c < kSteps; ++c) sel = (k[c] >> 8) == lo ? (int)(k[c] & 255u) : sel;
    out[(size_t)tile * 64 + px] = (uint8_t)sel;
  }
}

}  // namespace

extern "C" int tk_select_launch(const void* pix, const void* mirror,
                                const void* pal_idx, const void* table,
                                void* out, int T, int P, int S,
                                void* stream) {
  (void)P;
  if (T <= 0) return 0;
  if (S <= 0 || S > 256) return (int)cudaErrorInvalidValue;
  if (S > 32) {
    const int smem = kWideWarps * wide_warp_bytes(S);
    const cudaError_t attr = cudaFuncSetAttribute(
        tk_select_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return (int)attr;
    tk_select_wide_kernel<<<(T + kWideWarps - 1) / kWideWarps, 32 * kWideWarps, smem,
                            (cudaStream_t)stream>>>(
        (const uint8_t*)pix, (const uint8_t*)mirror, (const int*)pal_idx,
        (const int*)table, (uint8_t*)out, T, S);
    return (int)cudaGetLastError();
  }
  const int blocks = (T + kWarps - 1) / kWarps;
  auto kernel = S <= 16 ? tk_select_kernel<16> : tk_select_kernel<32>;
  kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)pix, (const uint8_t*)mirror, (const int*)pal_idx,
      (const int*)table, (uint8_t*)out, T, S);
  return (int)cudaGetLastError();
}

// For tests: the kernel's two truncating divisions on n = lo .. lo + count
// - 1 (which = 0: floor(|n| / 1000); 1: trunc(n * 9 / 100)), int32 out.
extern "C" int tk_trunc_probe_launch(void* out, int lo, int count, int which,
                                     void* stream) {
  if (count <= 0) return 0;
  trunc_probe_kernel<<<(count + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (int*)out, lo, count, which);
  return (int)cudaGetLastError();
}
