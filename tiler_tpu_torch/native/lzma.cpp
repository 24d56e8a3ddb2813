// LZMA1 codec (encoder + decoder) for GTM keyframe streams.
//
// Implements the documented LZMA algorithm (range coder, bit-tree
// contexts, rep distances) from the public specification — NOT a port of
// the reference's Pascal LZMA SDK units. Raison d'etre: the reference
// encoder emits lc=8 streams (extern.pas:427 SetLcLpPb(8,0,2)); liblzma
// caps lc<=4, so matching the reference's compression ratio (and decoding
// its demo streams at native speed) needs our own codec.
//
// Container (what decoders/htmljs/lzma.js:397-428 parses):
//   props byte ((pb*5+lp)*9+lc) + dict size (4B LE) + 8x0xFF + data,
//   EOS-terminated (distance 0xFFFFFFFF marker).
//
// Encoder, two parses sharing one probability model:
//   depth < 0: price-based optimal parse (windowed DP), hash-4 chains of
//              depth |depth| — the ratio mode (~0.52 on GTM payloads).
//   depth > 0: LzmaEnc-GetOptimumFast-style lazy greedy over a hash-5
//              chain finder — the throughput mode (~4x faster at ~1.04x
//              the optimal size; branchless range coder, prefetched
//              chain inserts).
//
// The optimal parse is 2-thread capable: the hash-chain match finder
// (the only owner of head/prevp) streams per-position candidate lists
// through an SPSC ring to the price-DP + range coder — the same
// finder/coder split 7-zip's LzmaEnc uses for its 2-thread mode. The
// finder logic is identical inline (threads=1) or on its own thread,
// so output bytes never depend on thread count.
//
// The two threads hand over through the ring's `filled` and `consumed`
// positions. Each side waits on a condition variable that the other side
// notifies at every store of its position, so neither spins and no wakeup
// is lost. The finder's "never lap the consumer" test is written so that
// a consumer ahead of the finder (a long match emitted directly skips
// positions the finder has not reached yet) reads as room to run, not as
// an unsigned wrap to a full ring: that wrap was a deadlock in which both
// threads waited for each other forever.
//
// C ABI for ctypes:
//   gtm_lzma_compress(in, in_len, out, out_cap, lc, lp, pb, dict, depth,
//                     threads)
//   gtm_lzma_decompress(in, in_len, out, out_cap, &consumed, max_out)
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <mutex>
#include <thread>
#include <vector>

namespace {

using u8 = uint8_t;
using u16 = uint16_t;
using u32 = uint32_t;
using u64 = uint64_t;

constexpr u32 kTop = 1u << 24;
constexpr int kNumMoveBits = 5;
constexpr u16 kInitProb = 1024;
constexpr int kNumStates = 12;
constexpr u32 kMinLen = 2;
constexpr u32 kMaxLen = 273;

// ---------------------------------------------------------------------------
// Range encoder
// ---------------------------------------------------------------------------
struct RangeEncoder {
  // Raw-pointer output window into a caller-owned vector: push_back's
  // size check + indirect store per byte was measurable at ~40
  // cycles/output-bit whole-encoder cost; the grow() spill path keeps
  // the worst-case (output > reserved) correct without per-byte vector
  // bookkeeping.
  std::vector<u8>* vec = nullptr;
  u8* op = nullptr;
  u8* oend = nullptr;
  u64 low = 0;
  u32 range = 0xFFFFFFFFu;
  u8 cache = 0;
  u64 cache_size = 1;

  // Reserve `expect` bytes past the vector's current end and point the
  // write cursor there. finish() trims back to what was written.
  void attach(std::vector<u8>& v, size_t expect) {
    vec = &v;
    size_t base = v.size();
    v.resize(base + expect + 4096);
    op = v.data() + base;
    oend = v.data() + v.size() - 16;
  }
  void finish() { vec->resize((size_t)(op - vec->data())); }

  __attribute__((noinline, cold)) void grow() {
    size_t used = (size_t)(op - vec->data());
    vec->resize(vec->size() + vec->size() / 2 + 4096);
    op = vec->data() + used;
    oend = vec->data() + vec->size() - 16;
  }
  inline void put(u8 b) {
    if (__builtin_expect(op >= oend, 0)) grow();
    *op++ = b;
  }

  void shift_low() {
    if ((u32)low < 0xFF000000u || (low >> 32) != 0) {
      u8 carry = (u8)(low >> 32);
      put((u8)(cache + carry));
      while (--cache_size) put((u8)(0xFF + carry));
      cache = (u8)(low >> 24);
    }
    cache_size++;
    low = (u64)((u32)low << 8);  // truncate to 32 bits BEFORE the shift:
    // bits 31..24 are already in `cache`
  }

  void encode_bit(u16* probs, int idx, int bit) {
    // Branchless select: coded bits carry the payload's real entropy, so
    // the 0/1 branch mispredicts roughly at the compression ratio and
    // cost ~15 cycles/bit on this Xeon; arithmetic masking removes it.
    u32 p = probs[idx];
    u32 bound = (range >> 11) * p;
    u32 mask = (u32)(-(int32_t)(bit != 0));
    low += (u64)(bound & mask);
    // bit==0 -> bound; bit==1 -> range - bound (mod 2^32 arithmetic)
    range = bound + ((range - (bound << 1)) & mask);
    u32 d0 = (2048 - p) >> kNumMoveBits;
    u32 d1 = p >> kNumMoveBits;
    probs[idx] = (u16)(p + d0 - ((d0 + d1) & mask));
    if (range < kTop) {
      range <<= 8;
      shift_low();
    }
  }

  void encode_direct(u32 v, int nbits) {
    for (int i = nbits - 1; i >= 0; i--) {
      range >>= 1;
      if ((v >> i) & 1) low += range;
      if (range < kTop) {
        range <<= 8;
        shift_low();
      }
    }
  }

  void bittree(u16* probs, int nbits, u32 sym) {
    u32 m = 1;
    for (int i = nbits - 1; i >= 0; i--) {
      int b = (sym >> i) & 1;
      encode_bit(probs, m, b);
      m = (m << 1) | b;
    }
  }

  void bittree_rev(u16* probs, int nbits, u32 sym) {
    u32 m = 1;
    for (int i = 0; i < nbits; i++) {
      int b = sym & 1;
      sym >>= 1;
      encode_bit(probs, m, b);
      m = (m << 1) | b;
    }
  }

  void flush() {
    for (int i = 0; i < 5; i++) shift_low();
  }
};

// ---------------------------------------------------------------------------
// Length coder (choice + low/mid 3-bit trees per pos state + high 8-bit)
// ---------------------------------------------------------------------------
struct LenCoder {
  u16 choice[2];
  u16 low[16 << 3];
  u16 mid[16 << 3];
  u16 high[256];

  void init() {
    choice[0] = choice[1] = kInitProb;
    for (auto& p : low) p = kInitProb;
    for (auto& p : mid) p = kInitProb;
    for (auto& p : high) p = kInitProb;
  }

  void encode(RangeEncoder& rc, u32 len, u32 pos_state) {
    u32 l = len - kMinLen;
    if (l < 8) {
      rc.encode_bit(choice, 0, 0);
      rc.bittree(low + (pos_state << 3), 3, l);
    } else if (l < 16) {
      rc.encode_bit(choice, 0, 1);
      rc.encode_bit(choice, 1, 0);
      rc.bittree(mid + (pos_state << 3), 3, l - 8);
    } else {
      rc.encode_bit(choice, 0, 1);
      rc.encode_bit(choice, 1, 1);
      rc.bittree(high, 8, l - 16);
    }
  }
};

inline int len_state(u32 len) {
  u32 l = len - kMinLen;
  return l < 3 ? (int)l : 3;
}

// ---------------------------------------------------------------------------
// Bit prices (1/16-bit units), standard LZMA price table construction
// ---------------------------------------------------------------------------
constexpr int kNumBitPriceShiftBits = 4;
constexpr int kNumMoveReducingBits = 4;

struct PriceTable {
  u32 prices[2048 >> kNumMoveReducingBits];
  PriceTable() {
    for (int i = (1 << kNumMoveReducingBits) / 2; i < 2048;
         i += (1 << kNumMoveReducingBits)) {
      // count fractional bits of -log2(i/2048)
      u32 w = (u32)i;
      u32 bit_count = 0;
      for (int j = 0; j < kNumBitPriceShiftBits; j++) {
        w = w * w;
        u32 zeros = 0;
        while (w >= (1u << 16)) {
          w >>= 1;
          zeros++;
        }
        bit_count = (bit_count << 1) + zeros;
      }
      prices[i >> kNumMoveReducingBits] =
          (11u << kNumBitPriceShiftBits) - 15u - bit_count;
    }
  }
  inline u32 p0(u16 prob) const { return prices[prob >> kNumMoveReducingBits]; }
  inline u32 p1(u16 prob) const {
    return prices[(2048 - prob) >> kNumMoveReducingBits];
  }
  inline u32 pb(u16 prob, int bit) const { return bit ? p1(prob) : p0(prob); }
};

static const PriceTable g_prices;

inline u32 tree_price(const u16* probs, int nbits, u32 sym) {
  u32 price = 0;
  u32 m = 1;
  for (int i = nbits - 1; i >= 0; i--) {
    int b = (sym >> i) & 1;
    price += g_prices.pb(probs[m], b);
    m = (m << 1) | b;
  }
  return price;
}

inline u32 tree_rev_price(const u16* probs, int nbits, u32 sym) {
  u32 price = 0;
  u32 m = 1;
  for (int i = 0; i < nbits; i++) {
    int b = sym & 1;
    sym >>= 1;
    price += g_prices.pb(probs[m], b);
    m = (m << 1) | b;
  }
  return price;
}

inline int pos_slot_of(u32 dist) {
  if (dist < 4) return (int)dist;
  int nb = 31 - __builtin_clz(dist);
  return (nb << 1) | ((dist >> (nb - 1)) & 1);
}

// ---------------------------------------------------------------------------
// Encoder
// ---------------------------------------------------------------------------
// Per-position match lists streamed finder -> DP. Slot layout (u32s):
// [0] = count nc, [1..cap] = lens, [1+cap..2cap] = dists; lens strictly
// increasing, so slot[nc] is the longest candidate and slot[cap+nc] its
// distance. fpos/skip_until are producer-private; filled/consumed are
// the SPSC cursors.
struct MatchRing {
  u32 cap = 1, stride = 3;
  size_t ring = 1, mask = 0;
  std::vector<u32> buf;
  std::atomic<size_t> filled{0};
  std::atomic<size_t> consumed{0};
  size_t fpos = 0;
  size_t skip_until = 0;
  // both positions change under `mu` and every change notifies `cv`, so a
  // side that checked its condition under `mu` cannot miss the wakeup
  std::mutex mu;
  std::condition_variable cv;

  void init(int depth) {
    cap = (u32)(depth < 1 ? 1 : (depth > 64 ? 64 : depth));
    stride = 1 + 2 * cap;
    int rbits = 18;  // 256K positions in flight at the default depth
    while ((((size_t)stride << rbits) * 4) > (64u << 20) && rbits > 13)
      rbits--;
    ring = (size_t)1 << rbits;
    mask = ring - 1;
    buf.assign(ring * stride, 0);
  }
  u32* slot(size_t pos) { return &buf[(pos & mask) * stride]; }
  const u32* slot(size_t pos) const { return &buf[(pos & mask) * stride]; }

  // finder: positions < pos hold their candidate lists
  void publish(size_t pos) {
    {
      std::lock_guard<std::mutex> g(mu);
      filled.store(pos, std::memory_order_release);
    }
    cv.notify_all();
  }
  // consumer: positions < pos are no longer read
  void release(size_t pos) {
    {
      std::lock_guard<std::mutex> g(mu);
      consumed.store(pos, std::memory_order_release);
    }
    cv.notify_all();
  }
  // finder may write the slot of pos without lapping the consumer; the
  // consumer may be ahead of pos, so no unsigned difference is taken
  bool room(size_t pos) const {
    return pos + 8 < consumed.load(std::memory_order_acquire) + ring;
  }
  void wait_room(size_t pos) {
    std::unique_lock<std::mutex> lk(mu);
    cv.wait(lk, [&] { return room(pos); });
  }
  // consumer: the published position once it reaches pos1
  size_t wait_filled(size_t pos1) {
    size_t f = filled.load(std::memory_order_acquire);
    if (f >= pos1) return f;
    std::unique_lock<std::mutex> lk(mu);
    cv.wait(lk, [&] {
      f = filled.load(std::memory_order_acquire);
      return f >= pos1;
    });
    return f;
  }
};

struct Encoder {
  int lc, lp, pb;
  u32 pb_mask, lp_mask;
  int depth;

  std::vector<u16> lit;  // 0x300 << (lc+lp)
  u16 is_match[kNumStates << 4];
  u16 is_rep[kNumStates];
  u16 is_rep_g0[kNumStates];
  u16 is_rep_g1[kNumStates];
  u16 is_rep_g2[kNumStates];
  u16 is_rep0_long[kNumStates << 4];
  u16 pos_slot[4 << 6];
  u16 spec_pos[115];
  u16 align_p[16];
  LenCoder len_c, rep_len_c;

  int state = 0;
  u32 reps[4] = {0, 0, 0, 0};

  // hash-4 chain match finder
  static constexpr int kHashBits = 17;
  std::vector<int32_t> head;   // hash -> last pos
  std::vector<int32_t> prevp;  // pos -> previous pos with same hash
  // fast-mode finder: hash-5 chains + head-only hash-4 probe. GTM tile
  // payloads repeat 4-grams massively, so hash-4 chains degenerate into
  // thousands-deep walks (greedy depth 64 measured ~1.2 MB/s); a 5-byte
  // 20-bit hash keeps chain steps meaningful and one closest-4 probe
  // preserves short-match coverage.
#ifndef GTM_H5BITS
#define GTM_H5BITS 20
#endif
  static constexpr int kHash5Bits = GTM_H5BITS;
  std::vector<int32_t> head5;

  // hide the table/candidate misses of the NEXT find under the current
  // token's range-coder work (the finder is ~50% cache-miss stalls)
  void prefetch_find(const u8* data, size_t n, size_t pos) {
    if (pos + 5 > n) return;
    int32_t c5 = head5[hash5(data + pos)];
    if (c5 >= 0) {
      __builtin_prefetch(data + c5);
      __builtin_prefetch(&prevp[c5]);
    }
  }

  Encoder(int lc_, int lp_, int pb_, int depth_)
      : lc(lc_), lp(lp_), pb(pb_), depth(depth_) {
    pb_mask = (1u << pb) - 1;
    lp_mask = (1u << lp) - 1;
    lit.assign((size_t)0x300 << (lc + lp), kInitProb);
    for (auto& p : is_match) p = kInitProb;
    for (auto& p : is_rep) p = kInitProb;
    for (auto& p : is_rep_g0) p = kInitProb;
    for (auto& p : is_rep_g1) p = kInitProb;
    for (auto& p : is_rep_g2) p = kInitProb;
    for (auto& p : is_rep0_long) p = kInitProb;
    for (auto& p : pos_slot) p = kInitProb;
    for (auto& p : spec_pos) p = kInitProb;
    for (auto& p : align_p) p = kInitProb;
    len_c.init();
    rep_len_c.init();
    head.assign(1 << kHashBits, -1);
  }

  static u32 hash4(const u8* p) {
    u32 v;
    memcpy(&v, p, 4);
    return (v * 2654435761u) >> (32 - kHashBits);
  }

  void encode_literal(RangeEncoder& rc, const u8* data, size_t pos) {
    u8 sym = data[pos];
    u8 prev = pos ? data[pos - 1] : 0;
    size_t ctx = (((u32)pos & lp_mask) << lc) + (prev >> (8 - lc));
    u16* probs = lit.data() + 0x300 * ctx;
    u32 m = 1;
    if (state >= 7) {  // matched literal
      u8 match_byte = data[pos - reps[0] - 1];
      int i = 7;
      for (; i >= 0; i--) {
        int match_bit = (match_byte >> i) & 1;
        int bit = (sym >> i) & 1;
        rc.encode_bit(probs, ((1 + match_bit) << 8) + m, bit);
        m = (m << 1) | bit;
        if (match_bit != bit) {
          i--;
          break;
        }
      }
      for (; i >= 0; i--) {
        int bit = (sym >> i) & 1;
        rc.encode_bit(probs, m, bit);
        m = (m << 1) | bit;
      }
    } else {
      for (int i = 7; i >= 0; i--) {
        int bit = (sym >> i) & 1;
        rc.encode_bit(probs, m, bit);
        m = (m << 1) | bit;
      }
    }
    state = state < 4 ? 0 : (state < 10 ? state - 3 : state - 6);
  }

  void encode_dist(RangeEncoder& rc, u32 dist, u32 len) {
    int slot = pos_slot_of(dist);
    rc.bittree(pos_slot + (len_state(len) << 6), 6, (u32)slot);
    if (slot >= 4) {
      int nd = (slot >> 1) - 1;
      u32 base = (2u | (slot & 1)) << nd;
      u32 rest = dist - base;
      if (slot < 14) {
        // note: the base offset is -1 for slot 4 (tree indices start at 1)
        rc.bittree_rev(spec_pos + ((long)base - slot - 1), nd, rest);
      } else {
        rc.encode_direct(rest >> 4, nd - 4);
        rc.bittree_rev(align_p, 4, rest & 15);
      }
    }
  }

  void encode_match(RangeEncoder& rc, u32 pos_state, u32 dist, u32 len) {
    rc.encode_bit(is_match, (state << 4) + pos_state, 1);
    rc.encode_bit(is_rep, state, 0);
    len_c.encode(rc, len, pos_state);
    encode_dist(rc, dist, len);
    reps[3] = reps[2];
    reps[2] = reps[1];
    reps[1] = reps[0];
    reps[0] = dist;
    state = state < 7 ? 7 : 10;
  }

  void encode_rep(RangeEncoder& rc, u32 pos_state, int rep_idx, u32 len) {
    rc.encode_bit(is_match, (state << 4) + pos_state, 1);
    rc.encode_bit(is_rep, state, 1);
    if (rep_idx == 0) {
      rc.encode_bit(is_rep_g0, state, 0);
      rc.encode_bit(is_rep0_long, (state << 4) + pos_state, 1);
    } else {
      rc.encode_bit(is_rep_g0, state, 1);
      if (rep_idx == 1) {
        rc.encode_bit(is_rep_g1, state, 0);
      } else {
        rc.encode_bit(is_rep_g1, state, 1);
        rc.encode_bit(is_rep_g2, state, rep_idx == 3);
        if (rep_idx == 3) {
          u32 d = reps[3];
          reps[3] = reps[2];
          reps[2] = reps[1];
          reps[1] = reps[0];
          reps[0] = d;
          goto done;
        }
        {
          u32 d = reps[2];
          reps[2] = reps[1];
          reps[1] = reps[0];
          reps[0] = d;
        }
        goto done;
      }
      {
        u32 d = reps[1];
        reps[1] = reps[0];
        reps[0] = d;
      }
    }
  done:
    rep_len_c.encode(rc, len, pos_state);
    state = state < 7 ? 8 : 11;
  }

  void encode_shortrep(RangeEncoder& rc, u32 pos_state) {
    rc.encode_bit(is_match, (state << 4) + pos_state, 1);
    rc.encode_bit(is_rep, state, 1);
    rc.encode_bit(is_rep_g0, state, 0);
    rc.encode_bit(is_rep0_long, (state << 4) + pos_state, 0);
    state = state < 7 ? 9 : 11;
  }

  u32 match_len(const u8* data, size_t n, size_t pos, u32 dist) const {
    if (dist + 1 > pos) return 0;
    const u8* a = data + pos;
    const u8* b = a - dist - 1;
    u32 maxl = (u32)((n - pos < kMaxLen) ? (n - pos) : kMaxLen);
    return extend(a, b, maxl);
  }

  // match extension 8 bytes at a time (the byte loop was ~40% of encode
  // time on long tile runs)
  static u32 extend(const u8* a, const u8* b, u32 maxl) {
    u32 l = 0;
    while (l + 8 <= maxl) {
      uint64_t xa, xb;
      memcpy(&xa, a + l, 8);
      memcpy(&xb, b + l, 8);
      uint64_t x = xa ^ xb;
      if (x) return l + (u32)(__builtin_ctzll(x) >> 3);
      l += 8;
    }
    while (l < maxl && a[l] == b[l]) l++;
    return l;
  }

  static u32 hash5(const u8* p) {
    // read exactly the 5 guarded bytes: callers ensure pos + 5 <= n, so
    // an 8-byte load could touch up to 3 bytes past the buffer end
    u64 v = 0;
    memcpy(&v, p, 5);
    return (u32)((v * 0x9E3779B185EBCA87ull) >> (64 - kHash5Bits));
  }

  void insert_fast(const u8* data, size_t n, size_t pos) {
    if (pos + 5 > n) return;
    u32 h = hash5(data + pos);
    prevp[pos] = head5[h];
    head5[h] = (int32_t)pos;
  }

  // insert [lo,hi) into the hash-5 chains, prefetching the head slots a
  // few positions ahead (each insert is a random RMW on a 4MB table)
  void insert_run(const u8* data, size_t n, size_t lo, size_t hi) {
    if (hi > n) hi = n;
    for (size_t p = lo; p < hi; p++) {
      if (p + 9 <= n) __builtin_prefetch(&head5[hash5(data + p + 4)], 1);
      insert_fast(data, n, p);
    }
  }

  // fast-mode best match: hash-5 chain walk only (the closest-4 probe
  // was removed — see the measurement note in the body); stops early at
  // nice_len (LzmaEnc numFastBytes analog). The walk visits candidates
  // most-recent-first, so improvements form a (len, dist) pairs list with
  // both strictly increasing — LzmaEnc's GetOptimumFast runs a trade-down
  // over exactly that list: give up one length when the previous pair's
  // distance is >128x closer (ChangePair), since the longer match's
  // distance slot costs more than a literal saves.
  void find_match_fast(const u8* data, size_t n, size_t pos, u32& best_len,
                       u32& best_dist, u32 nice_len) {
    best_len = 0;
    best_dist = 0;
    if (pos + 4 > n) return;
    u32 maxl = (u32)((n - pos < kMaxLen) ? (n - pos) : kMaxLen);
    u32 plens[40], pdists[40];
    int cnt = 0;
    // no closest-4 probe: measured on real GTM payloads it was ~18% of
    // parse time AND grew output ~1.4% — the len-2/3 near matches it
    // surfaces price worse than literals under the adapted model
    if (pos + 5 <= n) {
      int32_t cand = head5[hash5(data + pos)];
      int d = depth;
      const u8* a = data + pos;
      u32 best = 0;
      while (cand >= 0 && d-- > 0) {
        const u8* b = data + cand;
        if (best == 0 || (best < maxl && b[best] == a[best])) {
          u32 l = extend(a, b, maxl);
          if (l > best) {
            if (cnt == 40) cnt--;  // keep the final (longest) pair exact
            plens[cnt] = l;
            pdists[cnt] = (u32)(pos - cand - 1);
            cnt++;
            best = l;
            if (l >= nice_len || l >= maxl) break;
          }
        }
        cand = prevp[cand];
      }
    }
    if (!cnt) return;
    // GetOptimumFast trade-down (LzmaEnc.c): shorten by one while the
    // previous candidate is exactly 1 shorter at a >128x closer
    // distance. LzmaEnc accepts a >= numFastBytes match immediately
    // without this loop — match that (a traded-down nice_len match
    // would also re-enter the lazy probe and defer, pure waste).
    if (plens[cnt - 1] < nice_len)
      while (cnt > 1 && plens[cnt - 1] == plens[cnt - 2] + 1 &&
             change_pair(pdists[cnt - 2], pdists[cnt - 1]))
        cnt--;
    best_len = plens[cnt - 1];
    best_dist = pdists[cnt - 1];
    if (best_len < 2) best_len = 0;
    // long distances need more length to pay off (price heuristic). On
    // GTM payloads these gates are nearly dead code — the hash-5 finder
    // only surfaces len>=5 matches except on hash collisions (sweeping
    // the len-2 gate 128..4096 moved the bench stream by 0 bytes)
    if (best_len == 2 && best_dist >= 512) best_len = 0;
    if (best_len == 3 && best_dist >= (1u << 15)) best_len = 0;
  }

  // ------------------------------------------------------------------
  // Price functions (1/16-bit units) over the live probability state —
  // the optimal parse picks the cheapest op sequence per window.
  // ------------------------------------------------------------------
  u32 price_len(const LenCoder& lenc, u32 len, u32 ps) const {
    u32 l = len - kMinLen;
    if (l < 8)
      return g_prices.p0(lenc.choice[0]) + tree_price(lenc.low + (ps << 3), 3, l);
    if (l < 16)
      return g_prices.p1(lenc.choice[0]) + g_prices.p0(lenc.choice[1]) +
             tree_price(lenc.mid + (ps << 3), 3, l - 8);
    return g_prices.p1(lenc.choice[0]) + g_prices.p1(lenc.choice[1]) +
           tree_price(lenc.high, 8, l - 16);
  }

  u32 price_dist(u32 dist, u32 len) const {
    int slot = pos_slot_of(dist);
    u32 price = tree_price(pos_slot + (len_state(len) << 6), 6, (u32)slot);
    if (slot >= 4) {
      int nd = (slot >> 1) - 1;
      u32 base = (2u | (slot & 1)) << nd;
      u32 rest = dist - base;
      if (slot < 14) {
        price += tree_rev_price(spec_pos + ((long)base - slot - 1), nd, rest);
      } else {
        price += (u32)(nd - 4) << kNumBitPriceShiftBits;
        price += tree_rev_price(align_p, 4, rest & 15);
      }
    }
    return price;
  }

  // tree-only literal price for states < 7 (no matched-byte path): a pure
  // function of the position while the window's probabilities are frozen,
  // so the optimal parse caches it per window (price_literal was ~10% of
  // encode time, mostly from re-walking the 8-bit tree per relax)
  u32 price_lit_tree(const u8* data, size_t pos) const {
    u8 sym = data[pos];
    u8 prev = pos ? data[pos - 1] : 0;
    size_t ctx = (((u32)pos & lp_mask) << lc) + (prev >> (8 - lc));
    const u16* probs = lit.data() + 0x300 * ctx;
    u32 price = 0;
    u32 m = 1;
    for (int i = 7; i >= 0; i--) {
      int bit = (sym >> i) & 1;
      price += g_prices.pb(probs[m], bit);
      m = (m << 1) | bit;
    }
    return price;
  }

  u32 price_literal(const u8* data, size_t pos, int st, u32 rep0v, u32 ps) const {
    u32 price = g_prices.p0(is_match[(st << 4) + ps]);
    u8 sym = data[pos];
    u8 prev = pos ? data[pos - 1] : 0;
    size_t ctx = (((u32)pos & lp_mask) << lc) + (prev >> (8 - lc));
    const u16* probs = lit.data() + 0x300 * ctx;
    u32 m = 1;
    if (st >= 7) {
      u8 match_byte = data[pos - rep0v - 1];
      int i = 7;
      for (; i >= 0; i--) {
        int match_bit = (match_byte >> i) & 1;
        int bit = (sym >> i) & 1;
        price += g_prices.pb(probs[((1 + match_bit) << 8) + m], bit);
        m = (m << 1) | bit;
        if (match_bit != bit) {
          i--;
          break;
        }
      }
      for (; i >= 0; i--) {
        int bit = (sym >> i) & 1;
        price += g_prices.pb(probs[m], bit);
        m = (m << 1) | bit;
      }
    } else {
      for (int i = 7; i >= 0; i--) {
        int bit = (sym >> i) & 1;
        price += g_prices.pb(probs[m], bit);
        m = (m << 1) | bit;
      }
    }
    return price;
  }

  u32 price_shortrep(int st, u32 ps) const {
    return g_prices.p1(is_match[(st << 4) + ps]) + g_prices.p1(is_rep[st]) +
           g_prices.p0(is_rep_g0[st]) + g_prices.p0(is_rep0_long[(st << 4) + ps]);
  }

  u32 price_rep(int st, u32 ps, int r, u32 len) const {
    u32 price = g_prices.p1(is_match[(st << 4) + ps]) + g_prices.p1(is_rep[st]);
    if (r == 0) {
      price += g_prices.p0(is_rep_g0[st]) + g_prices.p1(is_rep0_long[(st << 4) + ps]);
    } else {
      price += g_prices.p1(is_rep_g0[st]);
      if (r == 1) {
        price += g_prices.p0(is_rep_g1[st]);
      } else {
        price += g_prices.p1(is_rep_g1[st]);
        price += g_prices.pb(is_rep_g2[st], r == 3);
      }
    }
    return price + price_len(rep_len_c, len, ps);
  }

  u32 price_match(int st, u32 ps, u32 len, u32 dist) const {
    return g_prices.p1(is_match[(st << 4) + ps]) + g_prices.p0(is_rep[st]) +
           price_len(len_c, len, ps) + price_dist(dist, len);
  }

  // match candidates at pos: (len, dist) pairs with strictly increasing
  // len; the first chain entry reaching a given len is the closest.
  int collect_matches(const u8* data, size_t n, size_t pos, u32* lens,
                      u32* dists, int cap, u32 h) {
    int cnt = 0;
    if (pos + 4 > n) return 0;
    int32_t cand = head[h];
    int d = depth;
    u32 maxl = (u32)((n - pos < kMaxLen) ? (n - pos) : kMaxLen);
    u32 best = 1;
    while (cand >= 0 && d-- > 0 && cnt < cap) {
      const u8* a = data + pos;
      const u8* b = data + cand;
      if (b[best] == a[best]) {
        u32 l = extend(a, b, maxl);
        if (l > best) {
          lens[cnt] = l;
          dists[cnt] = (u32)(pos - cand - 1);
          cnt++;
          best = l;
          if (l >= maxl) break;
        }
      }
      cand = prevp[cand];
    }
    return cnt;
  }

  // Advance the match finder until `target` positions are published (or
  // n). The finder is the sole owner of head/prevp; it inserts EVERY
  // position and collects candidates outside its own long-match skip
  // window (>=32-byte match skips to its tail-8, the numFastBytes-skip
  // analog — finder-local, so the result is a pure function of the
  // input regardless of which thread runs it).
  void run_finder_until(const u8* data, size_t n, MatchRing& r,
                        size_t target, bool threaded) {
    if (target > n) target = n;
    size_t pos = r.fpos;
    while (pos < target) {
      if (threaded && !r.room(pos)) {
        // never lap the consumer; publish before blocking so it can run
        r.publish(pos);
        r.wait_room(pos);
      }
      u32* s = r.slot(pos);
      int nc = 0;
      if (pos + 4 <= n) {
        // hide the next chain head / candidate misses under this walk
        if (pos + 8 + 4 <= n) {
          int32_t cf = head[hash4(data + pos + 8)];
          if (cf >= 0) {
            __builtin_prefetch(data + cf);
            __builtin_prefetch(&prevp[cf]);
          }
        }
        u32 h = hash4(data + pos);
        if (pos >= r.skip_until)
          nc = collect_matches(data, n, pos, s + 1, s + 1 + r.cap,
                               (int)r.cap, h);
        prevp[pos] = head[h];
        head[h] = (int32_t)pos;
      }
      s[0] = (u32)nc;
      if (nc) {
        u32 lm = s[nc];
        if (lm >= 32 && pos + lm > r.skip_until + 8)
          r.skip_until = pos + lm - 8;
      }
      pos++;
      if (threaded && (pos & 255) == 0) r.publish(pos);
    }
    r.fpos = pos;
    r.publish(pos);
  }

  struct Node {
    u32 price;
    int back;
    u32 op_len;    // 1 = single byte; >= 2 = match/rep
    u32 op_code;   // for len 1: 0 literal, 1 shortrep; for len >= 2:
                   // 0..3 rep index, >= 4: match with dist = op_code - 4
    u8 st;
    u32 reps[4];
  };

  // per-block price caches (probabilities drift slowly; refreshed every
  // 4th 4K window — the LzmaEnc table-refresh approach, coarser cadence)
  u32 len_price_tab[16][kMaxLen + 1];
  u32 rep_len_price_tab[16][kMaxLen + 1];
  u32 slot_price_tab[4][64];
  u32 spec_price_tab[4][128];  // distances < 128 fully cached per len-state
  u32 align_price_tab[16];

  void refresh_price_tables() {
    int nps = 1 << pb;
    for (int ps = 0; ps < nps; ps++)
      for (u32 len = kMinLen; len <= kMaxLen; len++) {
        len_price_tab[ps][len] = price_len(len_c, len, (u32)ps);
        rep_len_price_tab[ps][len] = price_len(rep_len_c, len, (u32)ps);
      }
    for (int ls = 0; ls < 4; ls++)
      for (u32 slot = 0; slot < 64; slot++)
        slot_price_tab[ls][slot] = tree_price(pos_slot + (ls << 6), 6, slot);
    for (u32 a = 0; a < 16; a++)
      align_price_tab[a] = tree_rev_price(align_p, 4, a);
    for (int ls = 0; ls < 4; ls++)
      for (u32 dist = 0; dist < 128; dist++) {
        int slot = pos_slot_of(dist);
        u32 price = slot_price_tab[ls][slot];
        if (slot >= 4) {
          int nd = (slot >> 1) - 1;
          u32 base = (2u | (slot & 1)) << nd;
          price += tree_rev_price(spec_pos + ((long)base - slot - 1), nd,
                                  dist - base);
        }
        spec_price_tab[ls][dist] = price;
      }
  }

  inline u32 price_dist_cached(u32 dist, u32 len) const {
    int ls = len_state(len);
    if (dist < 128) return spec_price_tab[ls][dist];
    int slot = pos_slot_of(dist);
    int nd = (slot >> 1) - 1;
    return slot_price_tab[ls][slot] +
           ((u32)(nd - 4) << kNumBitPriceShiftBits) +
           align_price_tab[dist & 15];
  }

  size_t compress_optimal(const u8* data, size_t n, std::vector<u8>& out,
                          u32 dict_size, int threads = 1) {
    out.push_back((u8)((pb * 5 + lp) * 9 + lc));
    for (int i = 0; i < 4; i++) out.push_back((u8)(dict_size >> (8 * i)));
    for (int i = 0; i < 8; i++) out.push_back(0xFF);

    prevp.assign(n, -1);
    MatchRing ring;
    ring.init(depth);
    bool ahead = threads >= 2;
    std::thread finder;
    if (ahead)
      finder = std::thread(
          [&] { run_finder_until(data, n, ring, n, true); });
    size_t seen = 0;  // consumer-cached `filled` (skips the atomic load)
    auto need = [&](size_t pos1) {
      if (ahead) {
        if (seen < pos1) seen = ring.wait_filled(pos1);
      } else if (ring.fpos < pos1) {
        // inline mode: produce a window's worth ahead in one burst
        run_finder_until(data, n, ring, pos1 + 4095, false);
      }
    };
    RangeEncoder rc;
    rc.attach(out, n + n / 8);

    constexpr int W = 4096;
    constexpr u32 kFastEmit = 128;  // LzmaEnc numFastBytes analog: a match
    // this long at a window boundary is emitted directly (runs collapse to
    // one op per kMaxLen chunk with no DP; once a run is entered, every
    // following window starts inside it and stays on this path)
    std::vector<Node> nodes(W + 1);
    std::vector<int> path;
    std::vector<u32> lit_cache(W);

    size_t pos = 0;
    unsigned win_counter = 0;
    while (pos < n) {
      {
        u32 brl = 0;
        int br = -1;
        for (int r = 0; r < 4; r++) {
          u32 L = match_len(data, n, pos, reps[r]);
          if (L > brl) {
            brl = L;
            br = r;
          }
        }
        u32 ml = 0, md = 0;
        need(pos + 1);
        {
          const u32* s = ring.slot(pos);
          u32 nc = s[0];
          if (nc) {
            ml = s[nc];
            md = s[ring.cap + nc];
          }
        }
        u32 ps2 = (u32)pos & pb_mask;
        if (brl >= kFastEmit && brl + 1 >= ml) {
          encode_rep(rc, ps2, br, brl);
          pos += brl;
          ring.release(pos);
          continue;
        }
        if (ml >= kFastEmit) {
          encode_match(rc, ps2, md, ml);
          pos += ml;
          ring.release(pos);
          continue;
        }
      }
      int B = (int)((n - pos < (size_t)W) ? (n - pos) : (size_t)W);
      // probabilities drift slowly; refreshing every 4th window (16K
      // positions) costs +0.03% size and removes most table-walk time
      // (refresh was 16% of encode in the per-window-refresh profile)
      if ((win_counter++ & 3) == 0) refresh_price_tables();
      for (int i = 0; i < B; i++) lit_cache[i] = 0xFFFFFFFFu;
      for (int i = 0; i <= B; i++) nodes[i].price = 0xFFFFFFFFu;
      nodes[0].price = 0;
      nodes[0].st = (u8)state;
      memcpy(nodes[0].reps, reps, sizeof(reps));

      for (int i = 0; i < B; i++) {
        Node& nd = nodes[i];
        if (nd.price == 0xFFFFFFFFu) continue;
        size_t ap = pos + i;
        u32 ps = (u32)ap & pb_mask;
        int st = nd.st;

        auto relax = [&](int j, u32 price, u32 op_len, u32 op_code, u8 nst,
                         const u32* nreps) {
          if (price < nodes[j].price) {
            nodes[j].price = price;
            nodes[j].back = i;
            nodes[j].op_len = op_len;
            nodes[j].op_code = op_code;
            nodes[j].st = nst;
            memcpy(nodes[j].reps, nreps, 4 * sizeof(u32));
          }
        };

        // literal / shortrep (skipped when i+1 is already cheaper: every
        // op price is strictly positive, so no single-byte op can relax it)
        if (nd.price < nodes[i + 1].price) {
          u8 lit_state = st < 4 ? 0 : (st < 10 ? st - 3 : st - 6);
          u32 litp;
          if (st < 7) {  // no matched-byte path: per-window cacheable
            if (lit_cache[i] == 0xFFFFFFFFu) lit_cache[i] = price_lit_tree(data, ap);
            litp = g_prices.p0(is_match[(st << 4) + ps]) + lit_cache[i];
          } else {
            litp = price_literal(data, ap, st, nd.reps[0], ps);
          }
          relax(i + 1, nd.price + litp, 1, 0, lit_state, nd.reps);
          // shortrep
          if (ap >= nd.reps[0] + 1 && ap > 0 &&
              data[ap] == data[ap - nd.reps[0] - 1]) {
            relax(i + 1, nd.price + price_shortrep(st, ps), 1, 1,
                  (u8)(st < 7 ? 9 : 11), nd.reps);
          }
        }
        // rep matches
        for (int r = 0; r < 4; r++) {
          u32 dd0 = nd.reps[r];
          if (dd0 + 1 > ap || data[ap] != data[ap - dd0 - 1]) continue;
          u32 L = match_len(data, n, ap, nd.reps[r]);
          if (L > (u32)(B - i)) L = (u32)(B - i);
          if (L < 2) continue;
          u32 nreps[4];
          u32 dd = nd.reps[r];
          nreps[0] = dd;
          nreps[1] = nd.reps[r >= 1 ? 0 : 1];
          nreps[2] = nd.reps[r >= 2 ? 1 : 2];
          nreps[3] = nd.reps[r >= 3 ? 2 : 3];
          u8 nst = (u8)(st < 7 ? 8 : 11);
          u32 base = nd.price + price_rep(st, ps, r, 2) - rep_len_price_tab[ps][2];
          const u32* rlp = rep_len_price_tab[ps];
          // long runs: dense lens are practically never optimal mid-cut;
          // relax the short range + the tail (LzmaEnc fast-bytes analog)
#ifndef GTM_DENSE
#define GTM_DENSE 8
#endif  // dense=8 measured 0.1% SMALLER than 32 on GTM payloads (the DP
        // rarely cuts long runs mid-length; the tail relaxes cover it)
          u32 dense = L <= (GTM_DENSE + 8) ? L : GTM_DENSE;
          for (u32 len = 2; len <= dense; len++)
            relax(i + (int)len, base + rlp[len], len, (u32)r, nst, nreps);
          // tail: always relax the full run length (and L-1). The old
          // `L > 40 ? L-1 : L+1` start skipped L entirely for
          // 17 <= L <= 40 — the DP then stitched such rep runs from
          // <=8-byte pieces (3 ops instead of 1)
          if (dense < L)
            for (u32 len = (L - 1 > dense ? L - 1 : dense + 1); len <= L;
                 len++)
              relax(i + (int)len, base + rlp[len], len, (u32)r, nst, nreps);
        }
        // normal matches (candidate lists streamed from the finder;
        // long runs arrive pre-skipped by its finder-local rule)
        need(ap + 1);
        const u32* ms = ring.slot(ap);
        int nc = (int)ms[0];
        const u32* mlens = ms + 1;
        const u32* mdists = ms + 1 + ring.cap;
        u32 prev_len = 1;
        for (int c = 0; c < nc; c++) {
          u32 L = mlens[c];
          u32 dist = mdists[c];
          if (L > (u32)(B - i)) L = (u32)(B - i);
          u32 nreps[4] = {dist, nd.reps[0], nd.reps[1], nd.reps[2]};
          u8 nst = (u8)(st < 7 ? 7 : 10);
          u32 base = nd.price + g_prices.p1(is_match[(st << 4) + ps]) +
                     g_prices.p0(is_rep[st]);
          const u32* lp = len_price_tab[ps];
          u32 lo = prev_len + 1 < 2 ? 2 : prev_len + 1;
          u32 dense = L <= (GTM_DENSE + 8) ? L : (lo + GTM_DENSE < L ? lo + GTM_DENSE : L);
          for (u32 len = lo; len <= dense; len++)
            relax(i + (int)len,
                  base + lp[len] + price_dist_cached(dist, len), len,
                  4 + dist, nst, nreps);
          if (dense < L)
            for (u32 len = L - 1; len <= L; len++)
              relax(i + (int)len,
                    base + lp[len] + price_dist_cached(dist, len), len,
                    4 + dist, nst, nreps);
          prev_len = mlens[c];
        }
      }

      // backtrack
      path.clear();
      for (int j = B; j > 0; j = nodes[j].back) path.push_back(j);

      // emit forward
      for (int k = (int)path.size() - 1; k >= 0; k--) {
        int j = path[k];
        const Node& nd = nodes[j];
        size_t ap = pos + (size_t)nd.back;
        u32 ps = (u32)ap & pb_mask;
        if (nd.op_len == 1) {
          if (nd.op_code == 1) {
            encode_shortrep(rc, ps);
          } else {
            rc.encode_bit(is_match, (state << 4) + (int)ps, 0);
            encode_literal(rc, data, ap);
          }
        } else if (nd.op_code < 4) {
          encode_rep(rc, ps, (int)nd.op_code, nd.op_len);
        } else {
          encode_match(rc, ps, nd.op_code - 4, nd.op_len);
        }
      }
      pos += (size_t)B;
      ring.release(pos);
    }

    ring.release(n);
    if (finder.joinable()) finder.join();

    u32 ps = (u32)pos & pb_mask;
    rc.encode_bit(is_match, (state << 4) + (int)ps, 1);
    rc.encode_bit(is_rep, state, 0);
    len_c.encode(rc, kMinLen, ps);
    encode_dist(rc, 0xFFFFFFFFu, kMinLen);
    rc.flush();
    rc.finish();
    return out.size();
  }

  // ChangePair (LzmaEnc): switching to `big` from `small` only pays when
  // the distance grows by less than ~128x
  static bool change_pair(u32 small_d, u32 big_d) { return (big_d >> 7) > small_d; }

  size_t compress(const u8* data, size_t n, std::vector<u8>& out, u32 dict_size) {
    out.push_back((u8)((pb * 5 + lp) * 9 + lc));
    for (int i = 0; i < 4; i++) out.push_back((u8)(dict_size >> (8 * i)));
    for (int i = 0; i < 8; i++) out.push_back(0xFF);

    prevp.assign(n, -1);
    head5.assign(1 << kHash5Bits, -1);
    RangeEncoder rc;
    rc.attach(out, n + n / 8);

    constexpr u32 kNiceLen = 64;  // numFastBytes: a match this long is
    // taken immediately and the chain walk stops early

    size_t pos = 0;
    bool have_next = false;  // cached find at pos (from the lazy probe)
    u32 cached_len = 0, cached_dist = 0;
    while (pos < n) {
      u32 pos_state = (u32)pos & pb_mask;
      // prefetch the lazy-probe hash entries for pos+1: the parse is
      // L3-latency-bound (hash heads + chain links are random 4-16MB
      // accesses), and the probe at pos+1 is almost always taken
      if (pos + 6 <= n) {
        __builtin_prefetch(&head5[hash5(data + pos + 1)]);
      }

      // rep candidates, first-byte prefiltered (a full extend per rep per
      // position was ~a third of greedy time on tile runs)
      int best_rep = -1;
      u32 best_rep_len = 0;
      for (int i = 0; i < 4; i++) {
        u32 d = reps[i];
        if (d + 1 > pos || data[pos] != data[pos - d - 1]) continue;
        u32 L = match_len(data, n, pos, d);
        if (L >= 2 && L > best_rep_len) {
          best_rep_len = L;
          best_rep = i;
        }
      }
      u32 mlen, mdist;
      if (have_next) {
        mlen = cached_len;
        mdist = cached_dist;
        have_next = false;
      } else {
        find_match_fast(data, n, pos, mlen, mdist, kNiceLen);
      }

      // LzmaEnc GetOptimumFast selection rules
      bool use_rep = best_rep_len >= 2 &&
                     (best_rep_len + 1 >= mlen ||
                      (best_rep_len + 2 >= mlen && mdist >= (1u << 9)) ||
                      (best_rep_len + 3 >= mlen && mdist >= (1u << 15)));
      bool use_match = !use_rep && mlen >= 2;
      u32 cur_len = use_rep ? best_rep_len : mlen;

      if ((use_match || use_rep) && cur_len < kNiceLen && pos + 1 < n) {
        // lazy probe at pos+1; the result is reused next iteration when
        // we defer (have_next), so the finder runs once per position
        insert_fast(data, n, pos);
        u32 nlen, ndist;
        find_match_fast(data, n, pos + 1, nlen, ndist, kNiceLen);
        bool defer;
        if (use_rep) {
          defer = nlen > cur_len + 1;
        } else {
          defer = (nlen >= cur_len && ndist < mdist) ||
                  (nlen == cur_len + 1 && !change_pair(mdist, ndist)) ||
                  nlen > cur_len + 1 ||
                  (nlen + 1 >= cur_len && cur_len >= 3 &&
                   change_pair(ndist, mdist));
        }
        if (defer) {
          cached_len = nlen;
          cached_dist = ndist;
          have_next = true;
          if (pos >= reps[0] + 1 && data[pos] == data[pos - reps[0] - 1]) {
            encode_shortrep(rc, pos_state);
          } else {
            rc.encode_bit(is_match, (state << 4) + pos_state, 0);
            encode_literal(rc, data, pos);
          }
          pos += 1;
          continue;
        }
        insert_run(data, n, pos + 1, pos + cur_len);
        prefetch_find(data, n, pos + cur_len);
        if (use_rep) {
          encode_rep(rc, pos_state, best_rep, best_rep_len);
        } else {
          encode_match(rc, pos_state, mdist, mlen);
        }
        pos += cur_len;
        continue;
      }
      if (use_match || use_rep) {
        insert_fast(data, n, pos);
        insert_run(data, n, pos + 1, pos + cur_len);
        prefetch_find(data, n, pos + cur_len);
        if (use_rep) {
          encode_rep(rc, pos_state, best_rep, best_rep_len);
        } else {
          encode_match(rc, pos_state, mdist, mlen);
        }
        pos += cur_len;
        continue;
      }
      // single byte: shortrep if it matches rep0
      insert_fast(data, n, pos);
      prefetch_find(data, n, pos + 1);
      if (pos >= reps[0] + 1 && pos > 0 && data[pos] == data[pos - reps[0] - 1]) {
        encode_shortrep(rc, pos_state);
      } else {
        rc.encode_bit(is_match, (state << 4) + pos_state, 0);
        encode_literal(rc, data, pos);
      }
      pos += 1;
    }

    // EOS marker: match with dist 0xFFFFFFFF, len 2
    u32 pos_state = (u32)pos & pb_mask;
    rc.encode_bit(is_match, (state << 4) + pos_state, 1);
    rc.encode_bit(is_rep, state, 0);
    len_c.encode(rc, kMinLen, pos_state);
    encode_dist(rc, 0xFFFFFFFFu, kMinLen);
    rc.flush();
    rc.finish();
    return out.size();
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// Decoder (mirror of tiler_tpu/bitstream/lzma_py.py, in C++ for speed)
// ---------------------------------------------------------------------------
namespace {

struct RangeDecoder {
  const u8* buf;
  size_t pos, n;
  u32 code = 0, range = 0xFFFFFFFFu;

  bool init() {
    if (pos + 5 > n) return false;
    pos++;  // first byte 0
    for (int i = 0; i < 4; i++) code = (code << 8) | buf[pos++];
    return true;
  }

  int decode_bit(u16* probs, size_t idx) {
    u16 p = probs[idx];
    u32 bound = (range >> 11) * p;
    int bit;
    if (code < bound) {
      range = bound;
      probs[idx] = (u16)(p + ((2048 - p) >> kNumMoveBits));
      bit = 0;
    } else {
      range -= bound;
      code -= bound;
      probs[idx] = (u16)(p - (p >> kNumMoveBits));
      bit = 1;
    }
    if (range < kTop) {
      range <<= 8;
      code = (code << 8) | (pos < n ? buf[pos] : 0);
      pos++;
    }
    return bit;
  }

  u32 decode_direct(int nbits) {
    u32 res = 0;
    for (int i = 0; i < nbits; i++) {
      range >>= 1;
      code -= range;
      u32 t = 0 - (code >> 31);
      code += range & t;
      res = (res << 1) + (t + 1);
      if (range < kTop) {
        range <<= 8;
        code = (code << 8) | (pos < n ? buf[pos] : 0);
        pos++;
      }
    }
    return res;
  }

  u32 bittree(u16* probs, int nbits) {
    u32 m = 1;
    for (int i = 0; i < nbits; i++) m = (m << 1) | decode_bit(probs, m);
    return m - (1u << nbits);
  }

  u32 bittree_rev(u16* probs, int nbits) {
    u32 m = 1, sym = 0;
    for (int i = 0; i < nbits; i++) {
      int b = decode_bit(probs, m);
      m = (m << 1) | b;
      sym |= (u32)b << i;
    }
    return sym;
  }
};

struct LenDec {
  u16 choice[2];
  u16 low[16 << 3];
  u16 mid[16 << 3];
  u16 high[256];
  void init() {
    choice[0] = choice[1] = kInitProb;
    for (auto& p : low) p = kInitProb;
    for (auto& p : mid) p = kInitProb;
    for (auto& p : high) p = kInitProb;
  }
  u32 decode(RangeDecoder& rc, u32 ps) {
    if (!rc.decode_bit(choice, 0)) return rc.bittree(low + (ps << 3), 3);
    if (!rc.decode_bit(choice, 1)) return 8 + rc.bittree(mid + (ps << 3), 3);
    return 16 + rc.bittree(high, 8);
  }
};

}  // namespace

extern "C" {

// Compress `in` into `out` (caller-allocated, out_cap bytes).
// Returns bytes written, or 0 if out_cap too small / bad params.
size_t gtm_lzma_compress(const u8* in, size_t in_len, u8* out, size_t out_cap,
                         int lc, int lp, int pb, u32 dict_size, int depth,
                         int threads) {
  // depth > 0: greedy/lazy with that chain depth;
  // depth < 0: price-based optimal parse with chain depth |depth|.
  // threads <= 0: auto (finder-ahead thread when a second core exists
  // and the payload amortizes thread startup); output bytes are
  // identical at every thread count.
  if (lc < 0 || lc > 8 || lp < 0 || lp > 4 || pb < 0 || pb > 4) return 0;
  bool optimal = depth < 0;
  if (depth == 0) depth = 64;
  if (threads <= 0)
    threads = (std::thread::hardware_concurrency() >= 2 &&
               in_len >= (256u << 10))
                  ? 2
                  : 1;
  Encoder enc(lc, lp, pb, depth < 0 ? -depth : depth);
  std::vector<u8> buf;
  buf.reserve(in_len / 2 + 256);
  if (optimal)
    enc.compress_optimal(in, in_len, buf, dict_size ? dict_size : (1u << 25),
                         threads);
  else
    enc.compress(in, in_len, buf, dict_size ? dict_size : (1u << 25));
  if (buf.size() > out_cap) return 0;
  memcpy(out, buf.data(), buf.size());
  return buf.size();
}

// Decode one EOS-terminated stream at `in`. Writes payload to out
// (out_cap), sets *consumed to input bytes used. Returns payload size,
// (size_t)-1 on a corrupt stream, or (size_t)-2 when out_cap is too
// small (the only retryable failure — callers grow the buffer ONLY on
// -2; treating corruption as growable turned bit-flipped streams into
// multi-GB allocation storms).
size_t gtm_lzma_decompress(const u8* in, size_t in_len, u8* out,
                           size_t out_cap, size_t* consumed) {
  if (in_len < 13) return (size_t)-1;
  int props = in[0];
  if (props >= 9 * 5 * 5) return (size_t)-1;
  int lc = props % 9, lp = (props / 9) % 5, pb = props / 45;
  u64 usize = 0;
  for (int i = 0; i < 8; i++) usize |= (u64)in[5 + i] << (8 * i);
  bool unknown = usize == 0xFFFFFFFFFFFFFFFFull;

  RangeDecoder rc{in, 13, in_len};
  if (!rc.init()) return (size_t)-1;

  std::vector<u16> lit((size_t)0x300 << (lc + lp), kInitProb);
  u16 is_match[kNumStates << 4], is_rep[kNumStates], is_rep_g0[kNumStates],
      is_rep_g1[kNumStates], is_rep_g2[kNumStates],
      is_rep0_long[kNumStates << 4], pos_slot[4 << 6], spec_pos[115],
      align_p[16];
  for (auto& p : is_match) p = kInitProb;
  for (auto& p : is_rep) p = kInitProb;
  for (auto& p : is_rep_g0) p = kInitProb;
  for (auto& p : is_rep_g1) p = kInitProb;
  for (auto& p : is_rep_g2) p = kInitProb;
  for (auto& p : is_rep0_long) p = kInitProb;
  for (auto& p : pos_slot) p = kInitProb;
  for (auto& p : spec_pos) p = kInitProb;
  for (auto& p : align_p) p = kInitProb;
  LenDec len_d, rep_len_d;
  len_d.init();
  rep_len_d.init();

  size_t outp = 0;
  u32 rep0 = 0, rep1 = 0, rep2 = 0, rep3 = 0;
  int state = 0;
  u32 pbm = (1u << pb) - 1, lpm = (1u << lp) - 1;

  for (;;) {
    if (!unknown && outp >= usize) break;
    if (rc.pos > in_len) return (size_t)-1;
    u32 ps = (u32)outp & pbm;
    if (!rc.decode_bit(is_match, ((size_t)state << 4) + ps)) {
      u8 prev = outp ? out[outp - 1] : 0;
      size_t ctx = (((u32)outp & lpm) << lc) + (prev >> (8 - lc));
      u16* probs = lit.data() + 0x300 * ctx;
      u32 sym = 1;
      if (state >= 7) {
        u8 mb = out[outp - rep0 - 1];
        while (sym < 0x100) {
          int match_bit = (mb >> 7) & 1;
          mb <<= 1;
          int bit = rc.decode_bit(probs, ((size_t)(1 + match_bit) << 8) + sym);
          sym = (sym << 1) | bit;
          if (match_bit != bit) break;
        }
      }
      while (sym < 0x100) sym = (sym << 1) | rc.decode_bit(probs, sym);
      if (outp >= out_cap) return (size_t)-2;
      out[outp++] = (u8)sym;
      state = state < 4 ? 0 : (state < 10 ? state - 3 : state - 6);
      continue;
    }
    u32 len;
    if (rc.decode_bit(is_rep, state)) {
      if (rc.decode_bit(is_rep_g0, state)) {
        u32 dist;
        if (!rc.decode_bit(is_rep_g1, state)) {
          dist = rep1;
        } else {
          if (!rc.decode_bit(is_rep_g2, state)) {
            dist = rep2;
          } else {
            dist = rep3;
            rep3 = rep2;
          }
          rep2 = rep1;
        }
        rep1 = rep0;
        rep0 = dist;
      } else {
        if (!rc.decode_bit(is_rep0_long, ((size_t)state << 4) + ps)) {
          state = state < 7 ? 9 : 11;
          if (outp < rep0 + 1) return (size_t)-1;
          if (outp >= out_cap) return (size_t)-2;
          out[outp] = out[outp - rep0 - 1];
          outp++;
          continue;
        }
      }
      len = rep_len_d.decode(rc, ps) + kMinLen;
      state = state < 7 ? 8 : 11;
    } else {
      rep3 = rep2;
      rep2 = rep1;
      rep1 = rep0;
      len = len_d.decode(rc, ps) + kMinLen;
      state = state < 7 ? 7 : 10;
      int ls = len_state(len);
      u32 slot = rc.bittree(pos_slot + (ls << 6), 6);
      if (slot < 4) {
        rep0 = slot;
      } else {
        int nd = ((int)slot >> 1) - 1;
        rep0 = (2u | (slot & 1)) << nd;
        if (slot < 14) {
          rep0 += rc.bittree_rev(spec_pos + ((long)rep0 - (long)slot - 1), nd);
        } else {
          rep0 += rc.decode_direct(nd - 4) << 4;
          rep0 += rc.bittree_rev(align_p, 4);
        }
      }
      if (rep0 == 0xFFFFFFFFu) break;  // EOS
    }
    if (rep0 + 1 > outp) return (size_t)-1;
    if (outp + len > out_cap) return (size_t)-2;
    const u8* src = out + outp - rep0 - 1;
    for (u32 i = 0; i < len; i++) out[outp + i] = src[i];
    outp += len;
  }
  if (consumed) *consumed = rc.pos;
  return outp;
}

}  // extern "C"
