/* Plain LZMA1 decoder for the benchmark's reference GTM decoder.
 *
 * Written from the public LZMA specification (range coder, bit-tree
 * contexts, rep distances, end marker 0xFFFFFFFF). A .gtm holds one
 * ".lzma alone" stream per keyframe: props byte ((pb*5+lp)*9+lc), 4 bytes
 * of dictionary size, 8 bytes of uncompressed size (all 0xFF: decode to the
 * end marker), then the range-coded data. GTM writes lc=8, which liblzma
 * refuses (it caps lc+lp at 4), so the reference decodes with this file.
 * It shares no code with the program: the build is the benchmark's own.
 *
 * C interface (ctypes):
 *   long long lzma_alone_decode(const unsigned char* in, size_t in_len,
 *                               unsigned char* out, size_t out_cap,
 *                               size_t* consumed)
 * returns the payload size, -1 on a corrupt stream, -2 when out_cap is
 * too small.
 */
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>

#define TOP (1u << 24)
#define MOVE_BITS 5
#define INIT_PROB 1024
#define STATES 12
#define MIN_LEN 2

typedef struct {
  const uint8_t* buf;
  size_t pos, n;
  uint32_t code, range;
  int overrun;
} rc_t;

static uint8_t rc_byte(rc_t* rc) {
  if (rc->pos < rc->n) return rc->buf[rc->pos++];
  rc->pos++;
  rc->overrun = 1;
  return 0;
}

static int rc_bit(rc_t* rc, uint16_t* p) {
  uint32_t bound = (rc->range >> 11) * *p;
  int bit;
  if (rc->code < bound) {
    rc->range = bound;
    *p = (uint16_t)(*p + ((2048 - *p) >> MOVE_BITS));
    bit = 0;
  } else {
    rc->range -= bound;
    rc->code -= bound;
    *p = (uint16_t)(*p - (*p >> MOVE_BITS));
    bit = 1;
  }
  if (rc->range < TOP) {
    rc->range <<= 8;
    rc->code = (rc->code << 8) | rc_byte(rc);
  }
  return bit;
}

static uint32_t rc_direct(rc_t* rc, int nbits) {
  uint32_t res = 0;
  for (int i = 0; i < nbits; i++) {
    rc->range >>= 1;
    uint32_t bit = rc->code >= rc->range;
    if (bit) rc->code -= rc->range;
    res = (res << 1) | bit;
    if (rc->range < TOP) {
      rc->range <<= 8;
      rc->code = (rc->code << 8) | rc_byte(rc);
    }
  }
  return res;
}

static uint32_t tree(rc_t* rc, uint16_t* p, int nbits) {
  uint32_t m = 1;
  for (int i = 0; i < nbits; i++) m = (m << 1) | (uint32_t)rc_bit(rc, p + m);
  return m - (1u << nbits);
}

static uint32_t tree_rev(rc_t* rc, uint16_t* p, int nbits) {
  uint32_t m = 1, sym = 0;
  for (int i = 0; i < nbits; i++) {
    uint32_t b = (uint32_t)rc_bit(rc, p + m);
    m = (m << 1) | b;
    sym |= b << i;
  }
  return sym;
}

typedef struct {
  uint16_t choice[2], low[16 << 3], mid[16 << 3], high[256];
} len_t;

static void len_init(len_t* l) {
  uint16_t* p = (uint16_t*)l;
  for (size_t i = 0; i < sizeof(len_t) / 2; i++) p[i] = INIT_PROB;
}

static uint32_t len_decode(rc_t* rc, len_t* l, uint32_t ps) {
  if (!rc_bit(rc, &l->choice[0])) return tree(rc, l->low + (ps << 3), 3);
  if (!rc_bit(rc, &l->choice[1])) return 8 + tree(rc, l->mid + (ps << 3), 3);
  return 16 + tree(rc, l->high, 8);
}

typedef struct {
  uint16_t is_match[STATES << 4], is_rep[STATES], rep_g0[STATES], rep_g1[STATES],
      rep_g2[STATES], rep0_long[STATES << 4], slot[4 << 6], spec[115], align[16];
  len_t len, rep_len;
} model_t;

long long lzma_alone_decode(const uint8_t* in, size_t in_len, uint8_t* out,
                            size_t out_cap, size_t* consumed) {
  if (in_len < 18 || in[0] >= 9 * 5 * 5) return -1;
  int lc = in[0] % 9, lp = (in[0] / 9) % 5, pb = in[0] / 45;
  uint64_t usize = 0;
  for (int i = 0; i < 8; i++) usize |= (uint64_t)in[5 + i] << (8 * i);
  int to_marker = usize == UINT64_MAX;

  rc_t rc = {in, 14, in_len, 0, 0xFFFFFFFFu, 0};  /* byte 13 is always 0 */
  if (in[13] != 0) return -1;
  for (int i = 0; i < 4; i++) rc.code = (rc.code << 8) | rc_byte(&rc);

  size_t nlit = (size_t)0x300 << (lc + lp);
  uint16_t* lit = (uint16_t*)malloc(nlit * sizeof(uint16_t));
  model_t* m = (model_t*)malloc(sizeof(model_t));
  if (!lit || !m) {
    free(lit);
    free(m);
    return -1;
  }
  for (size_t i = 0; i < nlit; i++) lit[i] = INIT_PROB;
  uint16_t* mp = (uint16_t*)m;
  for (size_t i = 0; i < sizeof(model_t) / 2; i++) mp[i] = INIT_PROB;

  long long ret = -1;
  size_t op = 0;
  uint32_t rep0 = 0, rep1 = 0, rep2 = 0, rep3 = 0;
  int state = 0;
  uint32_t pbm = (1u << pb) - 1, lpm = (1u << lp) - 1;
  for (;;) {
    if (!to_marker && op >= usize) break;
    if (rc.overrun) goto done;
    uint32_t ps = (uint32_t)op & pbm;
    if (!rc_bit(&rc, &m->is_match[(state << 4) + ps])) {
      uint8_t prev = op ? out[op - 1] : 0;
      uint16_t* p = lit + 0x300 * ((((uint32_t)op & lpm) << lc) + (prev >> (8 - lc)));
      uint32_t sym = 1;
      if (state >= 7) {
        if (op < (size_t)rep0 + 1) goto done;
        uint32_t mb = out[op - rep0 - 1];
        while (sym < 0x100) {
          uint32_t match_bit = (mb >> 7) & 1;
          mb <<= 1;
          uint32_t bit = (uint32_t)rc_bit(&rc, p + ((1 + match_bit) << 8) + sym);
          sym = (sym << 1) | bit;
          if (match_bit != bit) break;
        }
      }
      while (sym < 0x100) sym = (sym << 1) | (uint32_t)rc_bit(&rc, p + sym);
      if (op >= out_cap) {
        ret = -2;
        goto done;
      }
      out[op++] = (uint8_t)sym;
      state = state < 4 ? 0 : (state < 10 ? state - 3 : state - 6);
      continue;
    }
    uint32_t len;
    if (rc_bit(&rc, &m->is_rep[state])) {
      if (op == 0) goto done;
      if (!rc_bit(&rc, &m->rep_g0[state])) {
        if (!rc_bit(&rc, &m->rep0_long[(state << 4) + ps])) {
          state = state < 7 ? 9 : 11;
          if (op >= out_cap) {
            ret = -2;
            goto done;
          }
          out[op] = out[op - rep0 - 1];
          op++;
          continue;
        }
      } else {
        uint32_t dist;
        if (!rc_bit(&rc, &m->rep_g1[state])) {
          dist = rep1;
        } else {
          if (!rc_bit(&rc, &m->rep_g2[state])) {
            dist = rep2;
          } else {
            dist = rep3;
            rep3 = rep2;
          }
          rep2 = rep1;
        }
        rep1 = rep0;
        rep0 = dist;
      }
      len = len_decode(&rc, &m->rep_len, ps) + MIN_LEN;
      state = state < 7 ? 8 : 11;
    } else {
      rep3 = rep2;
      rep2 = rep1;
      rep1 = rep0;
      len = len_decode(&rc, &m->len, ps) + MIN_LEN;
      state = state < 7 ? 7 : 10;
      uint32_t ls = len - MIN_LEN < 3 ? len - MIN_LEN : 3;
      uint32_t slot = tree(&rc, m->slot + (ls << 6), 6);
      if (slot < 4) {
        rep0 = slot;
      } else {
        int nd = (int)(slot >> 1) - 1;
        rep0 = (2u | (slot & 1)) << nd;
        if (slot < 14) {
          rep0 += tree_rev(&rc, m->spec + rep0 - slot - 1, nd);
        } else {
          rep0 += rc_direct(&rc, nd - 4) << 4;
          rep0 += tree_rev(&rc, m->align, 4);
        }
      }
      if (rep0 == 0xFFFFFFFFu) {
        ret = rc.overrun ? -1 : (long long)op;
        goto done;
      }
    }
    if ((size_t)rep0 + 1 > op) goto done;
    if (op + len > out_cap) {
      ret = -2;
      goto done;
    }
    for (uint32_t i = 0; i < len; i++, op++) out[op] = out[op - rep0 - 1];
  }
  ret = rc.overrun ? -1 : (long long)op;
done:
  if (consumed) *consumed = rc.pos;
  free(lit);
  free(m);
  return ret;
}
