"""Pure-Python LZMA1 decoder (spec-derived), for props bytes liblzma rejects.

The reference encoder emits lc=8 streams (extern.pas:427 SetLcLpPb(8,0,2));
liblzma only decodes lc<=4, so golden tests against the committed demo
.gtm files need this fallback (or the native C++ codec once built).

Implements the documented LZMA decoding algorithm: 11-bit adaptive binary
probabilities, a 32-bit range decoder, bit-tree contexts, and the
end-of-stream marker (distance 0xFFFFFFFF). Decoding stops at the EOS
marker and reports consumed input so concatenated per-keyframe streams can
be walked (same contract as the GliGli-modified js-lzma worker,
decoders/htmljs/wlzma.wrk.js:49-63).
"""
from __future__ import annotations

from typing import Optional, Tuple

_K_TOP = 1 << 24
_NUM_MOVE_BITS = 5
_INIT_PROB = 1024  # 2048 / 2


class _RangeDecoder:
    __slots__ = ("buf", "pos", "code", "range")

    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos + 1  # first byte is always 0
        self.code = int.from_bytes(buf[pos + 1 : pos + 5], "big")
        self.pos = pos + 5
        self.range = 0xFFFFFFFF

    def decode_bit(self, probs, idx) -> int:
        prob = probs[idx]
        bound = (self.range >> 11) * prob
        if self.code < bound:
            self.range = bound
            probs[idx] = prob + ((2048 - prob) >> _NUM_MOVE_BITS)
            bit = 0
        else:
            self.range -= bound
            self.code -= bound
            probs[idx] = prob - (prob >> _NUM_MOVE_BITS)
            bit = 1
        if self.range < _K_TOP:
            self.range <<= 8
            self.code = ((self.code << 8) | self.buf[self.pos]) & 0xFFFFFFFF
            self.pos += 1
        return bit

    def decode_direct(self, n: int) -> int:
        res = 0
        for _ in range(n):
            self.range >>= 1
            self.code -= self.range
            if self.code < 0:  # uint32 underflow in the C formulation
                self.code += self.range
                bit = 0
            else:
                bit = 1
            res = (res << 1) | bit
            if self.range < _K_TOP:
                self.range <<= 8
                self.code = ((self.code << 8) | self.buf[self.pos]) & 0xFFFFFFFF
                self.pos += 1
        return res

    def bittree(self, probs, base, nbits) -> int:
        m = 1
        for _ in range(nbits):
            m = (m << 1) | self.decode_bit(probs, base + m)
        return m - (1 << nbits)

    def bittree_rev(self, probs, base, nbits) -> int:
        m = 1
        sym = 0
        for i in range(nbits):
            b = self.decode_bit(probs, base + m)
            m = (m << 1) | b
            sym |= b << i
        return sym


class _LenDecoder:
    def __init__(self):
        self.choice = [_INIT_PROB] * 2
        self.low = [_INIT_PROB] * (16 << 3)
        self.mid = [_INIT_PROB] * (16 << 3)
        self.high = [_INIT_PROB] * 256

    def decode(self, rc: _RangeDecoder, pos_state: int) -> int:
        if not rc.decode_bit(self.choice, 0):
            return rc.bittree(self.low, pos_state << 3, 3)
        if not rc.decode_bit(self.choice, 1):
            return 8 + rc.bittree(self.mid, pos_state << 3, 3)
        return 16 + rc.bittree(self.high, 0, 8)


def decompress_stream(
    buf: bytes, offset: int = 0, max_out: Optional[int] = None
) -> Tuple[bytes, int]:
    """Decode one EOS-terminated .lzma-alone stream at `offset`.

    Returns (payload, consumed). With max_out set, stops early after
    producing max_out bytes (consumed is then a lower bound and must not be
    used to locate the next stream).
    """
    props = buf[offset]
    if props >= 9 * 5 * 5:
        raise ValueError("bad LZMA props byte")
    lc = props % 9
    lp = (props // 9) % 5
    pb = props // 45
    # bytes 1..4 dict size, 5..12 uncompressed size (0xFF*8 = unknown)
    usize = int.from_bytes(buf[offset + 5 : offset + 13], "little")
    unknown_size = usize == 0xFFFFFFFFFFFFFFFF

    rc = _RangeDecoder(buf, offset + 13)

    lit_probs = [_INIT_PROB] * (0x300 << (lc + lp))
    is_match = [_INIT_PROB] * (12 << 4)
    is_rep = [_INIT_PROB] * 12
    is_rep_g0 = [_INIT_PROB] * 12
    is_rep_g1 = [_INIT_PROB] * 12
    is_rep_g2 = [_INIT_PROB] * 12
    is_rep0_long = [_INIT_PROB] * (12 << 4)
    pos_slot = [_INIT_PROB] * (4 << 6)
    spec_pos = [_INIT_PROB] * 115
    align_p = [_INIT_PROB] * 16
    len_dec = _LenDecoder()
    rep_len_dec = _LenDecoder()

    out = bytearray()
    rep0 = rep1 = rep2 = rep3 = 0
    state = 0
    pb_mask = (1 << pb) - 1
    lp_mask = (1 << lp) - 1

    while True:
        if not unknown_size and len(out) >= usize:
            break
        if max_out is not None and len(out) >= max_out:
            return bytes(out), rc.pos - offset
        pos_state = len(out) & pb_mask
        if not rc.decode_bit(is_match, (state << 4) + pos_state):
            # literal
            prev = out[-1] if out else 0
            lit_state = ((len(out) & lp_mask) << lc) + (prev >> (8 - lc))
            base = 0x300 * lit_state
            sym = 1
            if state >= 7:
                match_byte = out[-rep0 - 1]
                while sym < 0x100:
                    match_bit = (match_byte >> 7) & 1
                    match_byte = (match_byte << 1) & 0xFF
                    bit = rc.decode_bit(
                        lit_probs, base + ((1 + match_bit) << 8) + sym
                    )
                    sym = (sym << 1) | bit
                    if match_bit != bit:
                        break
            while sym < 0x100:
                sym = (sym << 1) | rc.decode_bit(lit_probs, base + sym)
            out.append(sym & 0xFF)
            state = 0 if state < 4 else (state - 3 if state < 10 else state - 6)
            continue
        # match / rep
        if rc.decode_bit(is_rep, state):
            if rc.decode_bit(is_rep_g0, state):
                if not rc.decode_bit(is_rep_g1, state):
                    dist = rep1
                else:
                    if not rc.decode_bit(is_rep_g2, state):
                        dist = rep2
                    else:
                        dist = rep3
                        rep3 = rep2
                    rep2 = rep1
                rep1 = rep0
                rep0 = dist
            else:
                if not rc.decode_bit(is_rep0_long, (state << 4) + pos_state):
                    # short rep: one byte at rep0
                    state = 9 if state < 7 else 11
                    out.append(out[-rep0 - 1])
                    continue
            length = rep_len_dec.decode(rc, pos_state) + 2
            state = 8 if state < 7 else 11
        else:
            rep3, rep2, rep1 = rep2, rep1, rep0
            length = len_dec.decode(rc, pos_state) + 2
            state = 7 if state < 7 else 10
            # decode distance
            len_state = min(length - 2, 3)
            slot = rc.bittree(pos_slot, len_state << 6, 6)
            if slot < 4:
                rep0 = slot
            else:
                nd = (slot >> 1) - 1
                rep0 = (2 | (slot & 1)) << nd
                if slot < 14:
                    rep0 += rc.bittree_rev(spec_pos, rep0 - slot - 1, nd)
                else:
                    rep0 += rc.decode_direct(nd - 4) << 4
                    rep0 += rc.bittree_rev(align_p, 0, 4)
            if rep0 == 0xFFFFFFFF:
                break  # end-of-stream marker
        # copy match
        src = len(out) - rep0 - 1
        for i in range(length):
            out.append(out[src + i])
    return bytes(out), rc.pos - offset
