"""LZMA codec for GTM keyframe streams.

Stream layout (what the JS reference decoder's LZMA.decompressFile parses,
decoders/htmljs/lzma.js:397-428, and what the reference encoder emits via
extern.pas:420-439):

    1 byte   props = (pb*5 + lp)*9 + lc
    4 bytes  dictionary size (LE)
    8 bytes  uncompressed size; 8x0xFF = unknown -> decode until EOS marker
    ...      LZMA1 range-coded data, EOS-terminated

This is exactly the ".lzma alone" container. The reference encoder uses
lc=8, lp=0, pb=2 (extern.pas:427); liblzma caps lc<=4, so our default
encoder emits lc=4 (the props byte is honored by the JS decoder, so the
output stays fully decoder-conformant). A native C++ encoder supporting
lc=8 can be plugged in via `set_native_codec`.

Decoding: liblzma for lc<=4; a pure-Python LZMA1 decoder fallback for the
reference's lc=8 streams (``lzma_py.py``), or the native codec when built.

The port's own copy of ``tiler_tpu/bitstream/lzma_codec.py``; its native
codec is ``tiler_tpu_torch/native`` (``native/lzma.cpp`` of the port).
"""
from __future__ import annotations

import lzma as _lzma
import threading
from typing import List, Tuple

_native = None  # optional module with lzma_compress/lzma_decompress_stream
_native_probed = False
_native_lock = threading.Lock()  # probe may g++-build the lib: serialize it


def set_native_codec(mod) -> None:
    global _native, _native_probed
    with _native_lock:
        _native = mod
        _native_probed = True


def _get_native():
    global _native, _native_probed
    # Under the lock so concurrent compressors (gtm.py's per-keyframe
    # thread pool) all block until the one probe — which may spend
    # seconds building the shared library — finishes, instead of some
    # threads seeing probed=True/native=None and silently falling back
    # to the stdlib encoder (different lc clamp, different bytes).
    with _native_lock:
        if not _native_probed:
            _native_probed = True
            try:
                from .. import native as mod

                if mod.available():
                    _native = mod
            except Exception:
                _native = None
        return _native


def default_filters(lc: int = 4, lp: int = 0, pb: int = 2, dict_size: int = 1 << 25):
    return [
        {
            "id": _lzma.FILTER_LZMA1,
            "preset": 9 | _lzma.PRESET_EXTREME,
            "lc": lc,
            "lp": lp,
            "pb": pb,
            "dict_size": dict_size,
        }
    ]


def compress(data: bytes, lc: int = 8, lp: int = 0, pb: int = 2,
             mode: str = "optimal", threads: int = 0) -> bytes:
    """Compress one keyframe payload into an EOS-terminated .lzma-alone
    stream. Default lc=8 matches the reference encoder (extern.pas:427)
    via the native codec; falls back to liblzma (lc clamped to <=4, still
    decoder-conformant since the props byte self-describes).

    mode: "optimal" (price-DP parse, the ratio preset, ~0.52 on GTM
    payloads at ~5 MB/s) or "fast" (lazy greedy over hash-5 chains,
    ~2.2x faster at ~1.04x the size) — both native-codec only."""
    nat = _get_native()
    if nat is not None:
        try:
            return nat.lzma_compress(data, lc=lc, lp=lp, pb=pb,
                                     depth=(2 if mode == "fast" else -2),
                                     threads=threads)
        except Exception:
            pass
    if lc > 4 or lc + lp > 4:
        lc = min(lc, 4 - lp)
    comp = _lzma.LZMACompressor(
        format=_lzma.FORMAT_ALONE, filters=default_filters(lc=lc, lp=lp, pb=pb)
    )
    return comp.compress(data) + comp.flush()


def _parse_props(stream: bytes) -> Tuple[int, int, int, int]:
    props = stream[0]
    lc = props % 9
    rem = props // 9
    lp = rem % 5
    pb = rem // 5
    dict_size = int.from_bytes(stream[1:5], "little")
    return lc, lp, pb, dict_size


def decompress_stream(buf: bytes, offset: int = 0) -> Tuple[bytes, int]:
    """Decode ONE EOS-terminated stream starting at `offset`.

    Returns (payload, bytes_consumed_from_offset). Multiple streams are
    concatenated back to back in a .gtm file (one per keyframe), matching
    the GliGli-modified worker loop (decoders/htmljs/wlzma.wrk.js:49-63).
    """
    if len(buf) - offset < 13:  # props(5) + size(8)
        raise ValueError("truncated LZMA stream header")
    lc, lp, pb, _ = _parse_props(buf[offset : offset + 5])
    if buf[offset] >= 9 * 5 * 5:
        raise ValueError("invalid LZMA props byte")
    nat = _get_native()
    if nat is not None:
        # the native decoder is complete for every lc/lp/pb; its decode
        # errors mean the STREAM is bad — re-raise instead of retrying
        # with the (slow) fallbacks on data already known corrupt
        return nat.lzma_decompress_stream(buf, offset)
    if lc <= 4 and lc + lp <= 4:
        dec = _lzma.LZMADecompressor(format=_lzma.FORMAT_ALONE)
        out = dec.decompress(buf[offset:])
        if not dec.eof:
            raise ValueError("truncated LZMA stream")
        consumed = len(buf) - offset - len(dec.unused_data)
        return out, consumed
    from . import lzma_py

    return lzma_py.decompress_stream(buf, offset)


def split_streams(buf: bytes) -> List[bytes]:
    """Decode all concatenated streams in `buf`; returns list of payloads."""
    out = []
    off = 0
    while off < len(buf):
        payload, used = decompress_stream(buf, off)
        out.append(payload)
        off += used
    return out
