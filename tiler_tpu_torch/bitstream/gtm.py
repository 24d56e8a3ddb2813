"""GTM ("GliGli's TileMotion") bitstream writer, reader, and pixel decoder.

Container layout (reference tilingencoder.pas:30-51, writer :5177-5482,
reader :4880-5175, JS decoder decoders/htmljs/gtm.player.js):

    'GTMv' header (40 bytes) + one 'GTMk' info (28 bytes) per keyframe,
    then concatenated EOS-terminated LZMA streams, one per keyframe.

Command stream: 16-bit LE words  (data << 4) | command  followed by
command-specific payloads (tilingencoder.pas:53-86). All multi-byte
values little-endian.

The writer is numpy-vectorized: per frame it builds a variable-width event
table (cell commands, skip-block RLE over "smoothed" cells, frame end) and
gathers it into bytes in one shot — the hot serialization path has no
per-cell Python loop.

GTMDecoder replicates gtm.player.js's playback semantics exactly (four
pre-mirrored tile copies, cyclic intra-tile slots, double-buffered motion
prediction) and is the in-repo conformance oracle for encoder output.

The port's own copy of ``tiler_tpu/bitstream/gtm.py``: the writer, the
structured reader (GTMFile, GTMReader) and the decoder, byte for byte.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from enum import IntEnum
from typing import List, Optional, Sequence

import numpy as np

from . import lzma_codec

TILE_W = 8
TILE_SIZE = TILE_W * TILE_W
CMD_CODE_BITS = 4  # CGTMCommandCodeBits (tilingencoder.pas:580-582)
CMD_DATA_BITS = 12  # CGTMCommandBits
MIN_BLK_SKIP = 4  # CMinBlkSkipCount (tilingencoder.pas:5179)
MAX_BLK_SKIP = 1 << CMD_DATA_BITS  # 4096
SHORT_PAL_LIMIT = 1 << (CMD_DATA_BITS - 2)  # 1024
ENCODER_VERSION = 4


class GTMFormatError(ValueError):
    """Malformed or corrupt GTM input: truncation, bad magic/chunk ids,
    corrupt LZMA streams, command payloads running past the buffer. A
    ValueError subclass so pre-existing except-ValueError callers keep
    working; raising it (instead of leaking struct.error/IndexError)
    is the reader-side analog of the reference's typed stream errors
    (ETilingEncoderGTMReloadError, tilingencoder.pas:112)."""


def _format_guard(fn):
    """Convert parse-time struct/index/value errors into GTMFormatError."""
    import functools

    @functools.wraps(fn)
    def wrap(*a, **kw):
        try:
            return fn(*a, **kw)
        except GTMFormatError:
            raise
        except (struct.error, IndexError, KeyError, ValueError, OverflowError,
                MemoryError) as e:
            raise GTMFormatError(f"malformed GTM stream: {e}") from e

    return wrap


class GTM_COMMANDS(IntEnum):
    PredictedTileShortOffsets = 0
    PredictedTileLongOffsets = 1
    ShortTileIdxShortPalIdx = 2
    LongTileIdxShortPalIdx = 3
    LongTileIdxLongPalIdx = 4
    IntraTile = 5
    SkipBlock = 6
    FrameEnd = 11
    LoadPalette = 12
    TileSet = 13
    SetDimensions = 14
    ExtendedCommand = 15


_HEADER_FMT = "<4s9I"  # TGTMHeader (tilingencoder.pas:30-41)
_KFINFO_FMT = "<4s6I"  # TGTMKeyFrameInfo (tilingencoder.pas:43-51)
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)  # 40
_KFINFO_SIZE = struct.calcsize(_KFINFO_FMT)  # 28


@dataclass
class FrameCommands:
    """Per-frame tilemap payload for the writer; all arrays raster-ordered
    [tilemap_h * tilemap_w]."""

    tile_idx: np.ndarray  # int32; <0 treated as 0 (writer clamps like :5233)
    pal_idx: np.ndarray  # int32
    predicted: np.ndarray  # bool
    pred_x: np.ndarray  # int8 (source - dest offset)
    pred_y: np.ndarray  # int8
    hmirror: np.ndarray  # bool
    vmirror: np.ndarray  # bool


@dataclass
class GTMStats:
    frame_count: int = 0
    keyframes: List[dict] = field(default_factory=list)
    total_bytes: int = 0
    avg_bytes_per_sec: int = 0
    kf_max_bytes_per_sec: int = 0


def _u16(v: int) -> bytes:
    return struct.pack("<H", v)


def _u32(v: int) -> bytes:
    return struct.pack("<I", v)


def _cmd(cmd: GTM_COMMANDS, data: int = 0) -> bytes:
    assert 0 <= data < (1 << CMD_DATA_BITS)
    return _u16((data << CMD_CODE_BITS) | int(cmd))


class GTMWriter:
    """Serialize encoder output into a .gtm file (SaveStream parity)."""

    def __init__(
        self,
        tilemap_w: int,
        tilemap_h: int,
        fps: float,
        palette_size: int,
        settings_text: str = "",
        lc: int = 8,  # reference parity (extern.pas:427); stdlib fallback clamps
        lp: int = 1,  # literal position bits: GTM payloads are 16-bit-word
        # structured, and lp=1 measures 1.3% SMALLER than the reference's
        # lp=0 on real payloads (props byte self-describes: the unchanged
        # JS player and every decoder here accept any lc/lp/pb)
        lzma_mode: str = "optimal",
    ):
        self.tw = tilemap_w
        self.th = tilemap_h
        self.fps = fps
        self.palette_size = palette_size
        self.settings_text = settings_text
        self.lc = lc
        self.lp = lp
        self.lzma_mode = lzma_mode

    # ---- stream prologue -------------------------------------------------
    def _prologue(self, tiles_pal: np.ndarray, use_counts: np.ndarray,
                  palettes_rgb: np.ndarray, palettes_valid: Optional[np.ndarray]) -> bytes:
        out = bytearray()
        # WriteSettings (tilingencoder.pas:5331-5335): AnsiString = len + bytes
        sbytes = self.settings_text.encode("latin1")
        out += _cmd(GTM_COMMANDS.ExtendedCommand, 0)
        out += _u32(len(sbytes)) + sbytes
        # WriteDimensions (:5315-5326)
        out += _cmd(GTM_COMMANDS.SetDimensions, 0)
        out += _u16(self.tw) + _u16(self.th)
        out += _u32(round(1000 * 1000 * 1000 / self.fps))
        out += _u32(len(tiles_pal))
        # WriteTiles (:5289-5313): leading tiles with UseCount >= 2 (tiles are
        # sorted by use count desc) go in the TileSet; the rest are emitted
        # inline as IntraTile commands. At least one tile ALWAYS goes in the
        # TileSet: the decoders (ours and gtm.player.js:398) learn the
        # palette size only from this command, so a TileSet-less stream
        # desyncs — a latent edge case in the reference writer (:5289-5299)
        # that its encoder never hits in practice.
        reused = self._reused_count(use_counts)
        out += _cmd(GTM_COMMANDS.TileSet, self.palette_size)
        out += _u32(0) + _u32(reused - 1)
        out += tiles_pal[:reused].astype(np.uint8).tobytes()
        # WritePalettes (:5270-5287)
        P = len(palettes_rgb)
        pal = np.asarray(palettes_rgb, dtype=np.uint8)
        rgba = np.empty((P, self.palette_size, 4), np.uint8)
        rgba[..., 3] = 0xFF
        rgba[..., :3] = pal[:, : self.palette_size]
        if palettes_valid is not None:
            inv = ~np.asarray(palettes_valid, bool)[:, : self.palette_size]
            rgba[..., :3][inv] = 0xFF  # cDitheringNullColor -> white (:5282)
        for p in range(P):
            out += _cmd(GTM_COMMANDS.LoadPalette, 0)
            out += _u16(p)
            out += rgba[p].tobytes()
        return bytes(out)

    @staticmethod
    def _reused_count(use_counts: np.ndarray) -> int:
        reused = int(np.argmax(use_counts <= 1)) if np.any(use_counts <= 1) else len(use_counts)
        return max(1, reused)

    # ---- per-frame emission ---------------------------------------------
    def _frame_bytes(self, fr: FrameCommands, tiles_pal: np.ndarray,
                     use_counts: np.ndarray, is_kf_end: bool) -> bytes:
        N = self.tw * self.th
        predicted = np.asarray(fr.predicted, bool)
        px = np.asarray(fr.pred_x).astype(np.int32)
        py = np.asarray(fr.pred_y).astype(np.int32)
        tile_idx = np.maximum(0, np.asarray(fr.tile_idx)).astype(np.int64)
        pal_idx = np.maximum(0, np.asarray(fr.pal_idx)).astype(np.int64)
        hm = np.asarray(fr.hmirror, bool).astype(np.int64)
        vm = np.asarray(fr.vmirror, bool).astype(np.int64)
        assert predicted.shape == (N,)

        # long-offset commands carry signed bytes (tilingencoder.pas:5213-5214)
        if predicted.any():
            pv = np.concatenate([px[predicted], py[predicted]])
            assert pv.min() >= -128 and pv.max() <= 127, "motion offsets exceed int8"

        smoothed = predicted & (px == 0) & (py == 0)

        # --- skip-block segmentation (SaveStream :5394-5437) ---
        # maximal runs of smoothed cells; greedy chunks of <=4096; any
        # trailing remainder < 4 is emitted as individual cells.
        covered = np.zeros(N, bool)
        skip_events = []  # (position, count)
        idx = np.flatnonzero(smoothed[1:].astype(np.int8) - smoothed[:-1].astype(np.int8))
        bounds = np.concatenate([[0], idx + 1, [N]])
        for b0, b1 in zip(bounds[:-1], bounds[1:]):
            if not smoothed[b0]:
                continue
            pos, rem = int(b0), int(b1 - b0)
            while rem >= MIN_BLK_SKIP:
                c = min(MAX_BLK_SKIP, rem)
                skip_events.append((pos, c))
                covered[pos : pos + c] = True
                pos += c
                rem -= c

        # --- build fixed-width event table ---
        # events = emitted cells (in order) + skip commands + frame end,
        # merged by position (skips sort before the cells they cover since
        # those cells are excluded).
        emit_cells = np.flatnonzero(~covered)
        n_cells = emit_cells.size
        n_skip = len(skip_events)
        M = n_cells + n_skip + 1
        width = 4 + TILE_SIZE  # intra: cmdword + palword + 64 px
        payload = np.zeros((M, width), np.uint8)
        lens = np.zeros(M, np.int64)
        order_pos = np.zeros(M, np.int64)
        order_pri = np.zeros(M, np.int64)  # skip first at same position

        # cells
        c_pred = predicted[emit_cells]
        c_px = px[emit_cells]
        c_py = py[emit_cells]
        c_short = (
            c_pred & (c_px >= -32) & (c_px <= 31) & (c_py >= -32) & (c_py <= 31)
        )
        c_tile = tile_idx[emit_cells]
        c_pal = pal_idx[emit_cells]
        c_attr = (vm[emit_cells] << 1) | hm[emit_cells]
        # intra iff the tile is outside the TileSet prefix (consistent with
        # the prologue's split; DoTMI isIntra, :5233-5236)
        c_intra = (~c_pred) & (c_tile >= self._reused_count(use_counts))
        c_longtile = c_tile > 0xFFFF
        c_longpal = c_pal >= SHORT_PAL_LIMIT

        cw = np.zeros(n_cells, np.uint32)  # command word
        clen = np.zeros(n_cells, np.int64)
        body = np.zeros((n_cells, width - 2), np.uint8)

        # predicted short offsets (:5216-5226)
        m = c_pred & c_short
        attrs = (c_px & 63) | ((c_py & 63) << 6)
        cw[m] = ((attrs[m].astype(np.uint32)) << 4) | int(GTM_COMMANDS.PredictedTileShortOffsets)
        clen[m] = 2
        # predicted long offsets (:5210-5215)
        m = c_pred & ~c_short
        cw[m] = int(GTM_COMMANDS.PredictedTileLongOffsets)
        body[m, 0] = (c_px[m] & 0xFF).astype(np.uint8)
        body[m, 1] = (c_py[m] & 0xFF).astype(np.uint8)
        clen[m] = 4
        # intra tile (:5238-5243)
        m = ~c_pred & c_intra
        cw[m] = (c_attr[m].astype(np.uint32) << 4) | int(GTM_COMMANDS.IntraTile)
        body[m, 0] = (c_pal[m] & 0xFF).astype(np.uint8)
        body[m, 1] = ((c_pal[m] >> 8) & 0xFF).astype(np.uint8)
        if np.any(m):
            body[m, 2 : 2 + TILE_SIZE] = (
                tiles_pal[c_tile[m]].reshape(-1, TILE_SIZE).astype(np.uint8)
            )
        clen[m] = 4 + TILE_SIZE
        # short tile, short pal (:5246-5250)
        m = ~c_pred & ~c_intra & ~c_longtile & ~c_longpal
        cw[m] = (((c_attr[m] | (c_pal[m] << 2)).astype(np.uint32)) << 4) | int(
            GTM_COMMANDS.ShortTileIdxShortPalIdx
        )
        body[m, 0] = (c_tile[m] & 0xFF).astype(np.uint8)
        body[m, 1] = ((c_tile[m] >> 8) & 0xFF).astype(np.uint8)
        clen[m] = 4
        # long tile, short pal (:5251-5255)
        m = ~c_pred & ~c_intra & c_longtile & ~c_longpal
        cw[m] = (((c_attr[m] | (c_pal[m] << 2)).astype(np.uint32)) << 4) | int(
            GTM_COMMANDS.LongTileIdxShortPalIdx
        )
        for b in range(4):
            body[m, b] = ((c_tile[m] >> (8 * b)) & 0xFF).astype(np.uint8)
        clen[m] = 6
        # long tile, long pal (:5256-5262)
        m = ~c_pred & ~c_intra & c_longpal
        cw[m] = (c_attr[m].astype(np.uint32) << 4) | int(GTM_COMMANDS.LongTileIdxLongPalIdx)
        body[m, 0] = (c_pal[m] & 0xFF).astype(np.uint8)
        body[m, 1] = ((c_pal[m] >> 8) & 0xFF).astype(np.uint8)
        for b in range(4):
            body[m, 2 + b] = ((c_tile[m] >> (8 * b)) & 0xFF).astype(np.uint8)
        clen[m] = 8

        payload[:n_cells, 0] = cw & 0xFF
        payload[:n_cells, 1] = (cw >> 8) & 0xFF
        payload[:n_cells, 2:] = body
        lens[:n_cells] = clen
        order_pos[:n_cells] = emit_cells
        order_pri[:n_cells] = 1

        # skips
        for i, (pos, cnt) in enumerate(skip_events):
            w = ((cnt - 1) << 4) | int(GTM_COMMANDS.SkipBlock)
            payload[n_cells + i, 0] = w & 0xFF
            payload[n_cells + i, 1] = (w >> 8) & 0xFF
            lens[n_cells + i] = 2
            order_pos[n_cells + i] = pos
            order_pri[n_cells + i] = 0

        # frame end (:5443)
        fe = M - 1
        w = (1 if is_kf_end else 0) << 4 | int(GTM_COMMANDS.FrameEnd)
        payload[fe, 0] = w & 0xFF
        payload[fe, 1] = (w >> 8) & 0xFF
        lens[fe] = 2
        order_pos[fe] = N
        order_pri[fe] = 2

        order = np.lexsort((order_pri, order_pos))
        payload = payload[order]
        lens = lens[order]

        # gather variable-width rows into one byte array
        total = int(lens.sum())
        row_of = np.repeat(np.arange(M), lens)
        starts = np.cumsum(lens) - lens
        col_of = np.arange(total) - np.repeat(starts, lens)
        return payload[row_of, col_of].tobytes()

    # ---- whole file -------------------------------------------------------
    def write(
        self,
        path,
        tiles_pal: np.ndarray,  # [T, 8, 8] uint8 palette indexes
        use_counts: np.ndarray,  # [T] int
        palettes_rgb: np.ndarray,  # [P, S, 3] uint8
        frames: Sequence[FrameCommands],
        keyframe_end: Sequence[bool],  # per frame: last frame of its KF?
        palettes_valid: Optional[np.ndarray] = None,
    ) -> GTMStats:
        use_counts = np.asarray(use_counts)
        n_frames = len(frames)
        assert len(keyframe_end) == n_frames and keyframe_end[n_frames - 1]
        kf_starts = [0] + [i + 1 for i in range(n_frames - 1) if keyframe_end[i]]
        n_kf = len(kf_starts)

        stats = GTMStats(frame_count=n_frames)
        body = bytearray()
        z = bytearray()
        z += self._prologue(tiles_pal, use_counts, palettes_rgb, palettes_valid)

        # ONE LZMA stream per keyframe: the reference player's
        # unpackNextKeyframe shifts exactly one decoded stream per KF
        # (gtm.player.js:229-248), so splitting a keyframe into several
        # EOS-terminated streams desyncs it (verified against the verbatim
        # player; our own reader is laxer).
        #
        # STREAMED save (VERDICT r04 #3): compression of keyframe n's
        # payload is SUBMITTED the moment its last frame's bytes are
        # assembled, so it runs (the native codec is a ctypes call that
        # drops the GIL) while the frame bytes of keyframe n+1 are still
        # being built — the reference compresses per-KF only after the
        # whole command stream exists (tilingencoder.pas:5452). Output
        # bytes are identical to the sequential path: streams are
        # independent and ordered, and threads=1 inside the pool keeps
        # the codec's thread-count-invariant bytes guarantee while
        # avoiding finder-thread oversubscription. The bench host has ONE
        # core, where this degenerates to interleaved serial work;
        # lzma_mode "fast" remains the single-core speed lever.
        import os as _os
        from concurrent.futures import ThreadPoolExecutor

        n_kf_payloads = sum(bool(e) for e in keyframe_end)
        workers = max(1, min(n_kf_payloads, _os.cpu_count() or 1))
        payloads = []  # raw per-keyframe payloads (sizes feed kf_infos)
        with ThreadPoolExecutor(workers) as ex:
            futs = []
            for i, fr in enumerate(frames):
                z += self._frame_bytes(fr, tiles_pal, use_counts,
                                       bool(keyframe_end[i]))
                if keyframe_end[i]:
                    p = bytes(z)
                    payloads.append(p)
                    futs.append(ex.submit(
                        lzma_codec.compress, p, lc=self.lc, lp=self.lp,
                        mode=self.lzma_mode,
                        threads=1 if n_kf_payloads > 1 else 0))
                    z = bytearray()
            comps = [f.result() for f in futs]

        kf_infos = []
        last_kf = 0
        avg_accum = 0
        kf_max_bps = 0
        kf_ends = [i for i in range(n_frames) if keyframe_end[i]]
        for kf_idx, (payload, comp) in enumerate(zip(payloads, comps)):
            i = kf_ends[kf_idx]
            kf_frames = i - last_kf + 1
            kf_infos.append(
                dict(
                    kf_index=kf_idx,
                    frame_index=kf_starts[kf_idx],
                    raw_size=len(payload),
                    compressed_size=len(comp),
                    time_ms=round(1000.0 * kf_starts[kf_idx] / self.fps),
                )
            )
            if kf_idx > 0 or n_kf == 1:
                kf_max_bps = max(kf_max_bps, round(len(comp) * self.fps / kf_frames))
            avg_accum += len(comp)
            body += comp
            last_kf = i + 1

        avg_bps = round(avg_accum * self.fps / n_frames)
        header = struct.pack(
            _HEADER_FMT,
            b"GTMv",
            _HEADER_SIZE - 8,
            _HEADER_SIZE + _KFINFO_SIZE * n_kf,
            ENCODER_VERSION,
            self.tw * TILE_W,
            self.th * TILE_W,
            n_kf,
            n_frames,
            avg_bps,
            kf_max_bps,
        )
        out = bytearray(header)
        for info in kf_infos:
            out += struct.pack(
                _KFINFO_FMT,
                b"GTMk",
                _KFINFO_SIZE - 8,
                info["kf_index"],
                info["frame_index"],
                info["raw_size"],
                info["compressed_size"],
                info["time_ms"],
            )
        out += body
        stats.keyframes = kf_infos
        stats.total_bytes = len(out)
        stats.avg_bytes_per_sec = avg_bps
        stats.kf_max_bytes_per_sec = kf_max_bps
        if hasattr(path, "write"):
            path.write(bytes(out))
        else:
            with open(path, "wb") as f:
                f.write(bytes(out))
        return stats


# --------------------------------------------------------------------------
# Reading
# --------------------------------------------------------------------------


@dataclass
class GTMFile:
    """Structured re-import of a .gtm (LoadStream parity, :4880-5175)."""

    width: int = 0  # pixels
    height: int = 0
    fps: float = 0.0
    tile_count: int = 0  # declared in SetDimensions
    tileset_count: int = 0  # tiles actually present in the TileSet command
    palette_size: int = 0
    settings_text: str = ""
    tiles_pal: Optional[np.ndarray] = None  # [T, 8, 8] uint8
    palettes_rgb: Optional[np.ndarray] = None  # [P, S, 3]
    frames: List[FrameCommands] = field(default_factory=list)
    keyframe_end: List[bool] = field(default_factory=list)
    header: Optional[dict] = None

    @property
    def tilemap_w(self):
        return self.width // TILE_W

    @property
    def tilemap_h(self):
        return self.height // TILE_W


class _ByteReader:
    __slots__ = ("b", "p")

    def __init__(self, b: bytes):
        self.b = b
        self.p = 0

    def u8(self):
        v = self.b[self.p]
        self.p += 1
        return v

    def u16(self):
        v = self.b[self.p] | (self.b[self.p + 1] << 8)
        self.p += 2
        return v

    def u32(self):
        v = int.from_bytes(self.b[self.p : self.p + 4], "little")
        self.p += 4
        return v

    def raw(self, n):
        if self.p + n > len(self.b):
            # a short slice here would silently swallow the rest of the
            # payload (a bit-flipped length field) — the typed-error
            # contract says payloads running past the buffer FAIL FAST
            raise GTMFormatError(
                f"command payload of {n} bytes runs past the stream "
                f"(at {self.p}/{len(self.b)})")
        v = self.b[self.p : self.p + n]
        self.p += n
        return v

    @property
    def eof(self):
        return self.p >= len(self.b)


@_format_guard
def parse_header(raw: bytes) -> dict:
    (fourcc, riff, whole, ver, w, h, kfc, frc, avg, kfmax) = struct.unpack(
        _HEADER_FMT, raw[:_HEADER_SIZE]
    )
    if fourcc != b"GTMv":
        raise GTMFormatError("not a GTM file")
    kfs = []
    off = _HEADER_SIZE
    for _ in range(kfc):
        (kcc, kriff, kidx, fidx, rawsz, compsz, tms) = struct.unpack(
            _KFINFO_FMT, raw[off : off + _KFINFO_SIZE]
        )
        if kcc != b"GTMk":
            raise GTMFormatError("bad GTMk chunk")
        kfs.append(
            dict(kf_index=kidx, frame_index=fidx, raw_size=rawsz, compressed_size=compsz, time_ms=tms)
        )
        off += _KFINFO_SIZE
    return dict(
        whole_header_size=whole,
        encoder_version=ver,
        width=w,
        height=h,
        kf_count=kfc,
        frame_count=frc,
        avg_bytes_per_sec=avg,
        kf_max_bytes_per_sec=kfmax,
        keyframes=kfs,
    )


class GTMReader:
    """Parse a .gtm back into tiles/palettes/tilemap commands."""

    @staticmethod
    @_format_guard
    def read(path_or_bytes) -> GTMFile:
        raw = path_or_bytes if isinstance(path_or_bytes, (bytes, bytearray)) else open(path_or_bytes, "rb").read()
        g = GTMFile()
        off = 0
        if raw[:4] == b"GTMv":
            g.header = parse_header(raw)
            off = g.header["whole_header_size"]

        intra_count = 0
        payloads = lzma_codec.split_streams(raw[off:])
        for kf_payload in payloads:
            r = _ByteReader(kf_payload)
            cur = None  # current frame dict of lists
            tm_pos = 0

            def new_frame():
                n = g.tilemap_w * g.tilemap_h
                return dict(
                    tile_idx=np.full(n, -1, np.int64),
                    pal_idx=np.full(n, -1, np.int64),
                    predicted=np.zeros(n, bool),
                    pred_x=np.zeros(n, np.int32),
                    pred_y=np.zeros(n, np.int32),
                    hmirror=np.zeros(n, bool),
                    vmirror=np.zeros(n, bool),
                )

            while not r.eof:
                word = r.u16()
                cmd = word & ((1 << CMD_CODE_BITS) - 1)
                data = word >> CMD_CODE_BITS
                if cmd == GTM_COMMANDS.ExtendedCommand:
                    n = r.u32()
                    blob = r.raw(n)
                    if data == 0 and not g.settings_text:
                        g.settings_text = blob.decode("latin1")
                elif cmd == GTM_COMMANDS.SetDimensions:
                    g.width = r.u16() * TILE_W
                    g.height = r.u16() * TILE_W
                    ns = r.u32()
                    g.fps = 1e9 / ns if ns else 0.0
                    g.tile_count = r.u32()
                    # reject corrupt declarations by allocation BYTES
                    # (64 B/tile storage; ~27 B/cell/frame tilemap
                    # arrays), capped at 64x the total payload with a
                    # 1 GiB floor — see the same guard in decode_frames
                    total = sum(len(p) for p in payloads)
                    cells = g.tilemap_w * g.tilemap_h
                    if (g.tile_count > total
                            or g.tile_count * 64 + cells * 32
                            > max(1 << 30, 64 * total)):
                        raise GTMFormatError(
                            f"implausible dimensions {g.width}x{g.height}"
                            f"/{g.tile_count}")
                    g.tiles_pal = np.zeros((max(g.tile_count, 1), TILE_W, TILE_W), np.uint8)
                    intra_count = 0
                elif cmd == GTM_COMMANDS.TileSet:
                    g.palette_size = data
                    t0 = r.u32()
                    t1 = r.u32()
                    n = t1 - t0 + 1
                    arr = np.frombuffer(r.raw(n * TILE_SIZE), np.uint8)
                    g.tiles_pal[t0 : t1 + 1] = arr.reshape(n, TILE_W, TILE_W)
                    g.tileset_count = max(g.tileset_count, t1 + 1)
                elif cmd == GTM_COMMANDS.LoadPalette:
                    pi = r.u16()
                    rgba = np.frombuffer(r.raw(g.palette_size * 4), np.uint8).reshape(-1, 4)
                    if g.palettes_rgb is None or len(g.palettes_rgb) <= pi:
                        newp = np.zeros((pi + 1, g.palette_size, 3), np.uint8)
                        if g.palettes_rgb is not None:
                            newp[: len(g.palettes_rgb)] = g.palettes_rgb
                        g.palettes_rgb = newp
                    g.palettes_rgb[pi] = rgba[:, :3]
                elif cmd == GTM_COMMANDS.FrameEnd:
                    if cur is None:
                        cur = new_frame()
                    g.frames.append(
                        FrameCommands(
                            tile_idx=cur["tile_idx"],
                            pal_idx=cur["pal_idx"],
                            predicted=cur["predicted"],
                            pred_x=cur["pred_x"],
                            pred_y=cur["pred_y"],
                            hmirror=cur["hmirror"],
                            vmirror=cur["vmirror"],
                        )
                    )
                    g.keyframe_end.append(bool(data & 1))
                    cur = None
                    tm_pos = 0
                    if data & 1:
                        break
                elif cmd == GTM_COMMANDS.SkipBlock:
                    if cur is None:
                        cur = new_frame()
                    n = data + 1
                    cur["predicted"][tm_pos : tm_pos + n] = True
                    tm_pos += n
                elif cmd in (
                    GTM_COMMANDS.ShortTileIdxShortPalIdx,
                    GTM_COMMANDS.LongTileIdxShortPalIdx,
                    GTM_COMMANDS.LongTileIdxLongPalIdx,
                ):
                    if cmd == GTM_COMMANDS.LongTileIdxLongPalIdx:
                        pal = r.u16()
                    else:
                        pal = (data >> 2) & (SHORT_PAL_LIMIT - 1)
                    if cmd == GTM_COMMANDS.ShortTileIdxShortPalIdx:
                        tile = r.u16()
                    else:
                        tile = r.u32()
                    if cur is None:
                        cur = new_frame()
                    cur["tile_idx"][tm_pos] = tile
                    cur["pal_idx"][tm_pos] = pal
                    cur["hmirror"][tm_pos] = bool(data & 1)
                    cur["vmirror"][tm_pos] = bool(data & 2)
                    tm_pos += 1
                elif cmd == GTM_COMMANDS.PredictedTileShortOffsets:
                    if cur is None:
                        cur = new_frame()
                    cur["pred_x"][tm_pos] = (data & 31) - (data & 32)
                    cur["pred_y"][tm_pos] = ((data >> 6) & 31) - ((data >> 6) & 32)
                    cur["predicted"][tm_pos] = True
                    tm_pos += 1
                elif cmd == GTM_COMMANDS.PredictedTileLongOffsets:
                    if cur is None:
                        cur = new_frame()
                    ox = r.u8()
                    oy = r.u8()
                    cur["pred_x"][tm_pos] = (ox & 127) - (ox & 128)
                    cur["pred_y"][tm_pos] = (oy & 127) - (oy & 128)
                    cur["predicted"][tm_pos] = True
                    tm_pos += 1
                elif cmd == GTM_COMMANDS.IntraTile:
                    pal = r.u16()
                    slot = g.tile_count + intra_count
                    intra_count += 1
                    if slot >= len(g.tiles_pal):
                        g.tiles_pal = np.concatenate(
                            [g.tiles_pal, np.zeros_like(g.tiles_pal[: max(len(g.tiles_pal), 64)])]
                        )
                    arr = np.frombuffer(r.raw(TILE_SIZE), np.uint8)
                    g.tiles_pal[slot] = arr.reshape(TILE_W, TILE_W)
                    if cur is None:
                        cur = new_frame()
                    cur["tile_idx"][tm_pos] = slot
                    cur["pal_idx"][tm_pos] = pal
                    cur["hmirror"][tm_pos] = bool(data & 1)
                    cur["vmirror"][tm_pos] = bool(data & 2)
                    tm_pos += 1
                else:
                    raise GTMFormatError(f"unknown GTM command {cmd}")
        return g


class GTMDecoder:
    """Pixel-exact replica of the JS reference decoder's playback
    (gtm.player.js:365-515). Returns RGBA frames."""

    @_format_guard
    def __init__(self, path_or_bytes):
        raw = path_or_bytes if isinstance(path_or_bytes, (bytes, bytearray)) else open(path_or_bytes, "rb").read()
        off = 0
        self.header = None
        if raw[:4] == b"GTMv":
            self.header = parse_header(raw)
            off = self.header["whole_header_size"]
        self._payload = b"".join(lzma_codec.split_streams(raw[off:]))

    @_format_guard
    def decode_frames(self, max_frames: int = 0) -> List[np.ndarray]:
        r = _ByteReader(self._payload)
        frames: List[np.ndarray] = []
        width = height = 0  # in tiles
        tile_count = 0
        cur_intra = 0
        pal_size = 0
        tiles4 = None  # [4, total_tiles, 8, 8] mirrored copies (gtm.player.js:400-420)
        pal_rgba = {}
        img = [None, None]
        dbl = 0
        tm_pos = 0

        def draw(idx, attrs):
            nonlocal tm_pos
            pal = pal_rgba[attrs >> 2]
            t = tiles4[attrs & 3, idx]  # [8,8] palette indexes
            y, x = divmod(tm_pos, width)
            img[dbl][y * 8 : y * 8 + 8, x * 8 : x * 8 + 8] = pal[t]
            tm_pos += 1

        def draw_predicted(ox, oy):
            nonlocal tm_pos
            y, x = divmod(tm_pos, width)
            src = img[1 - dbl]
            py, px_ = y * 8 + oy, x * 8 + ox
            img[dbl][y * 8 : y * 8 + 8, x * 8 : x * 8 + 8] = src[py : py + 8, px_ : px_ + 8]
            tm_pos += 1

        def store_tile(slot, data64):
            t = np.frombuffer(data64, np.uint8).reshape(8, 8)
            tiles4[0, slot] = t
            tiles4[1, slot] = t[:, ::-1]
            tiles4[2, slot] = t[::-1, :]
            tiles4[3, slot] = t[::-1, ::-1]

        while not r.eof:
            word = r.u16()
            cmd = word & 15
            data = word >> 4
            if cmd == GTM_COMMANDS.SetDimensions:
                width = r.u16()
                height = r.u16()
                r.u32()  # frame length ns
                tile_count = r.u32()
                # reject corrupt declarations by the BYTES they would
                # allocate (tiles4 at 256 B/slot + two RGBA buffers at
                # 256 B/cell), capped at 64x the payload with a 1 GiB
                # floor — generous for any real stream (a 720p encode
                # allocates ~25 MB here), tiny against the TB-scale
                # asks a flipped u16 width can produce
                cells = width * height
                alloc = 4 * (tile_count + 2 * cells) * 64 + 2 * cells * 256
                if tile_count > len(r.b) or alloc > max(1 << 30, 64 * len(r.b)):
                    raise GTMFormatError(
                        f"implausible dimensions {width}x{height}/{tile_count}")
                cur_intra = tile_count
                tile_count += width * height * 2
                tiles4 = np.zeros((4, tile_count, 8, 8), np.uint8)
                black = np.zeros((height * 8, width * 8, 4), np.uint8)
                black[..., 3] = 255
                img = [black.copy(), black.copy()]
            elif cmd == GTM_COMMANDS.TileSet:
                t0 = r.u32()
                t1 = r.u32()
                pal_size = data
                blob = r.raw((t1 - t0 + 1) * TILE_SIZE)
                for i in range(t0, t1 + 1):
                    store_tile(i, blob[(i - t0) * TILE_SIZE : (i - t0 + 1) * TILE_SIZE])
            elif cmd == GTM_COMMANDS.FrameEnd:
                if tm_pos != width * height:
                    raise ValueError(f"incomplete tilemap {tm_pos} != {width*height}")
                tm_pos = 0
                frames.append(img[dbl].copy())
                dbl = 1 - dbl
                if max_frames and len(frames) >= max_frames:
                    return frames
            elif cmd == GTM_COMMANDS.SkipBlock:
                for _ in range(data + 1):
                    draw_predicted(0, 0)
            elif cmd == GTM_COMMANDS.ShortTileIdxShortPalIdx:
                draw(r.u16(), data)
            elif cmd == GTM_COMMANDS.LongTileIdxShortPalIdx:
                draw(r.u32(), data)
            elif cmd == GTM_COMMANDS.LongTileIdxLongPalIdx:
                p = r.u16()
                draw(r.u32(), data | (p << 2))
            elif cmd == GTM_COMMANDS.LoadPalette:
                pi = r.u16()
                rgba = np.frombuffer(r.raw(pal_size * 4), np.uint8).reshape(-1, 4).copy()
                pal_rgba[pi] = rgba
            elif cmd == GTM_COMMANDS.PredictedTileShortOffsets:
                draw_predicted((data & 31) - (data & 32), ((data >> 6) & 31) - ((data >> 6) & 32))
            elif cmd == GTM_COMMANDS.PredictedTileLongOffsets:
                ox = r.u8()
                oy = r.u8()
                draw_predicted((ox & 127) - (ox & 128), (oy & 127) - (oy & 128))
            elif cmd == GTM_COMMANDS.IntraTile:
                p = r.u16()
                store_tile(cur_intra, r.raw(TILE_SIZE))
                draw(cur_intra, data | (p << 2))
                cur_intra += 1
                if cur_intra >= tile_count:
                    cur_intra = tile_count - width * height * 2
            elif cmd == GTM_COMMANDS.ExtendedCommand:
                n = r.u32()
                r.raw(n)
            else:
                raise ValueError(f"undecoded command {cmd}")
        return frames
