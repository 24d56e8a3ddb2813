"""A plain GTM decoder, written from the format: the container, the
command stream and the playback rules of the reference JavaScript player
(gtm.player.js in gligli/tiler's decoders/htmljs).

Container: a 40-byte ``GTMv`` header (magic, then nine little-endian u32:
riff size, whole header size, encoder version, width, height, keyframe
count, frame count, average and peak bytes a second), one 28-byte
``GTMk`` record a keyframe, then one LZMA stream a keyframe. The payloads,
joined, are 16-bit words ``data << 4 | command`` with command payloads:

==  ========================  ===========================================
 0  predicted, short offset   data: ox in bits 0-5, oy in 6-11 (signed)
 1  predicted, long offset    u8 ox, u8 oy (signed)
 2  tile u16, palette short   data: h | v << 1 | palette << 2
 3  tile u32, palette short   as 2
 4  tile u32, palette u16     u16 palette, then u32 tile; data: h | v << 1
 5  intra tile                u16 palette, 64 bytes of slots; data: h | v << 1
 6  skip block                data + 1 cells predicted at offset (0, 0)
11  frame end                 data bit 0: last frame of its keyframe
12  load palette              u16 index, palette-size RGBA quads
13  tile set                  data: palette size; u32 first, u32 last, tiles
14  set dimensions            u16 width, u16 height (tiles), u32 frame ns,
                              u32 tile count
15  extended command          u32 length, that many bytes
==  ========================  ===========================================

Playback: cells are written in raster order; a tile cell draws its tile,
mirrored, through its palette; a predicted cell copies the 8x8 block of
the previous frame at its pixel offset (the first frame's previous frame
is black). Intra tiles are stored in slots from the declared tile count on
and cycle through twice the cells of a frame.

Imports nothing of the program.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from . import lzma

HEADER = struct.Struct("<4s9I")
KFINFO = struct.Struct("<4s6I")


@dataclass
class Commands:
    """One frame's cells: kind 0 draws ``tile`` (an index into the decoded
    tile list) through palette ``pal`` mirrored by ``mirror`` (h | v << 1);
    kind 1 copies the previous frame's block at (oy, ox)."""

    kind: np.ndarray
    tile: np.ndarray
    pal: np.ndarray
    mirror: np.ndarray
    ox: np.ndarray
    oy: np.ndarray


@dataclass
class Stream:
    header: dict
    width: int = 0  # pixels
    height: int = 0
    palette_size: int = 0
    tiles: np.ndarray = None  # [U, 8, 8] uint8, U distinct decoded tiles
    palettes: dict = field(default_factory=dict)  # index -> [S, 3] uint8
    frames: list = field(default_factory=list)  # Commands a frame
    keyframe_end: list = field(default_factory=list)


def parse_header(raw: bytes) -> tuple[dict, int]:
    if len(raw) < HEADER.size:
        raise ValueError("shorter than a GTM header")
    magic, _riff, whole, ver, w, h, kfc, frc, avg, kfmax = HEADER.unpack_from(raw)
    if magic != b"GTMv":
        raise ValueError("not a GTM stream")
    kfs = []
    for i in range(kfc):
        rec = KFINFO.unpack_from(raw, HEADER.size + i * KFINFO.size)
        if rec[0] != b"GTMk":
            raise ValueError("bad keyframe record")
        kfs.append(dict(frame_index=rec[3], raw_size=rec[4], compressed_size=rec[5]))
    return dict(version=ver, width=w, height=h, frame_count=frc,
                keyframes=kfs, header_size=whole), whole


def parse(raw: bytes) -> Stream:
    """Walk the command stream; ValueError on anything malformed."""
    header, off = parse_header(raw)
    b = b"".join(lzma.split_streams(raw[off:]))
    n = len(b)
    st = Stream(header=header)
    tiles = [np.zeros((1, 64), np.uint8)]  # decoded tile 0: an unset slot (zeros)
    n_tiles = 1
    slot_map = np.zeros(0, np.int64)
    width = height = cells = 0
    declared = cur_intra = 0
    pal_size = 0
    cur = None
    p = 0

    def u16(q):
        if q + 2 > n:
            raise ValueError("stream ends inside a command")
        return b[q] | b[q + 1] << 8

    def u32(q):
        if q + 4 > n:
            raise ValueError("stream ends inside a command")
        return int.from_bytes(b[q:q + 4], "little")

    def new_frame():
        return ([], [], [], [], [], [])

    def slot(idx):
        if not 0 <= idx < len(slot_map):
            raise ValueError(f"tile slot {idx} outside the {len(slot_map)} slots")
        return int(slot_map[idx])

    while p < n:
        word = u16(p)
        p += 2
        cmd, data = word & 15, word >> 4
        if cmd in (2, 3, 4, 5, 0, 1, 6) and cur is None:
            if not cells:
                raise ValueError("cell command before the dimensions")
            cur = new_frame()
        if cmd == 0 or cmd == 1:
            if cmd == 0:
                ox, oy = (data & 31) - (data & 32), ((data >> 6) & 31) - ((data >> 6) & 32)
            else:
                if p + 2 > n:
                    raise ValueError("stream ends inside a command")
                ox, oy = b[p] - ((b[p] & 128) << 1), b[p + 1] - ((b[p + 1] & 128) << 1)
                p += 2
            for lst, v in zip(cur, (1, 0, 0, 0, ox, oy)):
                lst.append(v)
        elif cmd in (2, 3, 4):
            if cmd == 2:
                pal, tile = data >> 2, u16(p)
                p += 2
            elif cmd == 3:
                pal, tile = data >> 2, u32(p)
                p += 4
            else:
                pal, tile = u16(p), u32(p + 2)
                p += 6
            for lst, v in zip(cur, (0, slot(tile), pal, data & 3, 0, 0)):
                lst.append(v)
        elif cmd == 5:
            pal = u16(p)
            if p + 66 > n:
                raise ValueError("stream ends inside an intra tile")
            tiles.append(np.frombuffer(b, np.uint8, 64, p + 2)[None])
            p += 66
            slot_map[cur_intra] = n_tiles
            for lst, v in zip(cur, (0, n_tiles, pal, data & 3, 0, 0)):
                lst.append(v)
            n_tiles += 1
            cur_intra += 1
            if cur_intra >= len(slot_map):
                cur_intra = declared
        elif cmd == 6:
            for lst, v in zip(cur, (1, 0, 0, 0, 0, 0)):
                lst.extend([v] * (data + 1))
        elif cmd == 11:
            if cur is None:
                cur = new_frame()
            if len(cur[0]) != cells:
                raise ValueError(f"frame {len(st.frames)} has {len(cur[0])} cells, not {cells}")
            kind, tile, pal, mirror, ox, oy = (np.asarray(v, np.int64) for v in cur)
            st.frames.append(Commands(kind, tile, pal, mirror, ox, oy))
            st.keyframe_end.append(bool(data & 1))
            cur = None
        elif cmd == 12:
            idx = u16(p)
            size = pal_size * 4
            if p + 2 + size > n:
                raise ValueError("stream ends inside a palette")
            st.palettes[idx] = np.frombuffer(b, np.uint8, size, p + 2).reshape(-1, 4)[:, :3]
            p += 2 + size
        elif cmd == 13:
            pal_size = data
            t0, t1 = u32(p), u32(p + 4)
            p += 8
            count = t1 - t0 + 1
            if count < 1 or t1 >= declared or p + 64 * count > n:
                raise ValueError("bad tile set")
            tiles.append(np.frombuffer(b, np.uint8, 64 * count, p).reshape(count, 64))
            slot_map[t0:t1 + 1] = np.arange(n_tiles, n_tiles + count)
            n_tiles += count
            p += 64 * count
        elif cmd == 14:
            width, height = u16(p), u16(p + 2)
            declared = u32(p + 8)
            p += 12
            cells = width * height
            if not cells or declared > n:
                raise ValueError(f"implausible dimensions {width}x{height}/{declared}")
            slot_map = np.zeros(declared + 2 * cells, np.int64)
            cur_intra = declared
        elif cmd == 15:
            length = u32(p)
            p += 4 + length
            if p > n:
                raise ValueError("stream ends inside an extended command")
        else:
            raise ValueError(f"unknown command {cmd}")
    if cur is not None:
        raise ValueError("stream ends inside a frame")
    st.width, st.height, st.palette_size = 8 * width, 8 * height, pal_size
    st.tiles = np.concatenate(tiles).reshape(-1, 8, 8)
    return st


def palette_array(palettes: dict, size: int) -> tuple[np.ndarray, np.ndarray]:
    """([P, S, 3] uint8, [P] bool loaded) from the loaded palettes."""
    count = max(palettes) + 1 if palettes else 0
    arr = np.zeros((count, size, 3), np.uint8)
    loaded = np.zeros(count, bool)
    for i, pal in palettes.items():
        arr[i] = pal
        loaded[i] = True
    return arr, loaded


def render(frames: list, tiles: np.ndarray, palettes: np.ndarray, loaded: np.ndarray,
           height: int, width: int) -> np.ndarray:
    """[F, height, width, 3] uint8 RGB from each frame's Commands."""
    th, tw = height // 8, width // 8
    out = np.empty((len(frames), height, width, 3), np.uint8)
    prev = np.zeros((height, width, 3), np.uint8)
    ar = np.arange(8)
    for f, c in enumerate(frames):
        ty, tx = np.divmod(np.arange(th * tw), tw)
        cur = out[f]
        view = cur.reshape(th, 8, tw, 8, 3)
        draw = c.kind == 0
        if draw.any():
            pal, tile, mir = c.pal[draw], c.tile[draw], c.mirror[draw]
            if pal.max(initial=0) >= len(palettes) or not loaded[pal].all():
                raise ValueError(f"frame {f} draws through a palette never loaded")
            t = tiles[tile]
            t = np.where((mir & 1)[:, None, None] != 0, t[:, :, ::-1], t)
            t = np.where((mir & 2)[:, None, None] != 0, t[:, ::-1, :], t)
            view[ty[draw], :, tx[draw]] = palettes[pal[:, None, None], t]
        pred = ~draw
        if pred.any():
            rows = (8 * ty[pred] + c.oy[pred])[:, None] + ar
            cols = (8 * tx[pred] + c.ox[pred])[:, None] + ar
            if rows.min() < 0 or rows.max() >= height or cols.min() < 0 or cols.max() >= width:
                raise ValueError(f"frame {f} predicts from outside the frame")
            view[ty[pred], :, tx[pred]] = prev[rows[:, :, None], cols[:, None, :]]
        prev = cur
    return out


def decode(raw: bytes) -> tuple[Stream, np.ndarray]:
    """(parsed stream, [F, H, W, 3] uint8 frames)."""
    st = parse(raw)
    pals, loaded = palette_array(st.palettes, st.palette_size)
    return st, render(st.frames, st.tiles, pals, loaded, st.height, st.width)


def state_commands(tilemap: dict) -> list:
    """Commands a frame from an encoder's final tilemap (numpy arrays
    [F, N]: tile_idx, pal_idx, predicted, pred_x, pred_y, hmirror,
    vmirror), as its stream should carry them: a negative tile or palette
    index is 0, a predicted cell copies at its offset. Tile indexes here
    are the encoder's own: render them with its tile array."""
    out = []
    for f in range(len(tilemap["tile_idx"])):
        pred = np.asarray(tilemap["predicted"][f], bool)
        mirror = (np.asarray(tilemap["hmirror"][f], bool).astype(np.int64)
                  | np.asarray(tilemap["vmirror"][f], bool).astype(np.int64) << 1)
        out.append(Commands(
            kind=pred.astype(np.int64),
            tile=np.maximum(0, np.asarray(tilemap["tile_idx"][f], np.int64)),
            pal=np.maximum(0, np.asarray(tilemap["pal_idx"][f], np.int64)),
            mirror=mirror,
            ox=np.asarray(tilemap["pred_x"][f], np.int64),
            oy=np.asarray(tilemap["pred_y"][f], np.int64)))
    return out


def render_state(tilemap: dict, tiles: np.ndarray, palettes: np.ndarray,
                 valid, height: int, width: int) -> np.ndarray:
    """The frames an encoder's final state stands for: its tilemap drawn
    with its tiles [T, 8, 8] and palettes [P, S, 3], colours not valid
    shown white, as a stream shows them."""
    pals = np.array(palettes, np.uint8)
    if valid is not None:
        pals[~np.asarray(valid, bool)] = 255
    return render(state_commands(tilemap), np.asarray(tiles, np.uint8).reshape(-1, 8, 8),
                  pals, np.ones(len(pals), bool), height, width)
