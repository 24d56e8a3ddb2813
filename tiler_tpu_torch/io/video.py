"""Host-side video ingest: the port's own copy of ``tiler_tpu/io/video.py``.

The reference links ffmpeg 5.1 via ~28k lines of generated Pascal bindings
(extern.pas:744-904). Here ingest is pluggable by source type:
  - printf-style image sequences (PNG/BMP/...; the reference's non-video
    path, tilingencoder.pas:1789-1817) via PIL
  - .y4m YUV4MPEG2 files (C444/C420 variants) with a pure-numpy parser
  - anything else through the `ffmpeg` binary when present (rawvideo pipe)

Scaling follows the reference semantics: output dimensions scaled by
`Scaling` before tile extraction (FFMPEG_Open dst sizes, extern.pas:
759-789). Manual keyframes come from sidecar .kf files
(FindKeyFrames, tilingencoder.pas:3381-3385).
"""
from __future__ import annotations

import dataclasses
import os
import re
import shutil
import subprocess
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class PlanarClip:
    """Source-resolution YUV planes for DEVICE-side ingest (chroma
    upsample + YUV->RGB + Lanczos `Scaling` run on the device,
    ops/resample.py) instead of the host paths below. Ships ~1.5 bytes/px
    to the device for 4:2:0 content vs 3 bytes/px RGB at TARGET
    resolution. Full-range BT.601, same constants as load_y4m."""

    y: np.ndarray  # [F, h, w] uint8
    u: np.ndarray  # [F, hc, wc] uint8 (hc/wc divide h/w)
    v: np.ndarray  # [F, hc, wc] uint8
    fps: float

    @property
    def n_frames(self) -> int:
        return len(self.y)

    @property
    def src_h(self) -> int:
        return self.y.shape[1]

    @property
    def src_w(self) -> int:
        return self.y.shape[2]

    def to_rgb_host(self, scaling: float = 1.0) -> np.ndarray:
        """The exact load_y4m math on the host — nearest chroma upsample,
        BT.601, round/clip, PIL Lanczos: what the device ingest is held
        against, and the ingest of a clip over the device budget."""
        out = []
        for i in range(self.n_frames):
            y = self.y[i].astype(np.float32)
            u = self.u[i].astype(np.float32) - 128.0
            v = self.v[i].astype(np.float32) - 128.0
            if u.shape != y.shape:
                u = u.repeat(y.shape[0] // u.shape[0], 0).repeat(y.shape[1] // u.shape[1], 1)
                v = v.repeat(y.shape[0] // v.shape[0], 0).repeat(y.shape[1] // v.shape[1], 1)
            r = y + 1.13983 * v
            g = y - 0.39465 * u - 0.58060 * v
            b = y + 2.03211 * u
            rgb = np.clip(np.round(np.stack([r, g, b], -1)), 0, 255).astype(np.uint8)
            out.append(_scale_frame(rgb, scaling))
        return np.stack(out)


class _FrameSink:
    """Append-only frame store with a preallocated backing array.

    Bounds host RAM to ~one copy of the clip (the reference streams
    per-frame through FFMPEG callbacks, extern.pas:744-904): frames are
    written in place; the hint comes from the container size/metadata and
    the buffer grows geometrically when the hint was low.

    spill_budget > 0: a buffer whose size would exceed it is backed by
    an unlinked temp-file memmap instead of RAM (utils/spill.py), so a
    video larger than host RAM still ingests — capacity becomes disk."""

    def __init__(self, capacity_hint: int = 0, spill_budget: int = 0):
        self.buf = None
        self.n = 0
        self.hint = max(0, int(capacity_hint))
        self.spill_budget = max(0, int(spill_budget))

    def _alloc(self, cap: int, frame_shape) -> np.ndarray:
        nbytes = cap * int(np.prod(frame_shape))
        if self.spill_budget and nbytes > self.spill_budget:
            from ..utils.spill import spill_memmap

            return spill_memmap((cap, *frame_shape))
        return np.empty((cap, *frame_shape), np.uint8)

    def append(self, frame: np.ndarray):
        if self.buf is None:
            cap = self.hint if self.hint > 0 else 64
            self.buf = self._alloc(cap, frame.shape)
        elif self.n == len(self.buf):
            grown = self._alloc(
                max(self.n + 64, int(self.n * 1.5)), self.buf.shape[1:]
            )
            grown[: self.n] = self.buf
            self.buf = grown
        self.buf[self.n] = frame
        self.n += 1

    def __len__(self):
        return self.n

    def array(self) -> np.ndarray:
        if self.buf is None:
            raise ValueError("no frames")
        if self.n == len(self.buf):
            return self.buf
        # RAM-backed with a big growth overhang: trim with one copy so
        # the pipeline doesn't pin up to 1.5x the clip for its whole
        # life via the view's base. Memmap overhang is disk, not RAM —
        # keep the view (a copy would materialize it in RAM).
        if not isinstance(self.buf, np.memmap) and (
            len(self.buf) - self.n > max(64, self.n // 10)
        ):
            self.buf = np.ascontiguousarray(self.buf[: self.n])
        return self.buf[: self.n]  # view, no copy


def _scale_frame(f: np.ndarray, scaling: float) -> np.ndarray:
    if scaling == 1.0:
        return f
    from PIL import Image

    h, w = f.shape[:2]
    nw, nh = max(1, round(w * scaling)), max(1, round(h * scaling))
    return np.asarray(Image.fromarray(f).resize((nw, nh), Image.LANCZOS))


def _y4m_header(f):
    """Parse the YUV4MPEG2 stream header; returns (W, H, fps, planes)."""
    header = f.readline().decode("ascii").strip()
    if not header.startswith("YUV4MPEG2"):
        raise ValueError("not a y4m file")
    W = H = 0
    fps = 24.0
    cs = "420"
    for tok in header.split()[1:]:
        if tok[0] == "W":
            W = int(tok[1:])
        elif tok[0] == "H":
            H = int(tok[1:])
        elif tok[0] == "F":
            n, d = tok[1:].split(":")
            fps = float(n) / float(d)
        elif tok[0] == "C":
            cs = tok[1:]
    if cs.startswith("444"):
        planes = [(H, W), (H, W), (H, W)]
    elif cs.startswith("420"):
        planes = [(H, W), (H // 2, W // 2), (H // 2, W // 2)]
    elif cs.startswith("422"):
        planes = [(H, W), (H, W // 2), (H, W // 2)]
    else:
        raise ValueError(f"unsupported y4m colorspace {cs}")
    return W, H, fps, planes


def load_y4m_planar(path: str, start_frame: int = 0,
                    frame_count: Optional[int] = None,
                    spill_budget: int = 0) -> PlanarClip:
    """Parse YUV4MPEG2 into raw source-resolution planes — NO host chroma
    upsample, NO host colorspace conversion, NO host scaling; those run
    on device (pipeline/load.py + ops/resample.py)."""
    with open(path, "rb") as f:
        W, H, fps, planes = _y4m_header(f)
        fsz = sum(h * w for h, w in planes)
        data_start = f.tell()
        total_sz = os.fstat(f.fileno()).st_size
        est_total = max(0, (total_sz - data_start) // (fsz + 6))
        cap = est_total - start_frame
        if frame_count is not None:
            cap = min(cap, frame_count)
        sinks = [_FrameSink(max(cap, 0), spill_budget) for _ in planes]
        idx = 0
        while True:
            line = f.readline()
            if not line:
                break
            if not line.startswith(b"FRAME"):
                raise ValueError("bad y4m frame header")
            raw = f.read(fsz)
            if len(raw) < fsz:
                break
            if idx >= start_frame and (
                    frame_count is None or len(sinks[0]) < frame_count):
                off = 0
                for sink, (h, w) in zip(sinks, planes):
                    sink.append(
                        np.frombuffer(raw, np.uint8, h * w, off).reshape(h, w))
                    off += h * w
            idx += 1
            if frame_count is not None and len(sinks[0]) >= frame_count:
                break
    return PlanarClip(sinks[0].array(), sinks[1].array(), sinks[2].array(), fps)


def load_y4m(path: str, start_frame: int = 0, frame_count: Optional[int] = None,
             scaling: float = 1.0, spill_budget: int = 0) -> Tuple[np.ndarray, float]:
    """Parse YUV4MPEG2; returns (frames [F,H,W,3] uint8 RGB, fps)."""
    with open(path, "rb") as f:
        W, H, fps, planes = _y4m_header(f)
        fsz = sum(h * w for h, w in planes)
        # capacity hint from the file size (single-copy ingest: a 2-min
        # 720p clip is ~8 GB of frames — a transient second copy via
        # np.stack would double that)
        data_start = f.tell()
        total_sz = os.fstat(f.fileno()).st_size
        est_total = max(0, (total_sz - data_start) // (fsz + 6))
        cap = est_total - start_frame
        if frame_count is not None:
            cap = min(cap, frame_count)
        frames = _FrameSink(max(cap, 0), spill_budget)
        idx = 0
        while True:
            line = f.readline()
            if not line:
                break
            if not line.startswith(b"FRAME"):
                raise ValueError("bad y4m frame header")
            raw = f.read(fsz)
            if len(raw) < fsz:
                break
            if idx >= start_frame and (frame_count is None or len(frames) < frame_count):
                off = 0
                ps = []
                for h, w in planes:
                    ps.append(np.frombuffer(raw, np.uint8, h * w, off).reshape(h, w))
                    off += h * w
                y, u, v = ps
                if u.shape != y.shape:  # upsample chroma (nearest)
                    u = u.repeat(y.shape[0] // u.shape[0], 0).repeat(y.shape[1] // u.shape[1], 1)
                    v = v.repeat(y.shape[0] // v.shape[0], 0).repeat(y.shape[1] // v.shape[1], 1)
                yf = y.astype(np.float32)
                uf = u.astype(np.float32) - 128.0
                vf = v.astype(np.float32) - 128.0
                # BT.601 full-range (matches the reference's YUVToRGB)
                r = yf + 1.13983 * vf
                g = yf - 0.39465 * uf - 0.58060 * vf
                b = yf + 2.03211 * uf
                rgb = np.clip(np.round(np.stack([r, g, b], -1)), 0, 255).astype(np.uint8)
                frames.append(_scale_frame(rgb, scaling))
            idx += 1
            if frame_count is not None and len(frames) >= frame_count:
                break
    return frames.array(), fps


def load_image_sequence(pattern: str, start_frame: int = 0,
                        frame_count: Optional[int] = None,
                        scaling: float = 1.0,
                        spill_budget: int = 0) -> Tuple[np.ndarray, float]:
    """printf-style pattern (e.g. frame%04d.png); fps fixed at 24
    (tilingencoder.pas:1790)."""
    from PIL import Image

    # count the matching files up front: a hint-less spill sink grows by
    # re-copying its whole memmap per 1.5x step (~2x extra disk writes +
    # a transient ~2.5x footprint on exactly the beyond-RAM sequences
    # the spill exists for); the files are on disk, so the count is free
    hint = 0
    if spill_budget:
        j = start_frame
        while os.path.exists(pattern % j) and (
                frame_count is None or hint < frame_count):
            hint += 1
            j += 1

    frames = _FrameSink(hint, spill_budget)
    i = start_frame
    while frame_count is None or len(frames) < frame_count:
        p = pattern % i
        if not os.path.exists(p):
            break
        img = np.asarray(Image.open(p).convert("RGB"))
        frames.append(_scale_frame(img, scaling))
        i += 1
    if not len(frames):
        raise FileNotFoundError(f"no frames match {pattern}")
    return frames.array(), 24.0


def _probe_banner(ffmpeg: str, path: str):
    """ffprobe-less probing: parse the `ffmpeg -i` stderr banner
    ("Stream #0:0: Video: ..., 1280x720 ..., 25 fps" + "Duration:").
    Returns (W, H, fps, nb_frames_estimate); raises if no video stream
    line parses. CFR cannot be asserted from the banner, so callers must
    treat the result as VFR (no time-seek)."""
    import re

    out = subprocess.run([ffmpeg, "-hide_banner", "-i", path],
                         capture_output=True, text=True).stderr
    m = re.search(r"Stream #\d+:\d+.*?: Video:.*?(\d{2,5})x(\d{2,5})", out)
    if not m:
        raise RuntimeError(f"cannot probe {path}: no video stream in banner")
    W, H = int(m.group(1)), int(m.group(2))
    fm = re.search(r"(\d+(?:\.\d+)?)\s*fps", out)
    fps = float(fm.group(1)) if fm else 24.0
    nb = 0
    dm = re.search(r"Duration:\s*(\d+):(\d\d):(\d\d(?:\.\d+)?)", out)
    if dm:
        secs = int(dm.group(1)) * 3600 + int(dm.group(2)) * 60 + float(dm.group(3))
        nb = int(secs * fps) + 2
    return W, H, fps, nb


def _probe_ffmpeg(ffmpeg: str, path: str):
    """Probe (W, H, fps, nb_frames, cfr, pix_fmt) via ffprobe when
    available, else the ffmpeg banner (which can't prove CFR or report a
    reliable pix_fmt)."""
    ffprobe = shutil.which("ffprobe")
    if not ffprobe:
        # no ffprobe on this host: parse the ffmpeg -i banner instead
        # (W=0 would otherwise spin forever on zero-byte pipe reads);
        # banner probing can't prove CFR, so time-seek stays disabled
        W, H, fps, nb_frames = _probe_banner(ffmpeg, path)
        return W, H, fps, nb_frames, False, ""
    # JSON output keyed by NAME: csv=p=0 prints fields in ffprobe's
    # internal stream order (duration before nb_frames), NOT the
    # -show_entries request order — positional parsing silently
    # swapped them, inflating the preallocation estimate ~fps-fold
    import json as _json

    info = _json.loads(subprocess.run(
        [ffprobe, "-v", "quiet", "-select_streams", "v:0",
         "-show_entries",
         "stream=width,height,r_frame_rate,avg_frame_rate,nb_frames,"
         "duration,pix_fmt",
         "-of", "json", path],
        capture_output=True, text=True, check=True,
    ).stdout)["streams"][0]
    W, H = int(info["width"]), int(info["height"])
    n, d = info["r_frame_rate"].split("/")
    fps = float(n) / float(d)
    # constant frame rate <=> r_frame_rate == avg_frame_rate; VFR (or
    # telecined streams reporting 2x r_frame_rate) must NOT time-seek —
    # the pipe would silently start at the wrong frame
    try:
        an, ad = info.get("avg_frame_rate", "0/0").split("/")
        cfr = float(ad) != 0.0 and abs(fps - float(an) / float(ad)) < 1e-9
    except ValueError:
        cfr = False
    nb_frames = 0
    if str(info.get("nb_frames", "")).isdigit():
        nb_frames = int(info["nb_frames"])
    elif "duration" in info:
        try:
            nb_frames = int(float(info["duration"]) * fps) + 2
        except ValueError:
            pass
    return W, H, fps, nb_frames, cfr, str(info.get("pix_fmt", ""))


def load_ffmpeg_planar(path: str, start_frame: int = 0,
                       frame_count: Optional[int] = None,
                       spill_budget: int = 0) -> Optional[PlanarClip]:
    """Decode a natively-4:2:0 video into raw yuv420p planes for device
    ingest. Returns None when the source isn't 4:2:0 (forcing a chroma
    subsample there would CHANGE content, not just move work) or ffmpeg
    is unavailable."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        return None
    W, H, fps, nb_frames, cfr, pix_fmt = _probe_ffmpeg(ffmpeg, path)
    if pix_fmt not in ("yuv420p", "yuvj420p") or W % 2 or H % 2:
        return None
    seek = []
    idx = 0
    if start_frame > 0 and cfr and fps > 0:
        seek = ["-ss", f"{max(0.0, (start_frame - 0.5) / fps):.6f}"]
        idx = start_frame
    cmd = [ffmpeg, "-v", "quiet", *seek, "-i", path,
           "-f", "rawvideo", "-pix_fmt", "yuv420p", "-"]
    ysz, csz = H * W, (H // 2) * (W // 2)
    fsz = ysz + 2 * csz
    cap = max(0, nb_frames - start_frame)
    if frame_count is not None and cap:
        cap = min(cap, frame_count)
    sy = _FrameSink(cap, spill_budget)
    su = _FrameSink(cap, spill_budget)
    sv = _FrameSink(cap, spill_budget)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)
    try:
        while frame_count is None or len(sy) < frame_count:
            raw = proc.stdout.read(fsz)
            if len(raw) < fsz:
                break
            if idx >= start_frame:
                sy.append(np.frombuffer(raw, np.uint8, ysz, 0).reshape(H, W))
                su.append(np.frombuffer(raw, np.uint8, csz, ysz)
                          .reshape(H // 2, W // 2))
                sv.append(np.frombuffer(raw, np.uint8, csz, ysz + csz)
                          .reshape(H // 2, W // 2))
            idx += 1
    finally:
        proc.stdout.close()
        proc.wait()
    if not len(sy):
        return None
    return PlanarClip(sy.array(), su.array(), sv.array(), fps)


def load_ffmpeg(path: str, start_frame: int = 0, frame_count: Optional[int] = None,
                scaling: float = 1.0, spill_budget: int = 0) -> Tuple[np.ndarray, float]:
    """Decode via the ffmpeg binary, STREAMING the rawvideo pipe frame by
    frame into a preallocated array (capturing the whole pipe then
    copying doubled host RAM — a 2-min 720p clip is ~8 GB of frames)."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError("ffmpeg binary not available")
    W, H, fps, nb_frames, cfr, _pix = _probe_ffmpeg(ffmpeg, path)
    vf = []
    if scaling != 1.0:
        W, H = max(1, round(W * scaling)), max(1, round(H * scaling))
        vf = ["-vf", f"scale={W}:{H}:flags=lanczos"]
    # frame-accurate seek (the reference seeks via av_seek_frame,
    # extern.pas:807-848): -ss BEFORE -i lands on the prior seek point and
    # accurate-seek discards up to the target inside ffmpeg — no decoded
    # frames cross the pipe just to be thrown away. Seeking to the
    # mid-point of frame N-1 makes frame N the first emitted regardless of
    # rational-fps rounding. ONLY valid for CFR streams (probed
    # r_frame_rate == avg_frame_rate); VFR/telecined content falls back
    # to decode-and-discard, which counts real frames off the pipe.
    seek = []
    idx = 0
    if start_frame > 0 and cfr and fps > 0:
        seek = ["-ss", f"{max(0.0, (start_frame - 0.5) / fps):.6f}"]
        idx = start_frame
    cmd = [ffmpeg, "-v", "quiet", *seek, "-i", path, *vf,
           "-f", "rawvideo", "-pix_fmt", "rgb24", "-"]
    fsz = H * W * 3
    cap = max(0, nb_frames - start_frame)
    if frame_count is not None and cap:
        cap = min(cap, frame_count)
    sink = _FrameSink(cap, spill_budget)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)
    try:
        while frame_count is None or len(sink) < frame_count:
            raw = proc.stdout.read(fsz)
            if len(raw) < fsz:
                break
            if idx >= start_frame:
                sink.append(np.frombuffer(raw, np.uint8).reshape(H, W, 3))
            idx += 1
    finally:
        proc.stdout.close()
        proc.wait()
    return sink.array(), fps


def load_video(path: str, start_frame: int = 0, frame_count: Optional[int] = None,
               scaling: float = 1.0, spill_budget: int = 0) -> Tuple[np.ndarray, float]:
    if re.search(r"%0?\d*d", path):
        return load_image_sequence(path, start_frame, frame_count, scaling, spill_budget)
    if path.lower().endswith(".y4m"):
        return load_y4m(path, start_frame, frame_count, scaling, spill_budget)
    if path.lower().endswith(".gtm"):
        from ..bitstream.gtm import GTMDecoder

        dec = GTMDecoder(path)
        frames = np.stack([f[..., :3] for f in dec.decode_frames()])
        return frames, 24.0
    return load_ffmpeg(path, start_frame, frame_count, scaling, spill_budget)


def load_video_planar(path: str, start_frame: int = 0,
                      frame_count: Optional[int] = None,
                      spill_budget: int = 0) -> Optional[PlanarClip]:
    """Planar (device-ingest) loader: raw YUV planes at source resolution
    for sources that are natively planar — y4m files and 4:2:0 video via
    ffmpeg. Returns None when the source isn't (image sequences and .gtm
    decode to RGB; subsampling them would change content): the caller
    then reads RGB through load_video. The route follows from the
    source's type alone; a probe or decode failure raises."""
    if re.search(r"%0?\d*d", path) or path.lower().endswith(".gtm"):
        return None
    if path.lower().endswith(".y4m"):
        return load_y4m_planar(path, start_frame, frame_count, spill_budget)
    return load_ffmpeg_planar(path, start_frame, frame_count, spill_budget)


def manual_keyframes(path: str, start_frame: int, n_frames: int) -> Optional[List[int]]:
    """Sidecar .kf files mark manual keyframes for image sequences
    (tilingencoder.pas:3381-3385); None = automatic detection."""
    if not re.search(r"%0?\d*d", path):
        return None
    base = re.sub(r"\.[^.]+$", ".kf", path)
    found = [i for i in range(n_frames) if os.path.exists(base % (i + start_frame))]
    return found if found else None
