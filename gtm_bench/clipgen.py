"""The one clip generator: makes a cell's frames from a traffic file's
parameters, the configuration's clip format and ``--seed``.

A traffic file (``traffic/<name>.json``) describes the clip as a list of
``shots``. With ``shot_frames`` 0 the first shot fills the clip; with
``shot_frames`` n the clip cuts to the next shot every n frames (a scene
cut), going round the list, and each shot starts again at its own frame
0. A shot is drawn in this order:

- ``background``: ``{"kind": "gradient"}`` (a colour ramp down, across and
  along the diagonal), ``{"kind": "plasma", "waves": n, "period": p}`` (n
  sinusoids of period about p pixels, their phases and directions drawn
  from the seed: smooth texture, a stand-in for natural content), or
  ``{"kind": "y4m", "file": "<path under the checkout>"}`` (the frames of
  a raw YUV4MPEG2 clip, 4:2:0 or 4:4:4, BT.601 full range, cropped from
  its top-left corner and looped: real content);
- ``noise``: uniform noise in [0, max) added in uint8 (it wraps, as the
  original generator does), drawn when the shot starts and, with
  ``per_frame``, again on every later frame of the shot (sensor grain);
- ``scroll``: [dy, dx] pixels a frame, the whole picture rolled;
- ``sprites``: squares of one colour, each at (y0 + dy f, x0 + dx f)
  modulo the room left in the frame, drawn in list order.

Every seed gives the same sizes, shots, motion and cuts; only what is
drawn from the seed (noise, plasma phases) differs. With the ``retro``
parameters the frames equal ``tiler_tpu_torch.utils.clips.synthetic_clip``
(and ``bench.synthetic_clip``) byte for byte, which a test holds.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def numpy_seed(seed: int) -> int:
    """``RandomState`` takes seeds in [0, 2**32): larger or negative run
    seeds are taken modulo 2**32."""
    return int(seed) % (1 << 32)


def _gradient(height: int, width: int) -> np.ndarray:
    yy, xx = np.mgrid[0:height, 0:width]
    return np.stack([yy * 255 // height, xx * 255 // width,
                     (yy + xx) * 255 // (height + width)], -1).astype(np.uint8)


def _plasma(height: int, width: int, waves: int, period: float, rng) -> np.ndarray:
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    angle = rng.uniform(0, 2 * np.pi, (waves, 3))
    phase = rng.uniform(0, 2 * np.pi, (waves, 3))
    scale = rng.uniform(0.5, 2.0, (waves, 3)) * 2 * np.pi / period
    out = np.zeros((height, width, 3))
    for w in range(waves):
        for c in range(3):
            k = scale[w, c]
            out[..., c] += np.sin(k * (np.cos(angle[w, c]) * xx + np.sin(angle[w, c]) * yy)
                                  + phase[w, c])
    return np.clip(np.rint(127.5 + 127.5 * out / waves), 0, 255).astype(np.uint8)


def read_y4m(path: Path, frames: int, height: int, width: int) -> np.ndarray:
    """[frames, height, width, 3] uint8 RGB from a YUV4MPEG2 file of at
    least that size (cropped from the top-left corner), its frames looped
    when it holds fewer."""
    data = path.read_bytes()
    head, _, body = data.partition(b"\n")
    tags = dict((t[:1], t[1:]) for t in head.split()[1:])
    W, H = int(tags[b"W"]), int(tags[b"H"])
    chroma = tags.get(b"C", b"420").decode()
    if W < width or H < height:
        raise ValueError(f"{path.name} is {W}x{H}, smaller than {width}x{height}")
    sub = 1 if chroma.startswith("444") else 2
    if not (chroma.startswith("444") or chroma.startswith("420")):
        raise ValueError(f"{path.name}: chroma {chroma} is not 4:2:0 or 4:4:4")
    cw, ch = W // sub, H // sub
    size = W * H + 2 * cw * ch
    out, pos, stored = [], 0, []
    while pos < len(body):
        line_end = body.index(b"\n", pos)  # "FRAME" and its parameters
        pos = line_end + 1
        plane = np.frombuffer(body, np.uint8, size, pos)
        pos += size
        stored.append(plane)
    if not stored:
        raise ValueError(f"{path.name} holds no frame")
    for f in range(frames):
        plane = stored[f % len(stored)]
        y = plane[:W * H].reshape(H, W)[:height, :width].astype(np.float64)
        u = plane[W * H:W * H + cw * ch].reshape(ch, cw)
        v = plane[W * H + cw * ch:].reshape(ch, cw)
        u = u.repeat(sub, 0).repeat(sub, 1)[:height, :width] - 128.0
        v = v.repeat(sub, 0).repeat(sub, 1)[:height, :width] - 128.0
        rgb = np.stack([y + 1.402 * v, y - 0.344136 * u - 0.714136 * v, y + 1.772 * u], -1)
        out.append(np.clip(np.rint(rgb), 0, 255).astype(np.uint8))
    return np.stack(out)


def _background(bg: dict, frames: int, height: int, width: int, rng):
    """A function of the shot's frame index -> [height, width, 3] uint8."""
    kind = bg["kind"]
    if kind == "gradient":
        still = _gradient(height, width)
    elif kind == "plasma":
        still = _plasma(height, width, int(bg["waves"]), float(bg["period"]), rng)
    elif kind == "y4m":
        moving = read_y4m(ROOT / bg["file"], frames, height, width)
        return lambda f: moving[f]
    else:
        raise ValueError(f"unknown background kind {kind!r}")
    return lambda f: still


def _shot(shot: dict, frames: int, height: int, width: int, rng, out: np.ndarray):
    """Draws one shot into ``out`` [frames, height, width, 3]."""
    background = _background(shot["background"], frames, height, width, rng)
    noise_spec = shot.get("noise")
    hi = int(noise_spec["max"]) if noise_spec else 0
    noise = rng.randint(0, hi, (height, width, 3)).astype(np.uint8) if hi else 0
    dy, dx = shot.get("scroll", (0, 0))
    for f in range(frames):
        if hi and noise_spec.get("per_frame") and f:
            noise = rng.randint(0, hi, (height, width, 3)).astype(np.uint8)
        img = np.roll(background(f) + noise, (dy * f, dx * f), (0, 1))
        for sp in shot.get("sprites", ()):
            size = int(sp["size"])
            x0 = (sp["x0"] + sp["dx"] * f) % max(1, width - size)
            y0 = (sp["y0"] + sp["dy"] * f) % max(1, height - size)
            img[y0:y0 + size, x0:x0 + size] = sp["rgb"]
        out[f] = img


def make_clip(traffic: dict, frames: int, height: int, width: int, seed: int) -> np.ndarray:
    """[frames, height, width, 3] uint8 RGB."""
    rng = np.random.RandomState(numpy_seed(seed))
    shots = traffic["shots"]
    every = int(traffic.get("shot_frames", 0)) or frames
    out = np.empty((frames, height, width, 3), np.uint8)
    for i, start in enumerate(range(0, frames, every)):
        _shot(shots[i % len(shots)], min(every, frames - start), height, width, rng,
              out[start:start + every])
    return out
