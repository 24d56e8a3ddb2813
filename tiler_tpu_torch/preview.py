"""HTTP preview server: the GUI's inspection surfaces over a live
encoder state or a re-imported .gtm stream.

The reference's Lazarus GUI (main.pas:15-163) shows a frame scrubber
with four render pages (input / output / global tiles / palettes,
tilingencoder.pas:3455-3736 + page enum :20) and a per-frame PSNR
readout (:3713-3731). This serves the same surfaces from a browser —
the headless replacement for the GUI layer — using only stdlib
http.server plus render.py's vectorized page renderers.

Usage:
    python -m tiler_tpu_torch preview out.gtm --port 8080 --device cpu
    python -m tiler_tpu_torch preview out.gtm --video clip.y4m   # adds rpInput
or programmatically around a live encode:
    PreviewServer(state_to_numpy(enc.state)).serve_forever()

The port's own copy of ``tiler_tpu/preview.py``. The pages render from a
numpy ``EncodeState`` (``models.convert.state_to_numpy`` of the encoder's
live one, whose large arrays are tensors); the port's state has no
deferred ingest to finish first.
"""
from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from . import render
from .models.state import EncodeState

_PAGES = ("input", "output", "tiles", "palettes")


def content_frames(state: EncodeState) -> int:
    """Frame count of the state's CONTENT: loaded source frames, or the
    tilemap's frame axis for a frame-less reloaded stream (n_frames
    deliberately stays 0 there — callers use it as "video loaded?")."""
    if state.n_frames:
        return state.n_frames
    if state.tilemap is not None:
        return int(state.tilemap.tile_idx.shape[0])
    return 0

_INDEX_HTML = """<!doctype html>
<html><head><title>tiler-tpu preview</title><style>
body { font-family: sans-serif; background: #181818; color: #ddd;
       margin: 1em; }
img { image-rendering: pixelated; border: 1px solid #444;
      max-width: 100%; }
.bar { margin: 0.6em 0; display: flex; gap: 1em; align-items: center; }
select, input { background: #282828; color: #ddd; }
#psnr { font-variant-numeric: tabular-nums; }
</style></head><body>
<h3>tiler-tpu preview</h3>
<div class="bar">
  <select id="page"></select>
  <button id="play">&#9654;</button>
  <input type="range" id="frame" min="0" value="0" style="flex:1">
  <span id="label"></span><span id="psnr"></span>
</div>
<img id="view">
<div id="hover" style="color:#9c9; min-height:1.2em"></div>
<pre id="meta"></pre>
<script>
let info = null, timer = null;
const page = document.getElementById('page');
const frame = document.getElementById('frame');
const play = document.getElementById('play');
const view = document.getElementById('view');
async function load() {
  info = await (await fetch('info.json')).json();
  for (const p of info.pages) {
    const o = document.createElement('option'); o.value = p;
    o.textContent = p; page.appendChild(o);
  }
  frame.max = info.frames - 1;
  document.getElementById('meta').textContent =
    JSON.stringify(info, null, 1);
  update();
}
function update() {
  const f = +frame.value;
  view.src = 'render/' + page.value + '/' + f + '.png';
  document.getElementById('label').textContent =
    'frame ' + f + '/' + (info.frames - 1);
  document.getElementById('psnr').textContent = info.psnr ?
    ' PSNR-HVS ' + (info.psnr[f] ?? 0).toFixed(2) + ' dB' : '';
}
// timed playback at the stream's own fps (reference GUI play button)
play.onclick = () => {
  if (timer) { clearInterval(timer); timer = null;
               play.innerHTML = '&#9654;'; return; }
  play.innerHTML = '&#9646;&#9646;';
  timer = setInterval(() => {
    frame.value = (+frame.value + 1) % info.frames; update();
  }, 1000 / (info.fps || 24));
};
// hover inspector (reference GUI tile/palette hints, main.pas:294-333):
// image pixel -> /inspect.json -> cell / tile / palette details
let hoverSeq = 0;
view.onmousemove = async (ev) => {
  const r = view.getBoundingClientRect();
  const x = Math.floor((ev.clientX - r.left) * view.naturalWidth / r.width);
  const y = Math.floor((ev.clientY - r.top) * view.naturalHeight / r.height);
  const seq = ++hoverSeq;
  const d = await (await fetch('inspect.json?page=' + page.value +
                               '&frame=' + frame.value +
                               '&x=' + x + '&y=' + y)).json();
  if (seq !== hoverSeq) return;  // stale response
  document.getElementById('hover').textContent =
    Object.entries(d).map(([k, v]) => k + '=' + v).join('  ');
};
view.onmouseleave = () => {
  document.getElementById('hover').textContent = '';
};
page.onchange = update; frame.oninput = update;
load();
</script></body></html>
"""


def _png_bytes(img: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img[..., :3])).save(buf, "PNG")
    return buf.getvalue()


class PreviewServer:
    """Serves render pages + metadata for a numpy EncodeState."""

    def __init__(self, state: EncodeState, host: str = "127.0.0.1",
                 port: int = 8080):
        self.state = state
        outer = self
        # output pages decode from tilemap state; input needs source frames
        self.pages = [p for p in _PAGES
                      if p != "input" or state.frames_rgb is not None]
        self._cache = {}
        self._uses = None  # lazy tilemap-recounted use counts

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    path = self.path.split("?")[0]
                    if path in ("/", "/index.html"):
                        self._send(200, "text/html",
                                   _INDEX_HTML.encode())
                    elif path == "/info.json":
                        self._send(200, "application/json",
                                   json.dumps(outer.info()).encode())
                    elif path == "/inspect.json":
                        from urllib.parse import parse_qs
                        q = parse_qs(self.path.partition("?")[2])
                        self._send(200, "application/json", json.dumps(
                            outer.inspect(
                                q.get("page", ["output"])[0],
                                int(q.get("frame", ["0"])[0]),
                                int(q.get("x", ["0"])[0]),
                                int(q.get("y", ["0"])[0]),
                            )).encode())
                    elif path.startswith("/render/"):
                        parts = path[len("/render/"):].split("/")
                        pg = parts[0]
                        idx = int(parts[1].split(".")[0])
                        self._send(200, "image/png", outer.page_png(pg, idx))
                    else:
                        self._send(404, "text/plain", b"not found")
                except Exception as e:  # surface errors to the browser
                    self._send(500, "text/plain", str(e).encode())

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]

    def info(self) -> dict:
        st = self.state
        F = content_frames(st)
        psnr = None
        if st.tilemap is not None and st.tilemap.psnr is not None:
            psnr = [render.frame_psnr(st, f) for f in range(F)]
            if not any(psnr) and st.frames_rgb is not None:
                # reloaded stream: per-tile PSNR isn't in the bitstream,
                # but with source frames we can measure output vs input
                # directly (plain RGB PSNR, the GUI's fallback readout)
                psnr = [self._rgb_psnr(f) for f in range(F)]
        return {
            "frames": F,
            "width": st.width,
            "height": st.height,
            "fps": st.fps,
            "pages": self.pages,
            "keyframes": [
                {"index": k.index, "start": k.start_frame,
                 "end": k.end_frame, "reason": k.reason}
                for k in (st.keyframes or [])
            ],
            "tiles": (0 if st.corpus_pal_pixels is None
                      else int(len(st.corpus_pal_pixels))),
            "psnr": psnr,
        }

    def inspect(self, page: str, frame: int, x: int, y: int) -> dict:
        """Hover inspector (reference GUI hint surfaces, main.pas:294-333):
        map an image pixel to the cell / corpus tile / palette under it
        and return its details."""
        st = self.state
        tw = st.tilemap_w
        if page in ("input", "output"):
            tm = st.tilemap
            if tm is None:
                return {}
            F = content_frames(st)
            f = max(0, min(frame, F - 1))
            cy, cx = y // 8, x // 8
            if not (0 <= cy < st.tilemap_h and 0 <= cx < tw):
                return {}
            n = cy * tw + cx
            d = {
                "cell": n, "cy": cy, "cx": cx,
                "tile": int(tm.tile_idx[f, n]),
                "palette": int(tm.pal_idx[f, n]),
                "predicted": bool(tm.predicted[f, n]),
            }
            if d["predicted"]:
                d["pred_dx"] = int(tm.pred_x[f, n])
                d["pred_dy"] = int(tm.pred_y[f, n])
            if tm.hmirror is not None and tm.hmirror[f, n]:
                d["hmirror"] = True
            if tm.vmirror is not None and tm.vmirror[f, n]:
                d["vmirror"] = True
            if d["tile"] >= 0:
                d["tile_uses"] = self._use_count(d["tile"])
            if tm.psnr is not None:
                d["cell_psnr_db"] = round(float(tm.psnr[f, n]), 2)
            return d
        if page == "tiles":
            t = (y // 8) * 64 + x // 8  # render_tiles page_w_tiles=64
            if st.corpus_pal_pixels is None or t >= len(st.corpus_pal_pixels):
                return {}
            d = {"tile": t, "uses": self._use_count(t)}
            if st.corpus_pal_initial is not None:
                d["initial_palette"] = int(st.corpus_pal_initial[t])
            return d
        if page == "palettes":
            p, c = y // 8, x // 8  # render_palettes scale=8
            pal = np.asarray(st.palettes_rgb)
            if p >= len(pal) or c >= pal.shape[1]:
                return {}
            r, g, b = (int(v) for v in pal[p, c])
            return {"palette": p, "color": c,
                    "rgb": f"#{r:02x}{g:02x}{b:02x}"}
        return {}

    def _use_count(self, tile: int) -> int:
        """Tile use count: from Reindex's corpus_use when present, else
        recounted from the tilemap (reloaded streams)."""
        st = self.state
        if st.corpus_use is not None and tile < len(st.corpus_use):
            return int(st.corpus_use[tile])
        if self._uses is None and st.tilemap is not None:
            tid = st.tilemap.tile_idx.reshape(-1)
            emitted = tid >= 0
            self._uses = np.bincount(
                tid[emitted],
                minlength=(0 if st.corpus_pal_pixels is None
                           else len(st.corpus_pal_pixels)))
        if self._uses is not None and tile < len(self._uses):
            return int(self._uses[tile])
        return 0

    def _rgb_psnr(self, idx: int) -> float:
        src = np.asarray(self.state.frames_rgb[idx], np.float64)[..., :3]
        out = render.render_output(self.state, idx)[..., :3]
        mse = np.mean((src - np.asarray(out, np.float64)) ** 2)
        return float(10.0 * np.log10(255.0**2 / mse)) if mse else 99.0

    def page_png(self, page: str, idx: int) -> bytes:
        if page not in self.pages:
            raise ValueError(f"unknown page {page!r}")
        key = (page, idx if page in ("input", "output") else -1)
        if key in self._cache:
            return self._cache[key]
        st = self.state
        if page == "input":
            img = render.render_input(st, idx)
        elif page == "output":
            img = render.render_output(st, idx)
        elif page == "tiles":
            img = render.render_tiles(st)
        else:
            img = render.render_palettes(st)
        data = _png_bytes(img)
        if len(self._cache) > 64:  # bound the PNG cache
            self._cache.clear()
        self._cache[key] = data
        return data

    def serve_forever(self):
        print(f"preview: http://127.0.0.1:{self.port}/ "
              f"({len(self.pages)} pages, "
              f"{content_frames(self.state)} frames)")
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def preview_gtm(gtm_path: str, input_path: Optional[str] = None,
                host: str = "127.0.0.1", port: int = 8080,
                device="cuda") -> PreviewServer:
    """Re-import a .gtm (ReloadGTM parity) into inspectable state; with
    input_path the source frames are loaded too (enables the input page
    and makes width/height/fps authoritative from the video). The encoder
    that reads them runs on ``device``."""
    from .models.convert import state_to_numpy
    from .pipeline.encoder import Encoder

    enc = Encoder(log=lambda *a: None, device=device)
    if input_path:
        enc.settings.input_file_name = input_path
        enc.load_video(input_path)
    enc.reload_gtm(gtm_path)
    if enc.state.fps == 0:
        enc.state.fps = 24.0
    return PreviewServer(state_to_numpy(enc.state), host=host, port=port)
