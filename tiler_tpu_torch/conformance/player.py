"""Drive the UNCHANGED reference JS decoder through the jsvm interpreter.

Loads /root/reference/decoders/htmljs/{lzma.js, lzma.shim.js, wlzma.js,
wlzma.wrk.js, gtm.player.js} verbatim (same order as index.html), supplies
the browser surface they expect (document/canvas/ImageData, Worker via a
task queue, XMLHttpRequest, Blob/URL, setTimeout/setInterval), then pumps
the event loop and captures every putImageData as a decoded frame.

The Worker shim evaluates the blob built by resetDecoding from
worker_function.toString() (gtm.player.js:141) in a fresh global scope, so
wlzma.wrk.js's importScripts path and the js-lzma decode loop execute
exactly as in a browser — messages are queued, never delivered
synchronously, preserving the manager/worker handshake ordering.
"""
from __future__ import annotations

import os

import numpy as np

from .jsvm import (
    UNDEF,
    Interpreter,
    JSArray,
    JSArrayBuffer,
    JSError,
    JSObject,
    JSTypedArray,
    NativeFunction,
    js_str,
    js_tonumber,
)

REFERENCE_HTMLJS = "/root/reference/decoders/htmljs"
SCRIPT_ORDER = ("lzma.js", "lzma.shim.js", "wlzma.js", "wlzma.wrk.js", "gtm.player.js")


class _Worker:
    """One shimmed Web Worker: a separate global scope + message queues."""

    def __init__(self, harness, url):
        self.harness = harness
        self.js_obj = JSObject(cls="Worker")
        interp = harness.interp
        src = harness.blobs.get(url)
        if src is None:
            src = open(harness._resolve(url)).read()
        self.genv = interp.new_realm_env()
        g = self.genv.vars
        g["self"] = JSObject(cls="WorkerGlobalScope")

        def _import_scripts(this, args):
            for a in args:
                path = harness._resolve(js_str(a))
                interp.eval_script(open(path).read(), self.genv)
            return UNDEF

        g["importScripts"] = NativeFunction("importScripts", _import_scripts)

        def _post_to_main(this, args):
            data = args[0] if args else UNDEF
            def deliver():
                cb = self.js_obj.get("onmessage")
                if cb is not UNDEF:
                    ev = JSObject()
                    ev.props["data"] = data
                    interp.call_function(cb, [ev], this=self.js_obj)
            harness.tasks.append(deliver)
            return UNDEF

        g["postMessage"] = NativeFunction("postMessage", _post_to_main)

        def _post_to_worker(this, args):
            data = args[0] if args else UNDEF
            def deliver():
                cb = self.genv.vars.get("onmessage", UNDEF)
                if cb is not UNDEF:
                    ev = JSObject()
                    ev.props["data"] = data
                    interp.call_function(cb, [ev])
            harness.tasks.append(deliver)
            return UNDEF

        self.js_obj.props["postMessage"] = NativeFunction("postMessage", _post_to_worker)
        interp.eval_script(src, self.genv)


class PlayerHarness:
    def __init__(self, js_dir: str = REFERENCE_HTMLJS, doc_url: str | None = None):
        self.js_dir = js_dir
        self.interp = Interpreter()
        self.tasks = []  # main event queue (thunks)
        self.intervals = {}  # id -> callback
        self.timeouts = []
        self._next_timer = [1]
        self.blobs = {}
        self._blob_n = [0]
        self.frames = []  # captured RGBA bytes + dims
        self.xhr_files = {}
        self.canvases = {}
        doc_url = doc_url or "file://" + os.path.join(js_dir, "index.html")
        self._install_dom(doc_url)
        for name in SCRIPT_ORDER:
            self.interp.eval_script(open(os.path.join(js_dir, name)).read())

    def _resolve(self, url):
        if url.startswith("file://"):
            url = url[len("file://"):]
        if not os.path.isabs(url):
            url = os.path.join(self.js_dir, url)
        return url

    # ------------------------------------------------------------------
    def _install_dom(self, doc_url):
        interp = self.interp
        g = interp.global_env.vars

        # window/self: same object so `window != self` is false in main scope
        win = JSObject(cls="Window")
        g["window"] = win
        g["self"] = win

        # document
        doc = JSObject(cls="Document")
        doc.props["URL"] = doc_url

        def get_element(this, args):
            cid = js_str(args[0])
            cv = self.canvases.get(cid)
            if cv is None:
                cv = self._make_canvas()
                self.canvases[cid] = cv
            return cv

        doc.props["getElementById"] = NativeFunction("getElementById", get_element)
        g["document"] = doc

        # URL.createObjectURL + Blob
        def blob_ctor(args):
            parts = args[0] if args else JSArray()
            text = "".join(js_str(p) for p in parts.items) if isinstance(parts, JSArray) else ""
            b = JSObject(cls="Blob")
            b.props["_text"] = text
            return b

        g["Blob"] = NativeFunction("Blob", lambda this, args: blob_ctor(args), blob_ctor)
        urlobj = JSObject()

        def create_object_url(this, args):
            key = f"blob:jsvm/{self._blob_n[0]}"
            self._blob_n[0] += 1
            self.blobs[key] = js_str(args[0].get("_text")) if args else ""
            return key

        urlobj.props["createObjectURL"] = NativeFunction("createObjectURL", create_object_url)
        g["URL"] = urlobj

        # Worker
        def worker_ctor(args):
            w = _Worker(self, js_str(args[0]))
            return w.js_obj

        g["Worker"] = NativeFunction("Worker", lambda this, args: UNDEF, worker_ctor)

        # XMLHttpRequest
        def xhr_ctor(args):
            xhr = JSObject(cls="XMLHttpRequest")

            def _open(this, a):
                xhr.props["_url"] = js_str(a[1])
                return UNDEF

            def _send(this, a):
                def deliver():
                    path = self._resolve(js_str(xhr.get("_url")))
                    data = bytearray(open(path, "rb").read())
                    xhr.props["response"] = JSArrayBuffer(data)
                    xhr.props["status"] = 200
                    cb = xhr.get("onload")
                    if cb is not UNDEF:
                        self.interp.call_function(cb, [JSObject()], this=xhr)
                self.tasks.append(deliver)
                return UNDEF

            xhr.props["open"] = NativeFunction("open", _open)
            xhr.props["send"] = NativeFunction("send", _send)
            return xhr

        g["XMLHttpRequest"] = NativeFunction("XMLHttpRequest", lambda this, args: UNDEF, xhr_ctor)

        # timers
        def set_timeout(this, args):
            fn = args[0]
            tid = self._next_timer[0]
            self._next_timer[0] += 1
            self.tasks.append(lambda: interp.call_function(fn, []))
            return tid

        def set_interval(this, args):
            fn = args[0]
            tid = self._next_timer[0]
            self._next_timer[0] += 1
            self.intervals[tid] = fn
            return tid

        def clear_interval(this, args):
            if args:
                self.intervals.pop(int(js_tonumber(args[0])), None)
            return UNDEF

        g["setTimeout"] = NativeFunction("setTimeout", set_timeout)
        g["setInterval"] = NativeFunction("setInterval", set_interval)
        g["clearInterval"] = NativeFunction("clearInterval", clear_interval)
        g["clearTimeout"] = NativeFunction("clearTimeout", lambda this, args: UNDEF)

    def _make_canvas(self):
        cv = JSObject(cls="HTMLCanvasElement")
        cv.props["width"] = 0
        cv.props["height"] = 0
        ctx = JSObject(cls="CanvasRenderingContext2D")
        ctx.props["fillStyle"] = "black"
        ctx.props["fillRect"] = NativeFunction("fillRect", lambda this, args: UNDEF)

        def get_image_data(this, args):
            w = int(js_tonumber(args[2]))
            h = int(js_tonumber(args[3]))
            img = JSObject(cls="ImageData")
            img.props["width"] = w
            img.props["height"] = h
            # the player calls getImageData right after fillRect black:
            # a real canvas reads back opaque black (0, 0, 0, 255)
            data = bytearray(w * h * 4)
            data[3::4] = b"\xff" * (w * h)
            img.props["data"] = JSTypedArray(data, clamped=True)
            return img

        def put_image_data(this, args):
            img = args[0]
            data = img.get("data")
            self.frames.append(
                (int(js_tonumber(img.get("width"))), int(js_tonumber(img.get("height"))),
                 bytes(data.data))
            )
            return UNDEF

        ctx.props["getImageData"] = NativeFunction("getImageData", get_image_data)
        ctx.props["putImageData"] = NativeFunction("putImageData", put_image_data)
        cv.props["getContext"] = NativeFunction("getContext", lambda this, args: ctx)
        return cv

    # ------------------------------------------------------------------
    def pump(self, want_frames: int, max_steps: int = 2_000_000):
        """Drain tasks; tick intervals while frames are still needed."""
        steps = 0
        while steps < max_steps:
            steps += 1
            if self.tasks:
                t = self.tasks.pop(0)
                t()
                continue
            if len(self.frames) > want_frames:
                return
            if self.intervals:
                for fn in list(self.intervals.values()):
                    self.interp.call_function(fn, [])
                continue
            return  # queue empty, no intervals: stalled

    def decode(self, gtm_path: str, n_frames: int):
        """Play `gtm_path` and return [F, H, W, 3] uint8 + alpha [F, H, W]."""
        self.interp.call_function(
            self.interp.global_env.vars["gtmPlayFromURL"],
            [os.path.abspath(gtm_path), "frame"],
        )
        self.pump(n_frames + 1)
        # double-buffered display: decodeFrame k+2 paints frame k (renderEnd
        # shows gtmTMImageData[dblBuff], which call k+1 did NOT draw into —
        # the first two putImageData are the black init buffers)
        frames = self.frames[2 : 2 + n_frames]
        if len(frames) != n_frames:
            raise AssertionError(
                f"reference player rendered {len(frames)} frames, wanted {n_frames}; "
                f"console={self.interp.console[-5:]}"
            )
        out = []
        alpha = []
        for w, h, data in frames:
            a = np.frombuffer(data, np.uint8).reshape(h, w, 4)
            out.append(a[..., :3].copy())
            alpha.append(a[..., 3].copy())
        return np.stack(out), np.stack(alpha)


def decode_with_reference_player(gtm_path: str, n_frames: int,
                                 js_dir: str = REFERENCE_HTMLJS):
    """Decode a .gtm with the unchanged reference JS player; returns
    (rgb [F, H, W, 3] uint8, alpha [F, H, W] uint8, console log)."""
    h = PlayerHarness(js_dir=js_dir)
    rgb, alpha = h.decode(gtm_path, n_frames)
    return rgb, alpha, h.interp.console
