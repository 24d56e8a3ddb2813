"""The measured window: a closed loop of whole encodes of one clip, one
after another, each a new ``Encoder`` whose steps are called one by one in
``run_all``'s order with a span (host clock) around each. An encode that
starts before the deadline finishes and counts.

:class:`Capture` keeps, for the window's first encode, what the dither
kernel, a seeded sample of the top-k kernel's launches and a seeded sample
of the cells of the EPU re-rank were given and returned, so the reference
can judge them on the timed encode's own inputs after the window; and the
first encode's final tilemap, tiles and palettes, which its stream has to
carry.
"""
from __future__ import annotations

import hashlib
import random
import time
import traceback
from dataclasses import dataclass, field

import numpy as np

STEPS = ("load", "predict_motion", "reduce", "prepare_palettes", "dither",
         "reconstruct", "reindex", "save")


class Capture:
    """Observes ``tk_select`` (as the dither step calls it), the B2 kernel
    ``knn_bucket_top2`` and the EPU re-rank ``_epu_rank_all`` (with the
    corpus and palettes that phase A starts from) while :attr:`active`."""

    def __init__(self, seed: int, knn_samples: int = 2, epu_cells: int = 32):
        self.active = False
        self.tk = None  # (pix, mirror, pal_idx, table, slots)
        self.knn = []  # [(launch number, fa, dsTa, k1, k2)]
        self.knn_launches = []  # [(rows, tiles padded, real rows: device scalar)]
        self.epu = []  # [(feats, cand_idx, cand_pal, tile, pal)] of sampled cells, a launch each
        self.epu_corpus = None  # (corpus palette indices, palettes RGB) phase A ranked
        self._rng = random.Random(seed)
        self._np_rng = np.random.RandomState(seed % (1 << 32))
        self._keep = knn_samples
        self._epu_cells = epu_cells

    def install(self):
        """Wrap the kernels and the re-rank; returns a function that
        unwraps them."""
        import torch

        from tiler_tpu_torch.kernels import knn_topk
        from tiler_tpu_torch.pipeline import dither, reconstruct

        tk_orig, knn_orig = dither.tk_select, knn_topk.knn_bucket_top2
        phase_orig, epu_orig = reconstruct._knn_phase, reconstruct._epu_rank_all

        def knn_phase(state, *args, **kw):
            if self.active and self.epu_corpus is None:
                pal = state.palettes_rgb
                self.epu_corpus = (state.corpus_pal_pixels.clone(),
                                   pal.clone() if hasattr(pal, "clone") else np.array(pal))
            return phase_orig(state, *args, **kw)

        def epu_rank_all(feats, cand_idx, cand_pal, G, Q, *args, **kw):
            t, p = epu_orig(feats, cand_idx, cand_pal, G, Q, *args, **kw)
            if self.active:
                n = feats.shape[0]
                sel = torch.as_tensor(np.sort(self._np_rng.choice(
                    n, min(n, self._epu_cells), replace=False)), device=feats.device)
                self.epu.append((feats[sel], cand_idx[sel], cand_pal[sel], t[sel], p[sel]))
            return t, p

        def tk_select(pix, mirror, pal_idx, table):
            out = tk_orig(pix, mirror, pal_idx, table)
            if self.active and self.tk is None:
                self.tk = (pix, mirror, pal_idx, table, out)
            return out

        def knn_bucket_top2(fa, dsTa):
            k1, k2 = knn_orig(fa, dsTa)
            if self.active:
                i = len(self.knn_launches)
                self.knn_launches.append((fa.shape[0], dsTa.shape[1], (fa != 0).any(dim=1).sum()))
                item = (i, fa, dsTa, k1, k2)
                if len(self.knn) < self._keep:  # a reservoir sample of the launches
                    self.knn.append(item)
                else:
                    j = self._rng.randrange(i + 1)
                    if j < self._keep:
                        self.knn[j] = item
            return k1, k2

        # the kernel wrapper counts its launches on the function its module
        # names, which is now this one
        knn_bucket_top2.launches = getattr(knn_orig, "launches", 0)
        dither.tk_select = tk_select
        knn_topk.knn_bucket_top2 = knn_bucket_top2
        reconstruct._knn_phase = knn_phase
        reconstruct._epu_rank_all = epu_rank_all

        def uninstall():
            dither.tk_select = tk_orig
            knn_orig.launches = knn_bucket_top2.launches
            knn_topk.knn_bucket_top2 = knn_orig
            reconstruct._knn_phase = phase_orig
            reconstruct._epu_rank_all = epu_orig

        return uninstall

    def epu_cells(self, most: int) -> tuple:
        """The re-rank's sampled cells, at most ``most`` of them drawn from
        the seed: (feats, cand_idx, cand_pal, tile, pal)."""
        import torch

        cells = tuple(torch.cat(parts) for parts in zip(*self.epu))
        n = len(cells[0])
        if n <= most:
            return cells
        keep = torch.as_tensor(np.sort(self._np_rng.choice(n, most, replace=False)),
                               device=cells[0].device)
        return tuple(x[keep] for x in cells)


@dataclass
class Encode:
    ok: bool
    spans: dict = field(default_factory=dict)  # step -> (start, end), perf_counter s
    step_stats: dict = field(default_factory=dict)
    sha256: str = ""
    error: str = ""


@dataclass
class Window:
    start: float  # perf_counter s
    end: float
    encodes: list
    streams: dict  # sha256 -> bytes, every distinct stream of the window
    first_sha: str
    first_state: dict  # the first encode's tilemap, tiles, palettes, valid
    wall_offset_ns: int  # time.time_ns() - perf_counter_ns() at the start

    @property
    def seconds(self) -> float:
        return self.end - self.start


def encode_once(settings, clip, fps: float, path: str, device: str):
    """One whole encode with a span around each step: (encoder, spans)."""
    from tiler_tpu_torch.pipeline.encoder import Encoder

    enc = Encoder(settings, log=None, device=device)
    calls = {"load": lambda: enc.load_frames(clip, fps), "save": lambda: enc.save(path)}
    spans = {}
    for step in STEPS:
        t0 = time.perf_counter()
        (calls[step] if step in calls else getattr(enc, step))()
        spans[step] = (t0, time.perf_counter())
    return enc, spans


def final_state(enc) -> dict:
    st = enc.state
    tm = st.tilemap
    return dict(tilemap={k: getattr(tm, k) for k in ("tile_idx", "pal_idx", "predicted",
                                                     "pred_x", "pred_y", "hmirror", "vmirror")},
                tiles=st.corpus_pal_pixels, palettes=st.palettes_rgb,
                valid=st.palettes_valid, height=st.height, width=st.width)


def run(settings, clip, fps: float, seconds: float, path: str, device: str,
        capture: Capture, log) -> Window:
    encodes, streams = [], {}
    first_sha, first_state = "", None
    wall_offset = time.time_ns() - time.perf_counter_ns()
    start = time.perf_counter()
    deadline = start + seconds
    end = start
    while time.perf_counter() < deadline:
        capture.active = not first_sha
        try:
            enc, spans = encode_once(settings, clip, fps, path, device)
            with open(path, "rb") as fh:
                data = fh.read()
            sha = hashlib.sha256(data).hexdigest()
            streams.setdefault(sha, data)
            if not first_sha:
                first_sha, first_state = sha, final_state(enc)
            encodes.append(Encode(True, spans, dict(enc.step_stats), sha))
            del enc
        except Exception:  # an encode that raises counts as failed; the window goes on
            encodes.append(Encode(False, error=traceback.format_exc()))
            log(encodes[-1].error)
        finally:
            capture.active = False
        end = time.perf_counter()
    return Window(start, end, encodes, streams, first_sha, first_state, wall_offset)
