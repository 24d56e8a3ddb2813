"""Decides ``correct``: the numbers the reference compares after the
window, each held to the limit of ``limits/<workload>.json``.

- ``stream_errors``: encodes of the window whose stream the plain decoder
  (``reference/gtm_decode.py``) cannot read through every frame at the
  clip's size. Exact: limit 0.
- ``decode_vs_state_px``: pixels where the first stream, decoded, differs
  from the frames the first encode's final tilemap, tiles and palettes
  stand for. It holds the save step and the bitstream to the state they
  were given. Exact: limit 0.
- ``hvs_mse``: the mean, over every cell of every frame, of the weighted-DCT
  squared error a coefficient (PSNR-HVS's inner term) between the first
  stream's decoded frames and the source clip. It holds dither, reconstruct
  and the palettization to the quality they give.
- ``tk_slots_off``: pixels where the dither kernel's slots differ from the
  reference's Thomas Knoll on the same inputs. Exact: limit 0.
- ``knn_gap``: the widest normalized gap of the top-k kernel's picks
  against float64 distances on the same operands (``reference/knn.py``),
  over a seeded sample of its launches; in cells where it launches.
- ``mesh_topk_gap``: the widest normalized gap of the mesh's corpus-sharded
  exact top-k (rank 0's picks, merged over every shard) against the k
  nearest rows of the whole corpus in float64 (``reference/knn.py``),
  over a seeded sample of the rows of its calls; in mesh cells.
- ``kmeans_gap``: the widest normalized gap of the mesh's corpus-sharded
  k-means (rank 0's assignments, gathered over every shard) against each
  point's nearest returned centroid in float64 (``reference/knn.py``),
  over every point of the palettization's first k-means; in mesh cells.
- ``epu_gap``: the widest normalized gap of the EPU re-rank's picks
  against float64 errors of every candidate pair in the precision the
  re-rank states (``reference/epu.py``), over a seeded sample of
  ``EPU_CELLS`` of the cells it ranked.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import epu, gtm_decode, knn, psnr_hvs, tk

ORDER = ("stream_errors", "decode_vs_state_px", "hvs_mse", "tk_slots_off", "knn_gap",
         "mesh_topk_gap", "kmeans_gap", "epu_gap")
EPU_CELLS = 256


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def decode_streams(window, clip) -> tuple[int, np.ndarray | None, list]:
    """(encodes whose stream fails to decode to the clip's frames and
    size, the first stream's decoded RGB frames or None, errors)."""
    bad, errors, first = set(), [], None
    F, H, W = clip.shape[:3]
    for sha, data in window.streams.items():
        try:
            st, frames = gtm_decode.decode(data)
            if frames.shape[:3] != (F, H, W) or st.header["frame_count"] != F:
                raise ValueError(f"decoded {frames.shape[:3]}, header {st.header['frame_count']} "
                                 f"frames, clip {(F, H, W)}")
        except ValueError as e:
            bad.add(sha)
            errors.append(f"stream {sha[:12]}: {e}")
            continue
        if sha == window.first_sha:
            first = frames
    n_bad = sum(1 for e in window.encodes if e.ok and e.sha256 in bad)
    return n_bad, first, errors


def judge(window, clip, capture, device: str) -> tuple[dict, dict, list]:
    """(numbers by name, quality {"psnr_hvs_db", "stream_bytes"}, notes)."""
    nums, quality, notes = {}, {}, []
    n_bad, decoded, errors = decode_streams(window, clip)
    notes += errors
    nums["stream_errors"] = n_bad
    if decoded is not None:
        s = window.first_state
        want = gtm_decode.render_state(s["tilemap"], _host(s["tiles"]), _host(s["palettes"]),
                                       None if s["valid"] is None else _host(s["valid"]),
                                       s["height"], s["width"])
        nums["decode_vs_state_px"] = int((want != decoded).any(axis=-1).sum())
        mse = psnr_hvs.per_cell_mse(torch.as_tensor(decoded, device=device),
                                    torch.as_tensor(clip, device=device))
        nums["hvs_mse"] = float(mse.mean())
        quality["psnr_hvs_db"] = psnr_hvs.psnr_hvs(mse)
        quality["stream_bytes"] = len(window.streams[window.first_sha])
    if capture.tk is not None:
        pix, mirror, pal_idx, table, got = capture.tk
        nums["tk_slots_off"] = int((tk.select(pix, mirror, pal_idx, table) != got).sum())
    if capture.knn:
        gaps = [knn.gap(fa, dsTa, k1, k2) for _, fa, dsTa, k1, k2 in capture.knn]
        nums["knn_gap"] = max(gaps)
        notes.append("knn_gap by sampled launch: " + ", ".join(
            f"#{i} {g:.6g}" for (i, *_), g in zip(capture.knn, gaps)))
    if capture.topk and capture.topk_corpus is not None:
        feats, picks = (torch.cat(parts) for parts in zip(*capture.topk))
        nums["mesh_topk_gap"] = knn.topk_gap(feats, picks, capture.topk_corpus)
        notes.append(f"mesh_topk_gap over {len(feats)} rows of {len(capture.topk)} calls, "
                     f"k {picks.shape[1]}, against {len(capture.topk_corpus)} corpus rows")
    if capture.kmeans is not None:
        points, cents, assign = capture.kmeans
        nums["kmeans_gap"] = knn.kmeans_gap(points, cents, assign)
        notes.append(f"kmeans_gap over {len(points)} points, {len(cents)} centroids")
    if capture.epu and capture.epu_corpus is not None:
        cells = capture.epu_cells(EPU_CELLS)
        nums["epu_gap"] = epu.gap(*cells, *capture.epu_corpus)
        notes.append(f"epu_gap over {len(cells[0])} of the re-rank's cells")
    return nums, quality, notes


def hold(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}} in
    ``ORDER``). A number the cell's limits name but the run could not
    compute fails."""
    checks, ok = {}, True
    for name in ORDER:
        if name not in limits:
            continue
        value = nums.get(name)
        passed = value is not None and value <= limits[name]
        ok &= passed
        checks[name] = {"value": value, "limit": limits[name]}
    return ok, checks
