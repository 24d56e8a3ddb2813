#!/usr/bin/env python3
"""The same synthetic clip through tiler_tpu and tiler_tpu_torch on the
CPU, under the same settings: the gap between the two encoders at a size
the tests leave out for time.

    JAX_PLATFORMS=cpu python3 scripts/torch_jax_encode_gap.py \\
        [--frames 8 --height 176 --width 320] [--set motion_rank_dims=48 ...] [--mesh] \\
        [--threads N] [--stages]

Each ``--set field=value`` (repeatable; a list of values separated by
"|" runs one pair of encodes for each) overrides an EncoderSettings field
of both packages; palette_count defaults to 64 here. For each setting it
prints, for both packages, the decoded stream's RGB-PSNR, the encoder's
PSNR-HVS (by tile), the stream's bytes, the final tile count and the
first 16 hex digits of the stream's sha256, then the
port's gap to the JAX package (docs/DETERMINISM.md's gate is 0.1 dB
RGB-PSNR and 2% bytes). With ``--mesh`` both encode on a mesh of one
device, (1, 1) ("data", "corpus"): the JAX package's mesh branch and the
port's (in a gloo group of one process), the same shard count and so
the same k-means seeding. ``--threads N`` sets torch's CPU threads
(default: up to 8); the port's stream must not depend on it. Imports
both packages, as the tests do.

With ``--stages`` it instead runs the JAX package's encode step by step
and each port stage from the JAX package's state before it (the method
of tests/test_torch_stages.py, at this size), and prints per stage what
agrees: predict_motion's vectors (equal, both at the PSNR clamp, or
neither, with the first of those (frame, tile row, tile column)),
whether reduce, prepare_palettes, dither and reindex write the same
arrays, and reconstruct's winners, PSNR-HVS and final tile count.
"""
import argparse
import hashlib
import os
import sys
import tempfile

import jax
import numpy as np
import torch

sys.path.insert(0, __file__.rsplit("/scripts/", 1)[0])
from bench import synthetic_clip  # noqa: E402
from tiler_tpu.bitstream.gtm import GTMDecoder  # noqa: E402
from tiler_tpu.config import EncoderSettings as JaxSettings  # noqa: E402
from tiler_tpu.parallel import make_mesh  # noqa: E402
from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder  # noqa: E402
from tiler_tpu_torch.config import EncoderSettings  # noqa: E402
from tiler_tpu_torch.parallel.mesh import make_mesh as t_make_mesh  # noqa: E402
from tiler_tpu_torch.pipeline.encoder import Encoder  # noqa: E402


def _value(text: str):
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def encode(name, clip, overrides, out, mesh):
    if name == "jax":
        with jax.enable_x64(False):
            enc = JaxEncoder(JaxSettings(**overrides), log=None,
                             mesh=make_mesh(1, ("data", "corpus")) if mesh else None)
            enc.run_all(clip, fps=25.0, out_path=out)
    else:
        enc = Encoder(EncoderSettings(**overrides), log=None, device="cpu",
                      mesh=t_make_mesh(1, ("data", "corpus"), device_type="cpu") if mesh else None)
        enc.run_all(clip, fps=25.0, out_path=out)
    frames = np.stack(GTMDecoder(out).decode_frames())[..., :3].astype(np.float64)
    rgb = 10 * np.log10(255 * 255 / max(np.mean((frames - clip) ** 2), 1e-9))
    with open(out, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return (rgb, float(enc.state.total_psnr), enc.stats.total_bytes,
            len(enc.state.corpus_pal_pixels), digest)


def _same(a, b) -> bool:
    return np.array_equal(np.asarray(a), np.asarray(b))


def stages(clip, overrides):
    import copy

    from tiler_tpu_torch.models.convert import state_from_numpy, state_to_numpy
    from tiler_tpu_torch.pipeline import dither, palettes, predict, reconstruct, reduce, reindex

    steps = ("predict_motion", "reduce", "prepare_palettes", "dither", "reconstruct", "reindex")
    with jax.enable_x64(False):
        enc = JaxEncoder(JaxSettings(**overrides), log=None)
        enc.load_frames(clip, 25.0)
        enc.state.ensure_ingest()
        snaps = {"load": state_to_numpy(copy.copy(enc.state))}
        for step in steps:
            getattr(enc, step)()
            snaps[step] = state_to_numpy(copy.copy(enc.state))
    settings = EncoderSettings(**overrides)
    port = {}
    for before, step, run in (("load", "predict_motion", predict.predict_motion),
                              ("predict_motion", "reduce", reduce.reduce_tiles),
                              ("reduce", "prepare_palettes", palettes.prepare_palettes),
                              ("prepare_palettes", "dither", dither.dither),
                              ("dither", "reconstruct", reconstruct.reconstruct),
                              ("reconstruct", "reindex", reindex.reindex)):
        st = state_from_numpy(snaps[before], "cpu")
        st = run(st, settings)
        port[step] = st
    tag = f"{clip.shape[2]}x{clip.shape[1]}x{clip.shape[0]} {overrides}"
    g, w = port["predict_motion"].tilemap, snaps["predict_motion"].tilemap
    same = (g.pred_x == w.pred_x) & (g.pred_y == w.pred_y)
    clamped = ~same & (g.psnr >= 51.0) & (w.psnr >= 51.0)
    other = np.argwhere(~same & ~clamped)
    cols = clip.shape[2] // 8
    print(f"{tag} predict_motion: {same.size} vectors, {int(same.sum())} equal, "
          f"{int(clamped.sum())} differ with both at the PSNR clamp, {len(other)} differ "
          "otherwise (frame, tile row, tile column): "
          + ", ".join(f"({f}, {i // cols}, {i % cols})" for f, i in other[:8]), flush=True)
    st, want = port["reduce"], snaps["reduce"]
    print(f"{tag} reduce: corpus {'equal' if _same(st.corpus_rgb, want.corpus_rgb) else 'DIFFERS'}"
          f" (T {len(st.corpus_rgb)} against {len(want.corpus_rgb)}), tile_idx "
          f"{'equal' if _same(st.tilemap.tile_idx, want.tilemap.tile_idx) else 'DIFFERS'}",
          flush=True)
    st, want = port["prepare_palettes"], snaps["prepare_palettes"]
    init = np.asarray(st.corpus_pal_initial) == np.asarray(want.corpus_pal_initial)
    print(f"{tag} prepare_palettes: corpus_pal_initial equal on {init.mean():.2%}, palettes "
          f"{'equal' if _same(st.palettes_rgb, want.palettes_rgb) else 'DIFFER'}", flush=True)
    st, want = port["dither"], snaps["dither"]
    print(f"{tag} dither: corpus_pal_pixels "
          f"{'equal' if _same(st.corpus_pal_pixels, want.corpus_pal_pixels) else 'DIFFER'}",
          flush=True)
    st, want = port["reconstruct"], snaps["reconstruct"]
    g, w = st.tilemap, want.tilemap
    both = ~g.predicted & ~w.predicted
    agree = (g.tile_idx[both] == w.tile_idx[both]) & (g.pal_idx[both] == w.pal_idx[both])
    st = reindex.reindex(st, settings)
    print(f"{tag} reconstruct: predicted flags equal on {(g.predicted == w.predicted).mean():.4%}, "
          f"winners equal on {agree.mean():.4%} of {int(both.sum())} cells, PSNR-HVS "
          f"{st.total_psnr:.4f} against {want.total_psnr:.4f} dB, final tiles after reindex "
          f"{len(st.corpus_pal_pixels)} against {len(snaps['reindex'].corpus_pal_pixels)}",
          flush=True)
    st, want = port["reindex"], snaps["reindex"]
    equal = all(_same(getattr(st, f), getattr(want, f))
                for f in ("corpus_pal_pixels", "corpus_use", "corpus_rgb"))
    print(f"{tag} reindex: {'equal' if equal else 'DIFFERS'}", flush=True)


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--height", type=int, default=176)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--set", action="append", default=[], metavar="FIELD=V1|V2")
    p.add_argument("--mesh", action="store_true", help="encode on a (1, 1) mesh")
    p.add_argument("--threads", type=int, default=max(1, min(8, os.cpu_count() or 1)),
                   help="torch CPU threads (default: up to 8)")
    p.add_argument("--stages", action="store_true",
                   help="each port stage from the JAX package's state before it")
    args = p.parse_args()
    if args.mesh:
        torch.distributed.init_process_group("gloo", init_method="tcp://127.0.0.1:0",
                                             world_size=1, rank=0)
    torch.set_num_threads(args.threads)
    clip = synthetic_clip(args.frames, args.height, args.width, seed=0)
    grid = [{"palette_count": 64}]
    for item in args.set:
        field, _, values = item.partition("=")
        grid = [{**g, field: _value(v)} for g in grid for v in values.split("|")]
    if args.stages:
        for overrides in grid:
            stages(clip, overrides)
        return
    with tempfile.TemporaryDirectory() as d:
        for overrides in grid:
            got = {name: encode(name, clip, overrides, os.path.join(d, f"{name}.gtm"), args.mesh)
                   for name in ("jax", "torch")}
            (jr, jh, jb, jt, jd), (tr, th, tb, tt, td) = got["jax"], got["torch"]
            print(f"{args.width}x{args.height}x{args.frames} {overrides}"
                  + (" on a (1, 1) mesh" if args.mesh else "") + ": "
                  f"jax RGB-PSNR {jr:.4f} dB, PSNR-HVS {jh:.4f} dB, {jb} bytes, {jt} tiles, "
                  f"sha256 {jd}; torch {tr:.4f} dB, {th:.4f} dB, {tb} bytes, {tt} tiles, "
                  f"sha256 {td}; "
                  f"gap RGB-PSNR {tr - jr:+.4f} dB, PSNR-HVS {th - jh:+.4f} dB, "
                  f"bytes {(tb - jb) / jb:+.3%}", flush=True)


if __name__ == "__main__":
    main()
