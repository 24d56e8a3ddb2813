#!/usr/bin/env python3
"""The same synthetic clip through tiler_tpu and tiler_tpu_torch on the
CPU, under the same settings: the gap between the two encoders at a size
the tests leave out for time.

    JAX_PLATFORMS=cpu python3 scripts/torch_jax_encode_gap.py \\
        [--frames 8 --height 176 --width 320] [--set motion_rank_dims=48 ...] [--mesh]

Each ``--set field=value`` (repeatable; a list of values separated by
"|" runs one pair of encodes for each) overrides an EncoderSettings field
of both packages; palette_count defaults to 64 here. For each setting it
prints, for both packages, the decoded stream's RGB-PSNR, the encoder's
PSNR-HVS (by tile), the stream's bytes and the final tile count, then the
port's gap to the JAX package (docs/DETERMINISM.md's gate is 0.1 dB
RGB-PSNR and 2% bytes). With ``--mesh`` both encode on a mesh of one
device, (1, 1) ("data", "corpus"): the JAX package's mesh branch and the
port's (in a gloo group of one process), the same shard count and so
the same k-means seeding. Imports both packages, as the tests do.
"""
import argparse
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
    return rgb, float(enc.state.total_psnr), enc.stats.total_bytes, len(enc.state.corpus_pal_pixels)


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--height", type=int, default=176)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--set", action="append", default=[], metavar="FIELD=V1|V2")
    p.add_argument("--mesh", action="store_true", help="encode on a (1, 1) mesh")
    args = p.parse_args()
    if args.mesh:
        torch.distributed.init_process_group("gloo", init_method="tcp://127.0.0.1:0",
                                             world_size=1, rank=0)
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    clip = synthetic_clip(args.frames, args.height, args.width, seed=0)
    grid = [{"palette_count": 64}]
    for item in args.set:
        field, _, values = item.partition("=")
        grid = [{**g, field: _value(v)} for g in grid for v in values.split("|")]
    with tempfile.TemporaryDirectory() as d:
        for overrides in grid:
            got = {name: encode(name, clip, overrides, os.path.join(d, f"{name}.gtm"), args.mesh)
                   for name in ("jax", "torch")}
            (jr, jh, jb, jt), (tr, th, tb, tt) = got["jax"], got["torch"]
            print(f"{args.width}x{args.height}x{args.frames} {overrides}"
                  + (" on a (1, 1) mesh" if args.mesh else "") + ": "
                  f"jax RGB-PSNR {jr:.4f} dB, PSNR-HVS {jh:.4f} dB, {jb} bytes, {jt} tiles; "
                  f"torch {tr:.4f} dB, {th:.4f} dB, {tb} bytes, {tt} tiles; "
                  f"gap RGB-PSNR {tr - jr:+.4f} dB, PSNR-HVS {th - jh:+.4f} dB, "
                  f"bytes {(tb - jb) / jb:+.3%}", flush=True)


if __name__ == "__main__":
    main()
