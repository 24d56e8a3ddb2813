"""Headless CLI of the port.

  python -m tiler_tpu_torch <settings.ini>             full encode
  python -m tiler_tpu_torch encode -i IN -o OUT [...]  encode with flags
  python -m tiler_tpu_torch decode IN.gtm OUT.y4m      decode to Y4M (or PNGs)
  python -m tiler_tpu_torch info IN.gtm [--full]       header (and stream) dump
  python -m tiler_tpu_torch selftest                   math invariants

Settings files are the JAX package's (``EncoderSettings.from_ini``). The
device is ``cuda`` unless ``--device`` names another.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

SUBCOMMANDS = ("encode", "decode", "info", "selftest")


def _settings(path, overrides):
    from .config import EncoderSettings

    s = EncoderSettings.from_ini(path) if path else EncoderSettings()
    for k, v in overrides.items():
        if v is not None:
            setattr(s, k, v)
    return s


def cmd_encode(args):
    from .pipeline.encoder import Encoder

    settings = _settings(args.settings, dict(
        input_file_name=args.input,
        output_file_name=args.output,
        palette_count=args.palette_count,
        palette_size=args.palette_size,
        motion_predict_radius=args.radius,
        global_tiling_quality_based_tile_count=args.quality,
        frame_count=args.frames,
    ))
    enc = Encoder(settings, device=args.device)
    enc.run_all()
    if args.checkpoint:
        enc.save_checkpoint(args.checkpoint)
    return 0


def cmd_decode(args):
    """Every frame of a .gtm, to a C444 Y4M (at 24 fps, as the JAX
    package's CLI writes it) or to ``<base>_%04d.png``."""
    from .bitstream.gtm import GTMDecoder

    frames = GTMDecoder(args.input).decode_frames()
    if args.output.endswith(".y4m"):
        from .io.export import write_y4m

        write_y4m(args.output, [f[..., :3] for f in frames], 24.0)
    else:
        from .io.export import write_pngs

        write_pngs(args.output, frames)
    print(f"decoded {len(frames)} frames")
    return 0


def cmd_info(args):
    """The header as JSON; with ``--full`` the structured read too."""
    from .bitstream.gtm import GTMReader, parse_header

    with open(args.input, "rb") as f:
        raw = f.read()
    print(json.dumps(parse_header(raw), indent=2))
    if args.full:
        g = GTMReader.read(raw)
        print(f"tiles: {g.tile_count}, palettes: "
              f"{0 if g.palettes_rgb is None else len(g.palettes_rgb)}, "
              f"palette_size: {g.palette_size}, frames: {len(g.frames)}")
        print("--- embedded settings ---")
        print(g.settings_text)
    return 0


def cmd_selftest(args):
    """Math invariants (the reference's TTilingEncoder.Test), in torch
    float64 on the CPU: YUV and LAB round trips of 10,000 random colors,
    and the feature transform and its inverse in the three invertible
    modes (dct, weighted_dct, wavelets) on a gradient tile."""
    import torch

    from .ops import color, dct

    rng = np.random.RandomState(0x42381337 & 0x7FFFFFFF)
    rgb = torch.as_tensor(rng.randint(0, 256, (10000, 3)).astype(np.float64))
    assert torch.equal(color.yuv_to_rgb(color.rgb_to_yuv(rgb)), rgb), "YUV"
    assert torch.equal(color.lab_to_rgb(color.rgb_to_lab(rgb)), rgb), "LAB"
    i = np.arange(8)[:, None]
    j = np.arange(8)[None, :]
    t = torch.as_tensor(np.stack([i * 8 + 0 * j, j * 32 + 0 * i, i * j], -1).astype(np.float64))
    for mode in ("dct", "weighted_dct", "wavelets"):
        back = dct.inv_tile_features(dct.tile_features(t, mode=mode), mode=mode)
        assert torch.equal(back, t), mode
    print("selftest ok")
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) == 1 and not argv[0].startswith("-") and argv[0] not in SUBCOMMANDS:
        from .pipeline.encoder import Encoder

        enc = Encoder(_settings(argv[0], {}), device="cuda",
                      log=lambda *a: print(*a, flush=True))
        enc.run_all()
        return 0

    p = argparse.ArgumentParser(prog="python -m tiler_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    e = sub.add_parser("encode")
    e.add_argument("-i", "--input", help="video/y4m/image-sequence path")
    e.add_argument("-o", "--output", help="output .gtm path")
    e.add_argument("-s", "--settings", help="settings .ini")
    e.add_argument("--palette-count", type=int, dest="palette_count")
    e.add_argument("--palette-size", type=int, dest="palette_size")
    e.add_argument("--radius", type=int)
    e.add_argument("--quality", type=float)
    e.add_argument("--frames", type=int)
    e.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    e.add_argument("--checkpoint", help="write the encoder state after the run "
                   "(loads in either package's Encoder.load_checkpoint)")
    e.set_defaults(fn=cmd_encode)
    d = sub.add_parser("decode")
    d.add_argument("input")
    d.add_argument("output", help="OUT.y4m, or a PNG base name")
    d.set_defaults(fn=cmd_decode)
    i = sub.add_parser("info")
    i.add_argument("input")
    i.add_argument("--full", action="store_true")
    i.set_defaults(fn=cmd_info)
    t = sub.add_parser("selftest")
    t.set_defaults(fn=cmd_selftest)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
