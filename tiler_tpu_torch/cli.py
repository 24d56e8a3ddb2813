"""Headless CLI of the port.

  python -m tiler_tpu_torch <settings.ini>             full encode
  python -m tiler_tpu_torch encode -i IN -o OUT [...]  encode with flags

Settings files are the JAX package's (``EncoderSettings.from_ini``). The
device is ``cuda`` unless ``--device`` names another.
"""
from __future__ import annotations

import argparse
import sys


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


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) == 1 and not argv[0].startswith("-") and argv[0] != "encode":
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
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
