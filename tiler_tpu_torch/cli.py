"""Headless CLI of the port.

  python -m tiler_tpu_torch <settings.ini>             full encode
  python -m tiler_tpu_torch encode -i IN -o OUT [...]  encode with flags (a step
                                                       range, resume, exports)
  python -m tiler_tpu_torch decode IN.gtm OUT.y4m      decode to Y4M (or PNGs)
  python -m tiler_tpu_torch info IN.gtm [--full]       header (and stream) dump
  python -m tiler_tpu_torch selftest                   math invariants
  python -m tiler_tpu_torch preview IN.gtm [--video V] HTTP inspector

Settings files are the JAX package's (``EncoderSettings.from_ini``). The
device is ``cuda`` unless ``--device`` names another. On a node of
several cards, ``torchrun --nproc-per-node N -m tiler_tpu_torch encode ...
--mesh auto`` encodes on all of them (one process a card; rank 0 writes).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

SUBCOMMANDS = ("encode", "decode", "info", "selftest", "preview")


def _settings(path, overrides):
    from .config import EncoderSettings

    s = EncoderSettings.from_ini(path) if path else EncoderSettings()
    for k, v in overrides.items():
        if v is not None:
            setattr(s, k, v)
    return s


def _host(v):
    """A state field as a numpy array (the port keeps the large ones as
    tensors on its device); None stays None."""
    import torch

    return v.cpu().numpy() if isinstance(v, torch.Tensor) else v


def _step_range(steps: str, all_steps):
    """"a:b" is a range (open ends default to the first and last step); a
    bare "a" is that one step."""
    a, colon, b = steps.partition(":")
    a = a or all_steps[0]
    b = b or (all_steps[-1] if colon else a)
    return all_steps[all_steps.index(a):all_steps.index(b) + 1]


def cmd_encode(args):
    """The encode (``--steps``: a contiguous range of it; ``--resume``: from a
    checkpoint of either package, with its own settings unless ``-s`` names
    others; ``--mesh auto``: over every rank of a torchrun group), then the
    checkpoint and the exports (rank 0's)."""
    from .pipeline.encoder import STEPS, Encoder, check_settings

    settings = _settings(args.settings, dict(
        input_file_name=args.input,
        output_file_name=args.output,
        palette_count=args.palette_count,
        palette_size=args.palette_size,
        motion_predict_radius=args.radius,
        global_tiling_quality_based_tile_count=args.quality,
        frame_count=args.frames,
    ))
    mesh = "auto" if args.mesh == "auto" else None
    if args.resume:
        enc = Encoder.load_checkpoint(args.resume, device=args.device, mesh=mesh)
        if args.settings:
            check_settings(settings)
            enc.settings = settings
    else:
        enc = Encoder(settings, device=args.device, mesh=mesh)
    if args.steps:
        for name in _step_range(args.steps, STEPS):
            if name == "load":
                enc.load_video()
            else:
                getattr(enc, name)()
    else:
        enc.run_all()
    if args.checkpoint:
        enc.save_checkpoint(args.checkpoint)
    if not enc.writes:
        return 0
    if args.export_y4m or args.export_pngs:
        from .bitstream.gtm import GTMDecoder
        from .io.export import write_pngs, write_y4m

        frames = GTMDecoder(settings.output_file_name).decode_frames()
        if args.export_y4m:
            write_y4m(args.export_y4m, [f[..., :3] for f in frames], enc.state.fps)
        if args.export_pngs:
            write_pngs(args.export_pngs, frames, _host(enc.state.palettes_rgb))
    if args.export_input_y4m:
        from .io.export import write_y4m

        write_y4m(args.export_input_y4m, np.asarray(_host(enc.state.frames_rgb)), enc.state.fps)
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


def cmd_preview(args):
    from .preview import preview_gtm

    srv = preview_gtm(args.input, input_path=args.video, port=args.port, device=args.device)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()
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
    e.add_argument("--device", help="torch device (default: cuda; under --mesh auto "
                   "this rank's card, cuda:LOCAL_RANK)")
    e.add_argument("--mesh", choices=("none", "auto"), default="none",
                   help="auto: shard the corpus over every rank of the process group "
                   "(one process a device, started by torchrun); no-op in one process. "
                   "Another encoder than the meshless one: every cell takes the exact "
                   "float32 top-k, with no top-k kernel and no skip of predicted cells "
                   "(one H100, 1280x720x32, a group of one: reconstruct 4.6 s against "
                   "0.77 s, +1.3 dB PSNR-HVS and +25%% bytes; README)")
    e.add_argument("--steps", help="a contiguous step range, e.g. load:reduce, "
                   "reconstruct:, or one step")
    e.add_argument("--resume", help="resume from a checkpoint file (either package's)")
    e.add_argument("--checkpoint", help="write the encoder state after the run "
                   "(loads in either package's Encoder.load_checkpoint)")
    e.add_argument("--export-y4m", help="the written stream, decoded, as a C444 Y4M")
    e.add_argument("--export-input-y4m", help="the loaded input frames as a C444 Y4M")
    e.add_argument("--export-pngs", help="the decoded frames as <base>_%%04d.png "
                   "and the palettes as <base>.txt")
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
    v = sub.add_parser("preview", help="HTTP inspector over a .gtm "
                       "(the GUI's render pages and PSNR readout)")
    v.add_argument("input")
    v.add_argument("--video", help="source video (enables the input page)")
    v.add_argument("--port", type=int, default=8080)
    v.add_argument("--device", default="cuda", help="torch device that loads the "
                   "video (default: cuda)")
    v.set_defaults(fn=cmd_preview)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
