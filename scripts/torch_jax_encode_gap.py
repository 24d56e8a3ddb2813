#!/usr/bin/env python3
"""The same synthetic clip through tiler_tpu and tiler_tpu_torch on the
CPU, under the same settings: the gap between the two encoders at a size
the tests leave out for time.

    JAX_PLATFORMS=cpu python3 scripts/torch_jax_encode_gap.py \\
        [--frames 8 --height 176 --width 320] [--seed S | --seeds 0-4] \\
        [--set motion_rank_dims=48 ...] [--mesh] [--threads N] [--stages]
    JAX_PLATFORMS=cpu python3 scripts/torch_jax_encode_gap.py --log-sweep

``--seed`` picks the synthetic clip's noise (default 0); ``--seeds A-B``
(or a comma list) runs each seed in turn. Each
``--set field=value`` (repeatable; a list of values separated by
"|" runs one pair of encodes for each) overrides an EncoderSettings field
of both packages; palette_count defaults to 64 here. For each setting it
prints, for both packages, the decoded stream's RGB-PSNR, the encoder's
PSNR-HVS (by tile), the stream's bytes, the final tile count and the
first 16 hex digits of the stream's sha256, then the
port's gap to the JAX package (docs/DETERMINISM.md's gate is 0.1 dB
RGB-PSNR and 2% bytes). On a host whose XLA computes as the port's CPU
path assumes (``tests/test_torch_reconstruct_order.py``'s probes) the
two streams must be one: it exits 1 if any pair of digests differs.
With ``--mesh`` both encode on a mesh of one
device, (1, 1) ("data", "corpus"): the JAX package's mesh branch and the
port's (in a gloo group of one process), the same shard count and so
the same k-means seeding. ``--threads N`` sets torch's CPU threads
(default: up to 8); the port's stream must not depend on it. Imports
both packages, as the tests do.

With ``--stages`` it instead runs the JAX package's encode step by step
and each port stage from the JAX package's state before it (the method
of tests/test_torch_stages.py, at this size), and prints per stage what
agrees: load's correlations and keyframes, predict_motion's vectors
(equal, both at the PSNR clamp, or neither, with the first of those
(frame, tile row, tile column)), whether reduce, prepare_palettes,
dither and reindex write the same arrays, and reconstruct's predicted
flags, winners, vectors and PSNR bits, PSNR-HVS and final tile count, and
how much of phase A the port summed again in XLA's order. It
is a check (ROADMAP C1 and C8's gate): it exits 1 when a line fails. On
a host whose XLA computes as the port's CPU path assumes every line must
be equal: the correlations' bits, every vector, and in reconstruct the
flags, winners, vectors, PSNR bits and total_psnr. Elsewhere the earlier
envelopes: a vector may differ with both windows at the PSNR clamp, the
correlations within 1e-5, and reconstruct C1's gate (winners equal on
>= 99% of the cells both code, PSNR-HVS within 0.01 dB, final tiles
within 1%); reduce, prepare_palettes, dither and reindex must be equal
everywhere.

With ``--log-sweep`` it instead holds ``ops/ordered.log32`` against
XLA's float32 log over every float32 from the smallest normal to
130,050 (the largest 65025 / max(mse, 0.5) that the PSNR takes a log
of), in chunks of 2^24, prints how many differ and exits 1 if any does
(~1.1e9 inputs, a few minutes).
"""
import argparse
import hashlib
import os
import sys
import tempfile

import jax
import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
from bench import synthetic_clip  # noqa: E402
from tiler_tpu.bitstream.gtm import GTMDecoder  # noqa: E402
from tiler_tpu.config import EncoderSettings as JaxSettings  # noqa: E402
from tiler_tpu.parallel import make_mesh  # noqa: E402
from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder  # noqa: E402
from tiler_tpu_torch.config import EncoderSettings  # noqa: E402
from tiler_tpu_torch.models.state import EncodeState  # noqa: E402
from tiler_tpu_torch.parallel.mesh import make_mesh as t_make_mesh  # noqa: E402
from tiler_tpu_torch.pipeline.encoder import Encoder  # noqa: E402


def _value(text: str):
    if text in ("True", "False"):
        return text == "True"
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


def _seeds(text: str) -> list:
    """"0-4" or "0,3,7" -> a list of seeds."""
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def _same(a, b) -> bool:
    return np.array_equal(np.asarray(a), np.asarray(b))


def xla_order_reason():
    """Why the host's XLA does not compute as the port's CPU path assumes,
    or None (tests/test_torch_reconstruct_order.py's probes)."""
    sys.path.insert(0, os.path.join(_ROOT, "tests"))
    from test_torch_reconstruct_order import reconstruct_order_skip_reason

    return reconstruct_order_skip_reason()


def stages(clip, overrides, exact: bool) -> list:
    """Runs and prints the stage lines; returns the names of those that
    fail the gate (``exact``: every line equal)."""
    import copy

    from tiler_tpu_torch.models.convert import state_from_numpy, state_to_numpy
    from tiler_tpu_torch.pipeline import (dither, load, palettes, predict, reconstruct, reduce,
                                          reindex)

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
    port, rec_stats = {}, {}
    for before, step, run in (("load", "predict_motion", predict.predict_motion),
                              ("predict_motion", "reduce", reduce.reduce_tiles),
                              ("reduce", "prepare_palettes", palettes.prepare_palettes),
                              ("prepare_palettes", "dither", dither.dither),
                              ("dither", "reconstruct", reconstruct.reconstruct),
                              ("reconstruct", "reindex", reindex.reindex)):
        st = state_from_numpy(snaps[before], "cpu")
        st = run(st, settings, **({"stats": rec_stats} if step == "reconstruct" else {}))
        port[step] = st
    tag = f"{clip.shape[2]}x{clip.shape[1]}x{clip.shape[0]} {overrides}"
    failed = []
    st = load.load(EncodeState(), clip, 25.0, settings, device="cpu")
    want = snaps["load"]
    corr_eq = _same(st.correlations.view(np.int32), np.asarray(want.correlations).view(np.int32))
    kf_eq = ([(k.start_frame, k.end_frame) for k in st.keyframes]
             == [(k.start_frame, k.end_frame) for k in want.keyframes])
    tiles_eq = _same(st.tiles_canon, want.tiles_canon)
    corr_ok = corr_eq or not exact and np.allclose(st.correlations, want.correlations,
                                                    rtol=1e-5, atol=1e-6)
    if not (corr_ok and kf_eq and tiles_eq):
        failed.append("load")
    print(f"{tag} load: correlations {'equal' if corr_eq else 'DIFFER'}, keyframes "
          f"{'equal' if kf_eq else 'DIFFER'}, tiles {'equal' if tiles_eq else 'DIFFER'}",
          flush=True)
    g, w = port["predict_motion"].tilemap, snaps["predict_motion"].tilemap
    same = (g.pred_x == w.pred_x) & (g.pred_y == w.pred_y)
    clamped = ~same & (g.psnr >= 51.0) & (w.psnr >= 51.0)
    other = np.argwhere(~same & ~clamped)
    if len(other) or exact and not same.all():
        failed.append("predict_motion")
    cols = clip.shape[2] // 8
    print(f"{tag} predict_motion: {same.size} vectors, {int(same.sum())} equal, "
          f"{int(clamped.sum())} differ with both at the PSNR clamp, {len(other)} differ "
          "otherwise (frame, tile row, tile column): "
          + ", ".join(f"({f}, {i // cols}, {i % cols})" for f, i in other[:8]), flush=True)
    st, want = port["reduce"], snaps["reduce"]
    if not (_same(st.corpus_rgb, want.corpus_rgb) and _same(st.tilemap.tile_idx, want.tilemap.tile_idx)):
        failed.append("reduce")
    print(f"{tag} reduce: corpus {'equal' if _same(st.corpus_rgb, want.corpus_rgb) else 'DIFFERS'}"
          f" (T {len(st.corpus_rgb)} against {len(want.corpus_rgb)}), tile_idx "
          f"{'equal' if _same(st.tilemap.tile_idx, want.tilemap.tile_idx) else 'DIFFERS'}",
          flush=True)
    st, want = port["prepare_palettes"], snaps["prepare_palettes"]
    init = np.asarray(st.corpus_pal_initial) == np.asarray(want.corpus_pal_initial)
    if not (init.all() and _same(st.palettes_rgb, want.palettes_rgb)):
        failed.append("prepare_palettes")
    print(f"{tag} prepare_palettes: corpus_pal_initial equal on {init.mean():.2%}, palettes "
          f"{'equal' if _same(st.palettes_rgb, want.palettes_rgb) else 'DIFFER'}", flush=True)
    st, want = port["dither"], snaps["dither"]
    if not _same(st.corpus_pal_pixels, want.corpus_pal_pixels):
        failed.append("dither")
    print(f"{tag} dither: corpus_pal_pixels "
          f"{'equal' if _same(st.corpus_pal_pixels, want.corpus_pal_pixels) else 'DIFFER'}",
          flush=True)
    st, want = port["reconstruct"], snaps["reconstruct"]
    g, w = st.tilemap, want.tilemap
    both = ~g.predicted & ~w.predicted
    agree = (g.tile_idx[both] == w.tile_idx[both]) & (g.pal_idx[both] == w.pal_idx[both])
    vectors = (g.pred_y == w.pred_y) & (g.pred_x == w.pred_x)
    psnr_bits = g.psnr.view(np.int32) == np.asarray(w.psnr).view(np.int32)
    equal = (_same(g.predicted, w.predicted) and _same(g.tile_idx, w.tile_idx)
             and _same(g.pal_idx, w.pal_idx) and vectors.all() and psnr_bits.all()
             and st.total_psnr == want.total_psnr)
    total = f"{st.total_psnr!r} against {want.total_psnr!r}"
    st = reindex.reindex(st, settings)
    tiles, want_tiles = len(st.corpus_pal_pixels), len(snaps["reindex"].corpus_pal_pixels)
    if not (equal if exact else agree.mean() >= 0.99
            and abs(st.total_psnr - want.total_psnr) <= 0.01
            and abs(tiles - want_tiles) <= 0.01 * want_tiles):
        failed.append("reconstruct")
    print(f"{tag} reconstruct: {'equal' if equal else 'DIFFERS'}: predicted flags equal on "
          f"{(g.predicted == w.predicted).mean():.4%}, winners on {agree.mean():.4%} of "
          f"{int(both.sum())} cells, vectors on {vectors.mean():.4%}, PSNR bits on "
          f"{psnr_bits.mean():.4%}; total_psnr {total} dB; final tiles after reindex "
          f"{tiles} against {want_tiles}", flush=True)
    c = {k[len("ordered_"):]: v for k, v in rec_stats.items() if k.startswith("ordered_")}
    print(f"{tag} reconstruct, summed again in XLA's order: {c['topk_keys_resummed']} of "
          f"{c['topk_keys']} top-k keys, {c['topk_rows_replayed']} of {c['topk_rows']} rows' sorts "
          f"replayed, {c['epu_pairs_resummed']} of {c['epu_pairs']} EPU pairs", flush=True)
    st, want = port["reindex"], snaps["reindex"]
    equal = all(_same(getattr(st, f), getattr(want, f))
                for f in ("corpus_pal_pixels", "corpus_use", "corpus_rgb"))
    print(f"{tag} reindex: {'equal' if equal else 'DIFFERS'}", flush=True)
    if not equal:
        failed.append("reindex")
    print(f"{tag} gate ({'every line equal' if exact else 'the envelopes'}): "
          + (f"FAILED ({', '.join(failed)})" if failed else "every line holds"), flush=True)
    return failed


def log_sweep() -> int:
    import jax.numpy as jnp

    from tiler_tpu_torch.ops.ordered import log32

    lo = int(np.float32(2.0 ** -126).view(np.int32))
    hi = int(np.float32(130050.0).view(np.int32))
    log = jax.jit(jnp.log)
    bad = 0
    for start in range(lo, hi + 1, 1 << 24):
        x = np.arange(start, min(start + (1 << 24), hi + 1), dtype=np.int32).view(np.float32)
        with jax.enable_x64(False):
            want = np.asarray(log(x)).view(np.int32)
        bad += int((log32(torch.from_numpy(x)).numpy().view(np.int32) != want).sum())
    print(f"log32 against XLA's log over every float32 in [2^-126, 130050] ({hi - lo + 1} "
          f"inputs): {bad} differ", flush=True)
    return 1 if bad else 0


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--height", type=int, default=176)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--seed", type=int, default=0, help="the synthetic clip's seed")
    p.add_argument("--seeds", default=None, metavar="A-B",
                   help="each seed of a range (or a comma list) in turn, instead of --seed")
    p.add_argument("--set", action="append", default=[], metavar="FIELD=V1|V2")
    p.add_argument("--mesh", action="store_true", help="encode on a (1, 1) mesh")
    p.add_argument("--threads", type=int, default=max(1, min(8, os.cpu_count() or 1)),
                   help="torch CPU threads (default: up to 8)")
    p.add_argument("--stages", action="store_true",
                   help="each port stage from the JAX package's state before it")
    p.add_argument("--log-sweep", action="store_true",
                   help="ops/ordered.log32 against XLA's log over every float32 the PSNR sees")
    args = p.parse_args()
    if args.log_sweep:
        sys.exit(log_sweep())
    if args.mesh:
        torch.distributed.init_process_group("gloo", init_method="tcp://127.0.0.1:0",
                                             world_size=1, rank=0)
    torch.set_num_threads(args.threads)
    seeds = [args.seed] if args.seeds is None else _seeds(args.seeds)
    grid = [{"palette_count": 64}]
    for item in args.set:
        field, _, values = item.partition("=")
        grid = [{**g, field: _value(v)} for g in grid for v in values.split("|")]
    reason = xla_order_reason()
    print("host XLA: " + ("computes as the port's CPU path assumes: every stream and line must "
                          "be equal" if reason is None else f"{reason}; the envelopes apply"),
          flush=True)
    differ = []
    for seed in seeds:
        clip = synthetic_clip(args.frames, args.height, args.width, seed=seed)
        if args.stages:
            differ += [f for overrides in grid for f in stages(clip, overrides, reason is None)]
            continue
        with tempfile.TemporaryDirectory() as d:
            for overrides in grid:
                got = {name: encode(name, clip, overrides, os.path.join(d, f"{name}.gtm"),
                                    args.mesh) for name in ("jax", "torch")}
                (jr, jh, jb, jt, jd), (tr, th, tb, tt, td) = got["jax"], got["torch"]
                if jd != td:
                    differ.append(seed)
                print(f"{args.width}x{args.height}x{args.frames} seed {seed} {overrides}"
                      + (" on a (1, 1) mesh" if args.mesh else "") + ": "
                      f"jax RGB-PSNR {jr:.4f} dB, PSNR-HVS {jh:.4f} dB, {jb} bytes, {jt} tiles, "
                      f"sha256 {jd}; torch {tr:.4f} dB, {th:.4f} dB, {tb} bytes, {tt} tiles, "
                      f"sha256 {td}; {'one stream' if jd == td else 'TWO STREAMS'}; "
                      f"gap RGB-PSNR {tr - jr:+.4f} dB, PSNR-HVS {th - jh:+.4f} dB, "
                      f"bytes {(tb - jb) / jb:+.3%}", flush=True)
    if args.stages:
        sys.exit(1 if differ else 0)
    sys.exit(1 if differ and reason is None else 0)


if __name__ == "__main__":
    main()
