#!/usr/bin/env python3
"""Smoke run of tiler_tpu_torch on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit); fails without one.
2. Builds the CUDA kernels from tiler_tpu_torch/csrc.
3. Holds each kernel against its plain PyTorch version on the card at
   the shapes of one launch on the main paths (the encode below: corpus
   T = 116,097 tiles, P=1024, S=16, k=64, cells in rows of 8,192), and
   times both (and the one PyTorch call that computes the same function,
   where there is one):
   - tk_select: the whole corpus in one launch, bit-identical, on random
     tiles and on adversarial ones at the same size (worst-case error
     growth, duplicate colors, equal lumas, one or no valid slot), on the
     wide instantiation (S = 17, 32) and S = 1, and its two fp32
     truncations against the integer divisions over their whole ranges;
     prints ptxas's registers and spill, the table's bound and the
     issue-rate floors at the SM clock nvidia-smi reports;
   - knn_bucket_top2 (B2) and knn_bucket_top2_v1: 8,192 cells x the
     corpus, keys within 2^-12 relative (f32 sums in another order) and
     >= 95% identical, plus the recall of the merged top-64 against an
     exact f32 brute force (>= 0.95); each prints its share of its bound,
     and the library's SASS must hold tensor-core MMAs (HGMMA, read with
     cuobjdump where the toolkit has it);
   - blockify_field: the 720p, radius-32 window field (98 x 168 blocks of
     64 x K bf16), bit-identical at every depth the motion ranking reaches,
     K = 3 r^2 = 192, 147, 108, 75, 48, 27, 12, 3, each timed beside its
     plain version, permute+contiguous and its byte bound (the kernels
     line: K = 192, and every depth under "shapes").
4. Encodes a 1280x720x32 synthetic clip (utils/clips.synthetic_clip)
   through Encoder(settings, device="cuda").run_all on two paths, each
   with every kernel's launch count set to 0 just before and read just
   after: the reference defaults (tk_select and B2 must run), and
   motion_field="im2row" with knn_backend="pallas_v1" (blockify_field,
   knn_bucket_top2_v1 and tk_select must run). On each the corpus must
   reach the top-k kernels' gate (T >= 65,536) and the stream must decode
   to 32 frames whose first frame re-renders exactly from the encoder
   state. A third path, dithering_use_thomas_knoll=False (Yliluoma2, plain
   tensor passes), must launch tk_select 0 times and B2 57 times. The first
   two encodes must see T = 116,097 and launch the kernels as
   many times as before (default: tk_select 1, B2 57; im2row_v1:
   tk_select 1, v1 57, blockify 32), and land within 0.1 dB PSNR-HVS and
   2% bytes of the encodes measured with the earlier FMA top-k kernels
   (REF_ENCODES). Each encode then runs once more for times without start-up
   costs, and must write a stream of the same size; the default's second
   stream must have the first's sha256 (determinism: else the first stage
   whose state differs, array by array, is reported). One more encode,
   knn_backend="pallas_v1" with the passes field, isolates the field: the
   im2row path must land within 0.1 dB PSNR-HVS and 2% bytes of it, and
   no more than 0.1 dB below the default path (v1 and B2 rank
   differently, so the streams differ).
   Three more paths of the same clip: research_int16
   (phase_b_motion="research", int16_features=True: tk_select and B2 must
   run, phase B must re-search every frame but the keyframes' first, T
   must clear the gate but may differ from 116,097, and the second
   encode's stages print beside the default's); host_stream
   (hbm_frames_budget below the clip's ~177 MB: frames and tiles must stay
   numpy arrays on the host, T = 116,097, within 0.1 dB PSNR-HVS and 2%
   bytes of the default, prints whether the stream is the default's, and
   the peak of allocated device memory must be below the default's); and
   spill (host_ram_budget below the clip too, one encode: the tiles must
   be a disk memmap, a checkpoint must write their sidecar .npy, and the
   encoder resumed from it must save the same stream).
5. Runs both top-k kernels and their plain versions on the encode's own
   corpus and cells: each kernel's recall of the exact top-64 must equal
   its plain version's within 0.005.
6. Encodes a small clip on the card and on the CPU (plain versions), with
   both ditherers and with research, with and without int16: RGB-PSNR
   within 0.1 dB and
   bytes within 2%; the
   Yliluoma2 dither of one state on the card and on the CPU is
   bit-identical.
7. Writes a planar 4:2:0 y4m of a CIF clip and encodes it through
   Encoder.load_video on the card: at scaling=1 the ingested frames are
   bit-identical to the host's y4m ingest; at scaling=2 they have the
   doubled size and reach 40 dB PSNR against the host's PIL Lanczos.
8. Wide palettes and the other palette and dither settings, each path at
   1280x720 (cut in length only) with the launch counts set to 0 just
   before its encode and read just after:
   - wide256: 16 palettes of 256 colors (a console's 256-color tile mode
     with extended palettes), 8 frames: the corpus stays below the top-k
     gate (the exact top-k runs), tk_select_wide must launch once; the
     stream must read back through the port's GTMReader as 16 palettes
     of 256 colors, every frame decoded;
   - wide64: palettes of 64 colors, 32 frames: tk_select_wide once and
     B2 57 times (T = 116,097, over the gate);
   - plain_tk: use_pallas_tk=False, 32 frames, one encode: no tk_select
     launch, and the default path's stream to the byte;
   - mediancut_wavelets: color_quantizer="mediancut" with
     dithering_mode="wavelets", 32 frames, one encode: PSNR-HVS and
     bytes against the default, printed (another encoder: no gate).
   Each prints T, the stages (of a second encode where there is one), the
   peak of allocated device memory and the 2-opt's inner iterations a
   round.
9. The EPU's two table settings, with the launch counts as in 8:
   - wide256_two_stage: wide256 with epu_two_stage=True (int8/int16
     stage-1 tables, the top 16 pairs re-ranked exactly), two encodes:
     tk_select_wide once, the stream read back as wide256's; prints T,
     the stages and the peak beside wide256's, and PSNR-HVS and bytes
     against it (another encoder: no gate);
   - wide256_fused: wide256 with epu_fused_fp=True (one byte-row table,
     one gather), one encode: saved under wide256's settings text (the
     stream embeds its settings), the state must write wide256's stream
     to the byte; prints reconstruct and the peak beside wide256's;
   - fused_fp: the defaults with epu_fused_fp=True, 32 frames, one
     encode: tk_select once and B2 57 times, and the default path's
     stream to the byte in the same way.
   Then tk_select_wide is held bit-identical to its plain version at
   S = 33, 48, 64, 128, 200, 256 on random, adversarial and slot-edge
   tiles (invalid slots below the first valid one, no valid color, a
   single valid slot at S - 1, partly padded groups of 16 rows), and at
   each wide path's launch (wide256's T, P = 16, S = 256 and wide64's T,
   P = 1,024, S = 64), where both are timed on palettes with every slot
   valid (the encoder's palettes are nearly full) beside the bound over
   the colors the function needs; the kernels line gives the wide256
   figures and, under "shapes", each path's.
10. The last motion and corpus-search settings, 1280x720x32, the launch
   counts as in 8:
   - ivf: knn_backend="ivf" (the corpus k-means into blocks, each row of
     8,192 cells probing 8 blocks), one encode: T = 116,097 with the IVF
     engaged, no top-k kernel launch, tk_select once; the share of probes
     the capacity dropped under 1% and PSNR-HVS within 1.0 dB of the
     default (tests/test_ivf.py's bound); prints the blocks, the share,
     the stages beside the default's and the gaps to it;
   - rank48: motion_rank_dims=48 with the passes field, one encode: B2
     (as many times as the corpus and the cells it leaves need; the
     motion that ranks on 48 dims moves both), tk_select once, no
     blockify;
   - rank27_im2row: motion_field="im2row", motion_rank_dims=27, one
     encode: blockify_field 32 times, every one at K = 27; prints the
     gaps to the default and to im2row_v1 (other encoders: no gate beyond
     the decode's).
   Then the small clip on the card and the CPU (point 6) under
   knn_backend="ivf" with ivf_min_corpus=1, under motion_rank_dims=48
   with phase_b_motion="research", and under motion_field="im2row" with
   motion_rank_dims=12.
11. The multi-device encode (parallel/), 1280x720x32 at the reference
   defaults:
   - mesh_nccl1: an NCCL group of one rank, mesh (1, 1) ("data",
     "corpus"), two encodes: the corpus-sharded k-means and the exact
     sharded top-k of every cell (no B2, no compaction), tk_select once,
     B2 never, T = 116,097; the stream decodes to 32 frames and lands
     within 0.1 dB PSNR-HVS and 2% bytes of this path's own figure
     (REF_ENCODES); phase A's top-64 of frames 0 and 16, from a third
     encoder on the mesh stopped after the dither, must be the exact
     float64 top-64 of the same cells but at near-ties (mesh_picks); its
     stages and peak print beside the default's, and its PSNR-HVS and
     bytes against the meshless default, another encoder (every cell
     ranked on float32 distances, the k-means ranked in float32 and
     seeded over another length); then the sharded top-k of one frame's
     cells is timed in its two parts (the float32 distances, the stable
     ranking);
   - mesh_gloo4: four gloo ranks on the one card (spawned after the
     kernels are built; NCCL refuses two ranks on one card, so the
     collectives stage through host memory), mesh (2, 2): every rank
     holds its phase-A picks as mesh_nccl1 does (the corpus in two
     shards, the second padded), every rank's final state must hash the
     same, each launches tk_select once and B2 never, rank 0's stream
     decodes to 32 frames within 0.1 dB PSNR-HVS and 2% bytes of
     mesh_nccl1.
   The kernels line gives each kernel's launches on both under
   "mesh_launches".
12. The palettization's fixed-order arithmetic (ops/ordered.py) on the
   card against the CPU, bit for bit: the ordered corpus features of
   116,097 random tiles (the default mode and wavelets, timed) and the
   k-means segment sums (ordered).
13. The motion search's float order (motion_order): the default search
   on frames 1 and 0 of the 720p clip on the card, twice, bit-identical;
   prints how many vectors differ from the port's CPU search of the pair
   (the JAX package's CPU float order; no limit on the card, which keeps
   cuBLAS's bf16 product), the card's search time, and its field in
   plain float32 beside the field in XLA's order.
14. Reconstruct's float order (reconstruct_order): the ordered per-cell
   code (the cell and corpus features of a 720p frame, their exact
   errors, prng.gumbel) on the card against the CPU, bit for bit, each
   timed; then a band of frames 0-1 of the 720p clip (its top 16 tile
   rows at full width, the moving square's) through the dither on the
   card, reconstructed on the card and on the CPU from that state: prints
   how many of frame 1's EPU winners and phase-B flags the card's own
   arithmetic moves off the CPU's XLA order (no limit).
15. One more default encode with TILER_TPU_PROFILE set (profile): a
   Chrome trace per step from torch.profiler; the dither trace must name
   tk_select's kernel and the reconstruct trace B2's, each as many times
   as its wrapper counted, and the stream must be the default's; prints
   each step's kernel time from its trace beside Encoder.timings.
16. cluster/kmodes.py on the card against the CPU on a seeded [50,000 x
   64] uint8 set of 16 values, k = 64, max_iter = 10: the same modes,
   labels and iteration count; both times print (kmodes).

Prints per-stage times, then a JSON line of the kernels, the card line,
and last {"ok": true, "device": {...}}. Exits nonzero on any failure.
Takes about six and a half minutes on one H100, the kernels' build included.
"""
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
STREAM_DIR = os.path.join(ROOT, "build", "chip_smoke")
# published H100 SXM peaks (the card's data sheet): the least time of a
# kernel is the larger of its bytes over HBM_BPS and its operations over
# the peak of their type
HBM_BPS = 3.35e12
BF16_OPS = 989e12  # dense tensor cores
FP32_OPS = 67e12  # outside the tensor cores; the table has no int32 rate,
# so tk_select's integer operations are counted against this one too
# one launch on the main paths: the encode's corpus (every run so far
# measured T = 116,097 on this clip) and a row of reconstruct's cells
CORPUS_T = 116097
CELL_ROW = 8192
# the two 720p x 32 encodes of this script as measured on one NVIDIA H100
# 80GB HBM3 (700 W), with the palettization's features and segment sums
# in the fixed order of ops/ordered.py (PERF.md section 6): (PSNR-HVS dB,
# stream bytes). A redesigned kernel ranks on the same keys up to f32
# summation order, so the encodes must stay within docs/DETERMINISM.md's
# 0.1 dB and 2% bytes. mesh_nccl1: the mesh branch's encode (float32
# rankings of every cell, the float32 k-means) on the same card; a change
# to the path must keep it within the same band.
REF_ENCODES = {"default": (23.8951, 2266737), "im2row_v1": (24.2291, 2324547),
               "mesh_nccl1": (25.2430, 2835256)}
# launches of each path's kernels in one such encode: 460,800 cells in
# rows of 8,192, one dither, one motion search per frame
EXPECT_LAUNCHES = {"default": {"tk_select": 1, "knn_bucket_top2": 57},
                   "im2row_v1": {"tk_select": 1, "knn_bucket_top2_v1": 57,
                                 "blockify_field": 32},
                   "yliluoma2": {"tk_select": 0, "knn_bucket_top2": 57},
                   "research_int16": {"tk_select": 1},
                   "host_stream": {"tk_select": 1, "knn_bucket_top2": 57},
                   "spill": {"tk_select": 1, "knn_bucket_top2": 57},
                   "wide256": {"tk_select": 0, "tk_select_wide": 1, "knn_bucket_top2": 0},
                   "wide64": {"tk_select": 0, "tk_select_wide": 1, "knn_bucket_top2": 57},
                   "plain_tk": {"tk_select": 0, "tk_select_wide": 0, "knn_bucket_top2": 57},
                   "mediancut_wavelets": {"tk_select": 1, "knn_bucket_top2": 57},
                   "wide256_two_stage": {"tk_select": 0, "tk_select_wide": 1,
                                         "knn_bucket_top2": 0},
                   "wide256_fused": {"tk_select": 0, "tk_select_wide": 1, "knn_bucket_top2": 0},
                   "fused_fp": {"tk_select": 1, "tk_select_wide": 0, "knn_bucket_top2": 57},
                   "ivf": {"tk_select": 1, "knn_bucket_top2": 0, "knn_bucket_top2_v1": 0},
                   # the rank paths' motion moves the corpus and the cells
                   # that skip the top-k (the reference's -0.7 dB at 48), so
                   # B2's count is the data's: it must only run
                   "rank48": {"tk_select": 1, "blockify_field": 0},
                   "rank27_im2row": {"tk_select": 1, "blockify_field": 32},
                   # the mesh branch: the exact sharded top-k for every cell
                   "mesh_nccl1": {"tk_select": 1, "knn_bucket_top2": 0,
                                  "knn_bucket_top2_v1": 0, "blockify_field": 0}}
# the wide kernel's palette sizes held against its plain version
WIDE_S = (33, 48, 64, 128, 200, 256)
# the blockify kernel's depths: the motion ranking's 3 r^2, r = 8..1
BLOCKIFY_K = (192, 147, 108, 75, 48, 27, 12, 3)
# the clip's device bytes at 1280x720x32 (frames and canonical tiles, ~177
# MB): the host paths set their budgets below it
CLIP_BYTES = 32 * 720 * 1280 * 3 + 32 * 90 * 160 * 192
HOST_BUDGET = 1e8
# tk_select's scan, per (pixel, step, color), in csrc/tk_dither.cu's design:
# 10.5 issue slots (an SM issues 128 thread instructions a clock), of which
# 3.5 instructions give an int32 result (64 a clock an SM)
TK_ISSUE_SLOTS = 10.5
TK_INT32_RESULTS = 3.5
SM_COUNT = 132


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, queued: bool = False) -> float:
    """Mean milliseconds of fn() on the card over reps runs (after one
    warm-up run), by CUDA events. ``queued``: the card first sleeps while
    the host enqueues all the runs, so that a kernel shorter than its
    launch from Python is timed on the device alone."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)  # ~10 ms of the SM clock: the enqueue fits
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sass_tensor_core_mmas(so) -> int:
    """HGMMA instructions in the kernel library's SASS (-1: no cuobjdump)."""
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return -1
    res = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                         timeout=300, check=True)
    return sum("HGMMA" in line for line in res.stdout.splitlines())


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float):
    """(least milliseconds, "bytes" or "operations")."""
    tb, to = n_bytes / HBM_BPS, n_ops / peak_ops
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def sm_clock_hz() -> float:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return 1e6 * float(res.stdout.strip().splitlines()[0])


def _tk_same(torch, tk, args, what):
    got = tk.tk_select(*args)
    want = tk.tk_select_plain(*args)
    torch.cuda.synchronize()
    bad = int((got != want).sum())
    if bad:
        raise AssertionError(f"tk_select differs from its plain version on {what} "
                             f"({bad} pixels)")
    return int((got.int() - want.int()).abs().max())


def _tk_random(torch, dev, T, P, S, seed, valid=0.9):
    """Random tiles, mirrors, palette indexes and a palette table (a
    share ``valid`` of the slots valid) on ``dev``."""
    from tiler_tpu_torch.kernels import tk_dither as tk

    rng = np.random.default_rng(seed)
    pix = torch.as_tensor(rng.integers(0, 256, (T, 64, 3), dtype=np.uint8), device=dev)
    mirror = torch.as_tensor(rng.integers(0, 4, T, dtype=np.uint8), device=dev)
    pidx = torch.as_tensor(rng.integers(0, P, T, dtype=np.int32), device=dev)
    pal = torch.as_tensor(rng.integers(0, 256, (P, S, 3), dtype=np.int32), device=dev)
    valid = torch.as_tensor(rng.random((P, S)) < valid, device=dev)
    return pix, mirror, pidx, tk.pal_table(pal, valid)


def _tk_bound(tk, pix, mirror, pidx, table):
    """tk_select's least time: bytes (each input once, the palette table
    whole, the slots out) or ~14 integer operations per (pixel, step,
    candidate color) at the fp32 rate, whichever is larger. The candidate
    colors are those the function needs: each tile's palette's valid
    slots (at least one: a palette without one gives slot 0)."""
    T = pix.shape[0]
    n_bytes = pix.numel() + mirror.numel() + 4 * pidx.numel() + 4 * table.numel() + T * 64
    colors = float((table[:, :, 4] > 0).sum(dim=1).clamp_min(1)[pidx.long()].sum())
    triples = colors * 64 * tk.STEPS
    return bound_ms(n_bytes, 14.0 * triples, FP32_OPS) + (triples,)


def check_tk(torch, dev, T=CORPUS_T, P=1024, S=16):
    from tiler_tpu_torch.kernels import _build
    from tiler_tpu_torch.kernels import tk_dither as tk

    pix, mirror, pidx, table = _tk_random(torch, dev, T, P, S, 1)
    err = _tk_same(torch, tk, (pix, mirror, pidx, table), "random tiles")
    # timed on palettes with every slot valid, as the encoder's nearly are
    table = _tk_random(torch, dev, 1, P, S, 1, valid=1.0)[3]
    err = max(err, _tk_same(torch, tk, (pix, mirror, pidx, table),
                            "random tiles, full palettes"))
    # the adversarial tiles at the launch's size, then the wide
    # instantiation and a one-color palette at a smaller one
    for s_adv, reps in ((S, -(-T // 40)), (17, 50), (32, 50), (1, 50)):
        case = tk.adversarial_case(s_adv, seed=s_adv, reps=reps)
        args = [torch.as_tensor(a, device=dev) for a in case[:3]]
        args.append(tk.pal_table(torch.as_tensor(case[3], device=dev),
                                 torch.as_tensor(case[4], device=dev)))
        _tk_same(torch, tk, args, f"the adversarial tiles, S={s_adv}")
        print(f"tk_select: {len(case[0])} adversarial tiles S={s_adv}: bit-identical",
              flush=True)
    # the two truncations the kernel does in fp32, over their whole ranges
    lo, count = -2_100_000, 4_200_001
    n = torch.arange(lo, lo + count, device=dev)
    if not torch.equal(tk.trunc_probe(lo, count, 0, dev).long(),
                       torch.div(n.abs(), 1000, rounding_mode="floor")):
        raise AssertionError("tk_select's floor(|n| / 1000) is not the integer division")
    lo, count = -20_000, 40_001
    n = torch.arange(lo, lo + count, device=dev)
    if not torch.equal(tk.trunc_probe(lo, count, 1, dev).long(),
                       torch.div(n * 9, 100, rounding_mode="trunc")):
        raise AssertionError("tk_select's trunc(n * 9 / 100) is not the integer division")
    ms = cuda_ms(lambda: tk.tk_select(pix, mirror, pidx, table), 20)
    clock = sm_clock_hz()  # read while the card is still clocked up
    plain_ms = cuda_ms(lambda: tk.tk_select_plain(pix, mirror, pidx, table), 3)
    bms, by, triples = _tk_bound(tk, pix, mirror, pidx, table)
    issue_ms = 1e3 * TK_ISSUE_SLOTS * triples / (128 * SM_COUNT * clock)
    int32_ms = 1e3 * TK_INT32_RESULTS * triples / (64 * SM_COUNT * clock)
    used = [r for r in _build.kernel_resources("tk_select_kernel") if "Li16E" in r["function"]]
    res = used[0] if used else None
    print(f"tk_select: {T} tiles P={P} S={S}: bit-identical; kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}); at the SM clock "
          f"{clock / 1e6:.0f} MHz the scan's {TK_ISSUE_SLOTS} issue slots a triple take "
          f"{issue_ms:.3f} ms and its {TK_INT32_RESULTS} int32 results {int32_ms:.3f} ms; "
          + (f"ptxas: {res['registers']} registers, {res['spill_store_bytes']} / "
             f"{res['spill_load_bytes']} bytes of spill stores / loads, "
             f"{res['stack_bytes']} bytes of stack" if res else "ptxas: not built here"),
          flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": None, "issue_floor_ms": issue_ms,
            "int32_floor_ms": int32_ms, "sm_clock_mhz": clock / 1e6,
            "registers": res and res["registers"],
            "spill_bytes": res and res["spill_store_bytes"] + res["spill_load_bytes"]}


def check_tk_wide(torch, dev, launches):
    """tk_select_wide (S = 33..256) against its plain version: bit-
    identical at every S of WIDE_S on 1,001 random tiles (a partly empty
    last block), on the adversarial ones and on those of slot_edge_case
    (invalid slots below the first valid one, no valid color, a single
    valid slot at S - 1, partly padded groups of 16 rows), then at each
    wide path's launch, ``launches`` {path: (T, P, S)}, and timed there on
    palettes with every slot valid. Returns the first path's figures, with every path's under "shapes"."""
    from tiler_tpu_torch.kernels import _build
    from tiler_tpu_torch.kernels import tk_dither as tk

    for s in WIDE_S:
        _tk_same(torch, tk, _tk_random(torch, dev, 1001, 7, s, s), f"random tiles, S={s}")
        for gen, case in (("adversarial", tk.adversarial_case(s, seed=s, reps=10)),
                          ("slot-edge", tk.slot_edge_case(s, seed=s, reps=10))):
            args = [torch.as_tensor(a, device=dev) for a in case[:3]]
            args.append(tk.pal_table(torch.as_tensor(case[3], device=dev),
                                     torch.as_tensor(case[4], device=dev)))
            _tk_same(torch, tk, args, f"the {gen} tiles, S={s}")
        print(f"tk_select_wide: 1001 random, adversarial and slot-edge tiles S={s}: "
              "bit-identical", flush=True)
    used = _build.kernel_resources("tk_select_wide_kernel")
    res = used[0] if used else None
    shapes = []
    for path, (T, P, S) in launches.items():
        pix, mirror, pidx, table = _tk_random(torch, dev, T, P, S, 5)
        err = _tk_same(torch, tk, (pix, mirror, pidx, table), f"random tiles, S={S}")
        # timed on palettes with every slot valid, as the encoder's nearly
        # are: the scan runs over the valid rows only
        table = _tk_random(torch, dev, 1, P, S, 5, valid=1.0)[3]
        err = max(err, _tk_same(torch, tk, (pix, mirror, pidx, table),
                                f"random tiles, full palettes, S={S}"))
        ms = cuda_ms(lambda: tk.tk_select_wide(pix, mirror, pidx, table), 5)
        plain_ms = cuda_ms(lambda: tk.tk_select_plain(pix, mirror, pidx, table), 1)
        bms, by, _ = _tk_bound(tk, pix, mirror, pidx, table)
        print(f"tk_select_wide at {path}'s launch, {T} tiles P={P} S={S}: bit-identical; "
              f"on full palettes kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bms:.4f} ms ({by}), {bms / ms:.1%} of the bound; "
              + (f"ptxas: {res['registers']} registers, {res['spill_store_bytes']} / "
                 f"{res['spill_load_bytes']} bytes of spill stores / loads, "
                 f"{res['stack_bytes']} bytes of stack" if res else "ptxas: not built here"),
              flush=True)
        shapes.append({"path": path, "T": T, "P": P, "S": S, "max_abs_err": err, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by})
        del pix, mirror, pidx, table
        torch.cuda.empty_cache()
    return {**{k: shapes[0][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by")},
            "library_ms": None, "registers": res and res["registers"],
            "spill_bytes": res and res["spill_store_bytes"] + res["spill_load_bytes"],
            "shapes": shapes}


def read_back(palettes: int, size: int):
    """encode_path's after-hook of the wide paths: the stream, read by the
    port's own GTMReader, says ``palettes`` palettes of ``size`` colors
    and holds every frame (encode_path decodes them all)."""
    from tiler_tpu_torch.bitstream.gtm import GTMReader

    def check(enc, stream):
        g = GTMReader.read(stream)
        got = (g.palette_size, len(g.palettes_rgb), len(g.frames))
        if got != (size, palettes, enc.state.n_frames):
            raise AssertionError(f"the stream reads back as (palette_size, palettes, frames) "
                                 f"{got}, not {(size, palettes, enc.state.n_frames)}")
        print(f"read back with GTMReader: {palettes} palettes of {size} colors, "
              f"{len(g.frames)} frames, {g.tile_count} tiles, largest slot "
              f"{int(g.tiles_pal.max())}", flush=True)
        return {"read_back": {"palette_size": g.palette_size, "palettes": len(g.palettes_rgb),
                              "frames": len(g.frames), "tiles": g.tile_count}}

    return check


def _key_agreement(torch, pairs, N, decode):
    """Max abs and relative error of the decoded keys, and the smallest
    share of identical keys, over the (kernel, plain) key pairs."""
    max_err, rel, same = 0.0, 0.0, []
    for a, b in pairs:
        da, db = decode(a[:, :N]).double(), decode(b[:, :N]).double()
        max_err = max(max_err, float((da - db).abs().max()))
        rel = max(rel, float(((da - db).abs() / db.abs().clamp_min(1e-30)).max()))
        same.append(float((a[:, :N] == b[:, :N]).float().mean()))
    return max_err, rel, min(same)


def _recall(torch, idx, feats, ds, k):
    """Share of the exact f32 brute-force top-k that idx [N, k] holds."""
    hits = []
    d2 = (ds * ds).sum(1)
    for c0 in range(0, feats.shape[0], 2048):
        f = feats[c0:c0 + 2048]
        dist = (f * f).sum(1, keepdim=True) - 2 * f @ ds.T + d2  # exact f32
        want = torch.sort(dist, dim=1, stable=True).indices[:, :k]
        hit = (idx[c0:c0 + 2048, :, None].long() == want[:, None, :]).any(-1)
        hits.append(hit.float().sum(1))
    return float(torch.cat(hits).mean()) / k


def _knn_inputs(torch, dev, N, T):
    gen = torch.Generator(device=dev).manual_seed(2)
    feats = torch.randn(N, 192, device=dev, generator=gen) * 50
    ds = torch.randn(T, 192, device=dev, generator=gen) * 50
    return feats, ds


def _knn_bound(N, T, depth, nb):
    """The distances of N cells to T tiles: 2 * 192 operations per pair
    on bf16 inputs; bytes: both bf16 operands, the f32 norms, two int32
    keys per cell and bucket out."""
    n_bytes = 2 * depth * (N + T) + 4 * T + 2 * 4 * nb * N
    return bound_ms(n_bytes, 2.0 * N * T * 192, BF16_OPS)


def check_knn(torch, dev, N=CELL_ROW, T=CORPUS_T, k=64):
    from tiler_tpu_torch.kernels import knn_topk as kn

    Tp = -(-T // kn.TP_ALIGN) * kn.TP_ALIGN
    feats, ds = _knn_inputs(torch, dev, N, T)
    dsTa = kn.knn_prep2(ds, Tp)
    fa = kn.fold_cells(feats, -(-N // kn.CELL_BLOCK) * kn.CELL_BLOCK)
    k1, k2 = kn.knn_bucket_top2(fa, dsTa)
    p1, p2 = kn.knn_bucket_top2_plain(fa, dsTa)
    torch.cuda.synchronize()
    max_err, rel, same = _key_agreement(
        torch, ((k1, p1), (k2, p2)), N, lambda key: (key & ~0x1FF).view(torch.float32))
    if rel > 2.0 ** -12 or same < 0.95:
        raise AssertionError(f"knn_bucket_top2 vs plain: rel {rel:.3g}, same keys {same}")
    idx, _ = kn.knn_bucket_topk2(feats, dsTa, k)
    recall = _recall(torch, idx, feats, ds, k)
    if recall < 0.95:
        raise AssertionError(f"knn top-{k} recall {recall:.4f} vs f32 brute force")
    ms = cuda_ms(lambda: kn.knn_bucket_top2(fa, dsTa), 5)
    plain_ms = cuda_ms(lambda: kn.knn_bucket_top2_plain(fa, dsTa), 2)
    # context only (no one PyTorch call computes the bucket top-2): the
    # cuBLAS bf16 product of the same folded operands, output bf16
    gemm_ms = cuda_ms(lambda: fa @ dsTa, 5)
    bms, by = _knn_bound(N, T, kn.KDA, Tp // kn.TB)
    print(f"knn_bucket_top2: {N} cells x {T} tiles k={k}: keys rel err {rel:.3g}, "
          f"same keys {same:.4f}, recall vs f32 brute force {recall:.4f}; "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), "
          f"{bms / ms:.1%} of the bound; context: cuBLAS bf16 GEMM of the same operands "
          f"{gemm_ms:.3f} ms", flush=True)
    return {"max_abs_err": max_err, "max_rel_err": rel, "recall": recall,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "gemm_ms": gemm_ms}


def check_knn_v1(torch, dev, N=CELL_ROW, T=CORPUS_T, k=64):
    from tiler_tpu_torch.kernels import knn_topk as kn

    Tp = -(-T // kn.TP_ALIGN) * kn.TP_ALIGN
    feats, ds = _knn_inputs(torch, dev, N, T)
    dsT, d2 = kn.knn_prep_v1(ds, Tp)
    fb = torch.nn.functional.pad(feats.to(torch.bfloat16),
                                 (0, 0, 0, -(-N // kn.CELL_BLOCK) * kn.CELL_BLOCK - N))
    k1, k2 = kn.knn_bucket_top2_v1(fb, dsT, d2)
    p1, p2 = kn.knn_bucket_top2_v1_plain(fb, dsT, d2)
    torch.cuda.synchronize()
    max_err, rel, same = _key_agreement(
        torch, ((k1, p1), (k2, p2)), N,
        lambda key: kn.sortable(key & ~0x1FF).view(torch.float32))
    if rel > 2.0 ** -12 or same < 0.95:
        raise AssertionError(f"knn_bucket_top2_v1 vs plain: rel {rel:.3g}, same keys {same}")
    idx, _ = kn.knn_bucket_topk(feats, dsT, d2, k)
    recall = _recall(torch, idx, feats, ds, k)
    if recall < 0.95:
        raise AssertionError(f"knn v1 top-{k} recall {recall:.4f} vs f32 brute force")
    ms = cuda_ms(lambda: kn.knn_bucket_top2_v1(fb, dsT, d2), 5)
    plain_ms = cuda_ms(lambda: kn.knn_bucket_top2_v1_plain(fb, dsT, d2), 2)
    gemm_ms = cuda_ms(lambda: fb @ dsT, 5)  # context only, as for B2
    bms, by = _knn_bound(N, T, kn.KD, Tp // kn.TB)
    print(f"knn_bucket_top2_v1: {N} cells x {T} tiles k={k}: keys rel err {rel:.3g}, "
          f"same keys {same:.4f}, recall vs f32 brute force {recall:.4f}; "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), "
          f"{bms / ms:.1%} of the bound; context: cuBLAS bf16 GEMM of the same operands "
          f"{gemm_ms:.3f} ms", flush=True)
    return {"max_abs_err": max_err, "max_rel_err": rel, "recall": recall,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "gemm_ms": gemm_ms}


def check_blockify(torch, dev, mh=98, mw=168, depths=BLOCKIFY_K):
    """The motion field of a 1280x720 frame at radius 32 (P = 32), at each
    depth K of ``depths``: bit-identical, then timed. Returns the first
    depth's figures, with every depth's under "shapes"."""
    from tiler_tpu_torch.kernels import blockify as bl

    shapes = []
    for K in depths:
        gen = torch.Generator(device=dev).manual_seed(K)
        F = torch.randn(8 * mh, 8 * mw, K, device=dev, generator=gen).to(torch.bfloat16)
        got = bl.blockify_field(F)
        want = bl.blockify_field_plain(F)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            raise AssertionError(f"blockify_field differs from its plain version at K={K}")
        del got, want
        # queued: at small K a run is shorter than its launch from Python
        ms = cuda_ms(lambda: bl.blockify_field(F), 20, queued=True)
        plain_ms = cuda_ms(lambda: bl.blockify_field_plain(F), 20, queued=True)
        library_ms = cuda_ms(
            lambda: F.view(mh, 8, mw, 8, K).permute(0, 2, 1, 3, 4).contiguous(), 20,
            queued=True)
        bms, by = bound_ms(2 * F.numel() * F.element_size(), 0.0, BF16_OPS)
        print(f"blockify_field: [{8 * mh}, {8 * mw}, {K}] bf16: bit-identical; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, permute+contiguous {library_ms:.4f} ms, "
              f"bound {bms:.4f} ms ({by}), {bms / ms:.1%} of the bound", flush=True)
        shapes.append({"K": K, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bms, "bound_by": by, "library_ms": library_ms})
        del F
    return {**{k: v for k, v in shapes[0].items() if k != "K"}, "shapes": shapes}


def encode_path(name, settings, kernels, F=32, H=720, W=1280, min_corpus=65536,
                device="cuda", again=True, after=None, mesh=None, same_stream=False):
    """One encode of the clip through the Encoder on the card (on
    ``mesh`` when given), with every kernel's count set to 0 just before
    and read just after: each of ``kernels`` must have launched. Reads the
    peak of allocated device memory (reset just before). Checks the decode
    and frame 0, calls ``after(encoder, stream)`` (its dict joins the
    result), then (with ``again``) encodes once more for times without
    start-up costs: the stream must have the same size, and with
    ``same_stream`` the same sha256 (else the first stage whose state
    differs is found and reported, first_differing_stage)."""
    import torch

    from tiler_tpu_torch.bitstream.gtm import GTMDecoder
    from tiler_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tiler_tpu_torch.pipeline.encoder import Encoder
    from tiler_tpu_torch.utils.clips import synthetic_clip

    clip = synthetic_clip(F, H, W)
    os.makedirs(STREAM_DIR, exist_ok=True)
    stream = os.path.join(STREAM_DIR, f"{name}.gtm")
    enc = Encoder(settings, device=device, log=lambda *a: print(*a, flush=True), mesh=mesh)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.monotonic()
    enc.run_all(clip, fps=25.0, out_path=stream)
    wall = time.monotonic() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() if cuda else None
    st = enc.state
    T = enc.step_stats["corpus_tiles"]
    print(f"[{name}] encode {W}x{H}x{F}: {wall:.3f} s; stages "
          + " ".join(f"{k}={v:.3f}" for k, v in enc.timings.items()), flush=True)
    inner = enc.step_stats["two_opt_inner"]
    print(f"[{name}] corpus T={T}, cells through a top-k kernel="
          f"{enc.step_stats['knn_kernel_cells']}, launches {counts}, PSNR-HVS "
          f"{st.total_psnr:.4f} dB, {enc.stats.total_bytes} bytes, {len(st.keyframes)} "
          f"keyframes, phase B re-searches {enc.step_stats['phase_b_searches']}, peak "
          f"device memory allocated {peak} bytes, 2-opt inner iterations "
          f"{sum(inner)} in {len(inner)} rounds {inner}", flush=True)
    if T < min_corpus:
        raise AssertionError(f"corpus of {T} tiles is below the knn kernels' gate {min_corpus}")
    for kname in kernels:
        if counts[kname] <= 0:
            raise AssertionError(f"kernel {kname} was not launched by the {name} path")

    frames = np.stack(GTMDecoder(stream).decode_frames())
    if frames.shape != (F, H, W, 4) or len(frames) != F:
        raise AssertionError(f"decoded {frames.shape}, want {(F, H, W, 4)}")
    rgb = frames[..., :3]
    mse = float(np.mean((rgb.astype(np.float64) - clip) ** 2))
    psnr_rgb = 10 * np.log10(255 * 255 / max(mse, 1e-9))
    # frame 0 starts a keyframe: every cell is a tile command, so it
    # re-renders from the state alone
    tm = st.tilemap
    pp = st.corpus_pal_pixels.cpu().numpy()[tm.tile_idx[0]]  # [N, 8, 8]
    pp = np.where(tm.hmirror[0][:, None, None], pp[:, :, ::-1], pp)
    pp = np.where(tm.vmirror[0][:, None, None], pp[:, ::-1, :], pp)
    pal = st.palettes_rgb.cpu().numpy()[tm.pal_idx[0]]  # [N, S, 3]
    tiles = np.take_along_axis(pal, pp.reshape(len(pp), 64, 1), axis=1)
    th, tw = st.tilemap_h, st.tilemap_w
    f0 = tiles.reshape(th, tw, 8, 8, 3).transpose(0, 2, 1, 3, 4).reshape(H, W, 3)
    if tm.predicted[0].any() or not np.array_equal(f0, rgb[0]):
        raise AssertionError("decoded frame 0 differs from the encoder's reconstruction")
    if not np.isfinite(st.total_psnr) or psnr_rgb < 20.0:
        raise AssertionError(f"quality out of range: RGB-PSNR {psnr_rgb:.2f} dB")
    print(f"[{name}] decoded {len(frames)} frames, RGB-PSNR {psnr_rgb:.4f} dB; frame 0 "
          f"matches the encoder state", flush=True)
    out = {"frames": F, "height": H, "width": W, "wall_s": wall,
           "stage_s": enc.timings, "corpus_tiles": T,
           "knn_kernel_cells": enc.step_stats["knn_kernel_cells"],
           "launches": counts, "psnr_hvs_db": st.total_psnr,
           "psnr_rgb_db": psnr_rgb, "bytes": enc.stats.total_bytes,
           "keyframes": len(st.keyframes),
           "phase_b_searches": enc.step_stats["phase_b_searches"], "peak_bytes": peak,
           "two_opt_inner": inner, "ivf_blocks": enc.step_stats["ivf_blocks"],
           "ivf_overflow": enc.step_stats["ivf_overflow"], "stream": open(stream, "rb").read()}
    if after is not None:
        out.update(after(enc, stream))
    if not again:
        return out
    # the same encode again: the first one also paid one-time costs
    # (CUDA context and library start-up, allocator growth, builds)
    again = Encoder(settings, device=device, log=None, mesh=mesh)
    t0 = time.monotonic()
    again.run_all(clip, fps=25.0, out_path=stream)
    wall2 = time.monotonic() - t0
    print(f"[{name}] second encode: {wall2:.3f} s; stages "
          + " ".join(f"{k}={v:.3f}" for k, v in again.timings.items()), flush=True)
    first = hashlib.sha256(out["stream"]).hexdigest()
    with open(stream, "rb") as f:
        second = hashlib.sha256(f.read()).hexdigest()
    sizes = (enc.stats.total_bytes, again.stats.total_bytes)
    print(f"[{name}] the two encodes' streams: {sizes[0]} and {sizes[1]} bytes, sha256 "
          f"{first[:16]} and {second[:16]} ({'equal' if first == second else 'DIFFERENT'})",
          flush=True)
    if sizes[0] != sizes[1] or (same_stream and first != second):
        where = (first_differing_stage(settings, clip, device, mesh) if same_stream
                 else "not looked for")
        raise AssertionError(f"the two {name} encodes wrote different streams ({sizes[0]} and "
                             f"{sizes[1]} bytes, sha256 {first[:16]} and {second[:16]}); "
                             f"the first stage whose state differs: {where}")
    return {**out, "second_wall_s": wall2, "second_stage_s": again.timings,
            "sha256": first, "second_sha256": second}


def first_differing_stage(settings, clip, device, mesh=None):
    """Two more encodes of ``clip`` step by step, each state hashed array
    by array (models/convert.state_array_digests) after the load and after
    every step: the first step after which they differ, with the fields."""
    from tiler_tpu_torch.models.convert import state_array_digests
    from tiler_tpu_torch.pipeline.encoder import STEPS, Encoder

    digests = []
    for _ in range(2):
        enc = Encoder(settings, device=device, log=None, mesh=mesh)
        enc.load_frames(clip, 25.0)
        run = [("load", state_array_digests(enc.state))]
        for step in STEPS[1:-1]:
            getattr(enc, step)()
            run.append((step, state_array_digests(enc.state)))
        digests.append(run)
    for (step, a), (_, b) in zip(*digests):
        fields = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
        if fields:
            return f"{step} ({', '.join(fields)})"
    return "none: the step-by-step encodes agree, the difference is in save"


def check_against_reference(name, run, corpus=CORPUS_T):
    """The encode against REF_ENCODES where it has a figure there (0.1 dB
    PSNR-HVS, 2% bytes), with the corpus size (unless ``corpus`` is None)
    and the launches of EXPECT_LAUNCHES."""
    if name in REF_ENCODES:
        ref_db, ref_bytes = REF_ENCODES[name]
        d_db = run["psnr_hvs_db"] - ref_db
        d_bytes = (run["bytes"] - ref_bytes) / ref_bytes
        print(f"[{name}] against the reference encode ({ref_db} dB, {ref_bytes} bytes): "
              f"PSNR-HVS {d_db:+.4f} dB, bytes {d_bytes:+.4%}", flush=True)
        if abs(d_db) > 0.1 or abs(d_bytes) > 0.02:
            raise AssertionError(f"the {name} encode left the reference's 0.1 dB / 2% "
                                 "envelope")
    if corpus is not None and run["corpus_tiles"] != corpus:
        raise AssertionError(f"the {name} corpus has {run['corpus_tiles']} tiles, "
                             f"not {corpus}")
    for kname, n in EXPECT_LAUNCHES[name].items():
        if run["launches"][kname] != n:
            raise AssertionError(f"{kname} launched {run['launches'][kname]} times on the "
                                 f"{name} path, not {n}")


def host_check(spilled: bool):
    """encode_path's after-hook for the host paths: the frames and tiles
    stayed numpy arrays on the host (the tiles a memmap when spilled). A
    spilled encode also writes a checkpoint, which must put the tiles in
    a sidecar .npy, and the encoder resumed from it must save the same
    stream."""
    from tiler_tpu_torch.pipeline.encoder import Encoder

    def check(enc, stream):
        st = enc.state
        kinds = {k: type(getattr(st, k)).__name__ for k in ("frames_rgb", "tiles_canon")}
        if not all(isinstance(getattr(st, k), np.ndarray) for k in kinds):
            raise AssertionError(f"the host path kept {kinds} in place of numpy arrays")
        if isinstance(st.tiles_canon, np.memmap) != spilled:
            raise AssertionError(f"tiles_canon is a {kinds['tiles_canon']} (spill={spilled})")
        out = {"host_types": kinds}
        if spilled:
            ck = os.path.join(STREAM_DIR, "spill.ckpt")
            enc.save_checkpoint(ck)
            side = ck + ".tiles_canon.npy"
            if not os.path.exists(side):
                raise AssertionError("the spill checkpoint wrote no tiles_canon sidecar")
            resumed = Encoder.load_checkpoint(ck, log=None, device=enc.device)
            if not isinstance(resumed.state.tiles_canon, np.memmap):
                raise AssertionError("the resumed spill state did not map its sidecar")
            again = os.path.join(STREAM_DIR, "spill_resumed.gtm")
            resumed.save(again)
            with open(again, "rb") as a, open(stream, "rb") as b:
                if a.read() != b.read():
                    raise AssertionError("the resumed spill encode saved another stream")
            out["sidecar_bytes"] = os.path.getsize(side)
            os.remove(side)
        print(f"host path: {kinds}" + (f"; checkpoint sidecar {out['sidecar_bytes']} bytes, "
                                       "the resumed save wrote the same stream"
                                       if spilled else ""), flush=True)
        return out

    return check


def check_host_path(name, run, default):
    """A host path against the default encode: the corpus, 0.1 dB
    PSNR-HVS, 2% bytes, and a lower peak of allocated device memory."""
    check_against_reference(name, run)
    d_db = run["psnr_hvs_db"] - default["psnr_hvs_db"]
    d_bytes = (run["bytes"] - default["bytes"]) / default["bytes"]
    same = run["stream"] == default["stream"]
    print(f"[{name}] against the default: PSNR-HVS {d_db:+.6f} dB, bytes {d_bytes:+.4%}, "
          f"stream {'identical' if same else 'different'}; peak device memory allocated "
          f"{run['peak_bytes']} bytes against the default's {default['peak_bytes']}",
          flush=True)
    if abs(d_db) > 0.1 or abs(d_bytes) > 0.02:
        raise AssertionError(f"the {name} encode left the default's 0.1 dB / 2% envelope")
    return {"d_db": d_db, "d_bytes": d_bytes, "identical": same}


def knn_on_encode_data(frames=(0, 16), k=64, F=32, H=720, W=1280, device="cuda"):
    """Both top-k kernels on the encode's own data: the corpus and cells
    of the clip at the reference defaults, up to the dither (the corpus
    reconstruct ranks). Each kernel's recall of the exact float64 top-k
    must equal its plain version's within 0.005; the two kernels' recalls
    and the mean exact distance of the tiles each picks are printed (they
    rank differently: B2 clamps its folded distance at 0, v1 keeps the
    sign)."""
    import torch

    from tiler_tpu_torch.config import EncoderSettings
    from tiler_tpu_torch.kernels import knn_topk as kn
    from tiler_tpu_torch.pipeline import reconstruct as rc
    from tiler_tpu_torch.pipeline.encoder import Encoder
    from tiler_tpu_torch.pipeline.motion import tile_features_raster
    from tiler_tpu_torch.utils.clips import synthetic_clip

    enc = Encoder(EncoderSettings(), device=device, log=None)
    enc.load_frames(synthetic_clip(F, H, W), 25.0)
    enc.predict_motion().reduce().prepare_palettes().dither()
    st = enc.state
    ds = tile_features_raster(rc._render_corpus(
        st.palettes_rgb.long(), st.corpus_pal_initial.long(), st.corpus_pal_pixels).float())
    T = ds.shape[0]
    if T < 2 * k * kn.TB:
        raise AssertionError(f"corpus of {T} tiles is below the knn kernels' gate for k={k}")
    Tp = -(-T // kn.TP_ALIGN) * kn.TP_ALIGN
    dsTa = kn.knn_prep2(ds, Tp)
    dsT, d2 = kn.knn_prep_v1(ds, Tp)
    dsd = ds.double()
    d2d = (dsd * dsd).sum(1)
    hits, zero_keys, cells = {}, 0.0, 0
    for f in frames:
        feats = tile_features_raster(st.tiles_canon[f].float())
        N = feats.shape[0]
        cells += N
        Np = -(-N // kn.CELL_BLOCK) * kn.CELL_BLOCK
        fa = kn.fold_cells(feats, Np)
        fb = torch.nn.functional.pad(feats.to(torch.bfloat16), (0, 0, 0, Np - N))
        idx2, err2 = kn.knn_bucket_topk2(feats, dsTa, k)
        zero_keys += float((err2 == 0).sum())  # B2 clamps its distance at 0
        picks = {
            "knn_bucket_top2": idx2,
            "knn_bucket_top2 plain": kn._merge_topk(
                *kn.knn_bucket_top2_plain(fa, dsTa), N, k)[0],
            "knn_bucket_top2_v1": kn.knn_bucket_topk(feats, dsT, d2, k)[0],
            "knn_bucket_top2_v1 plain": kn._merge_topk(
                *kn.knn_bucket_top2_v1_plain(fb, dsT, d2), N, k)[0],
        }
        for c0 in range(0, N, 1024):
            fc = feats[c0:c0 + 1024].double()
            dist = (fc * fc).sum(1, keepdim=True) - 2 * fc @ dsd.T + d2d
            want = torch.sort(dist, dim=1, stable=True).indices[:, :k]
            chunks = [("exact", want)] + [(n, i[c0:c0 + 1024].long()) for n, i in picks.items()]
            for name, sel in chunks:
                hit = (sel[:, :, None] == want[:, None, :]).any(-1).float().sum()
                h = hits.setdefault(name, [0.0, 0.0, 0])
                h[0] += float(hit)
                h[1] += float(dist.gather(1, sel).sum())
                h[2] += sel.numel()
    out = {name: {"recall": h[0] / h[2], "mean_dist": h[1] / h[2]} for name, h in hits.items()}
    print(f"top-{k} on the encode's data (T={T}, frames {list(frames)}): "
          + "; ".join(f"{n}: recall {v['recall']:.4f}, mean exact distance {v['mean_dist']:.1f}"
                      for n, v in out.items())
          + f"; B2 keys clamped to 0: {zero_keys / cells:.2f} of {k} per cell", flush=True)
    for name in ("knn_bucket_top2", "knn_bucket_top2_v1"):
        if abs(out[name]["recall"] - out[name + " plain"]["recall"]) > 0.005:
            raise AssertionError(f"{name} and its plain version recall differently on "
                                 f"the encode's data: {out}")
    return out


SMALL = dict(palette_count=8, motion_predict_radius=4, epu_knn_k=8, kmeans_iters=4)


def small_clip_agreement(**overrides):
    """The same small encode on the card and on the CPU (plain kernel
    versions): the end-to-end gate of docs/DETERMINISM.md."""
    from tiler_tpu_torch.bitstream.gtm import GTMDecoder
    from tiler_tpu_torch.config import EncoderSettings
    from tiler_tpu_torch.pipeline.encoder import Encoder
    from tiler_tpu_torch.utils.clips import synthetic_clip

    clip = synthetic_clip(6, 64, 96)
    os.makedirs(STREAM_DIR, exist_ok=True)
    out = {}
    for dev in ("cuda", "cpu"):
        path = os.path.join(STREAM_DIR, f"small_{dev}.gtm")
        enc = Encoder(EncoderSettings(**SMALL, **overrides), device=dev, log=None)
        enc.run_all(clip, fps=25.0, out_path=path)
        frames = np.stack(GTMDecoder(path).decode_frames())[..., :3]
        mse = float(np.mean((frames.astype(np.float64) - clip) ** 2))
        out[dev] = (10 * np.log10(255 * 255 / max(mse, 1e-9)), enc.stats.total_bytes)
    d_db = abs(out["cuda"][0] - out["cpu"][0])
    d_bytes = abs(out["cuda"][1] - out["cpu"][1]) / out["cpu"][1]
    print(f"small clip {overrides or 'defaults'} cuda vs cpu: {out}; |dPSNR| {d_db:.4f} dB, "
          f"|dbytes| {d_bytes:.4%}", flush=True)
    if d_db > 0.1 or d_bytes > 0.02:
        raise AssertionError("small-clip encode on the card disagrees with the CPU")
    return {"cuda": out["cuda"], "cpu": out["cpu"], "d_db": d_db, "d_bytes": d_bytes}


def yliluoma2_dither_agreement():
    """One state (the small clip up to its palettes, made on the CPU)
    dithered with Yliluoma2 on the card and on the CPU: all int32, so the
    palette pixels must be bit-identical."""
    import copy

    import torch

    from tiler_tpu_torch.config import EncoderSettings
    from tiler_tpu_torch.models.convert import state_from_numpy, state_to_numpy
    from tiler_tpu_torch.pipeline import dither
    from tiler_tpu_torch.pipeline.encoder import Encoder
    from tiler_tpu_torch.utils.clips import synthetic_clip

    settings = EncoderSettings(**SMALL, dithering_use_thomas_knoll=False)
    enc = Encoder(settings, device="cpu", log=None)
    enc.load_frames(synthetic_clip(6, 64, 96), 25.0)
    enc.predict_motion().reduce().prepare_palettes()
    snap = state_to_numpy(copy.copy(enc.state))
    got = {dev: dither.dither(state_from_numpy(copy.copy(snap), dev), settings)
           .corpus_pal_pixels.cpu() for dev in ("cuda", "cpu")}
    if not torch.equal(got["cuda"], got["cpu"]):
        raise AssertionError("the Yliluoma2 dither on the card differs from the CPU's")
    print(f"Yliluoma2 dither of {len(got['cpu'])} tiles: card and CPU bit-identical",
          flush=True)


def write_y4m_420(path, frames, fps):
    """A planar 4:2:0 y4m (BT.601 full range, chroma averaged over 2x2)."""
    H, W = frames[0].shape[:2]
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{W} H{H} F{round(fps * 1000)}:1000 Ip A1:1 C420jpeg\n".encode())
        for fr in frames:
            rgb = fr.astype(np.float32)
            y = rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114
            u = ((rgb[..., 2] - y) * 0.492 + 128).reshape(H // 2, 2, W // 2, 2).mean((1, 3))
            v = ((rgb[..., 0] - y) * 0.877 + 128).reshape(H // 2, 2, W // 2, 2).mean((1, 3))
            f.write(b"FRAME\n" + b"".join(
                np.clip(np.round(p), 0, 255).astype(np.uint8).tobytes() for p in (y, u, v)))


def y4m_device_ingest(F=8, H=288, W=352):
    """A CIF y4m (planar 4:2:0) through Encoder.load_video and the whole
    encode on the card: its planes go up at source size and the card
    converts them (scaling=1: the frames must be the host ingest's, bit
    for bit) and resamples them (scaling=2: 704x576, against the host's
    PIL Lanczos)."""
    from tiler_tpu_torch.bitstream.gtm import GTMDecoder
    from tiler_tpu_torch.config import EncoderSettings
    from tiler_tpu_torch.io import video
    from tiler_tpu_torch.pipeline.encoder import Encoder
    from tiler_tpu_torch.utils.clips import synthetic_clip

    os.makedirs(STREAM_DIR, exist_ok=True)
    src = os.path.join(STREAM_DIR, "cif420.y4m")
    write_y4m_420(src, list(synthetic_clip(F, H, W)), 25.0)
    out = {}
    for scaling in (1.0, 2.0):
        stream = os.path.join(STREAM_DIR, f"cif_x{scaling:g}.gtm")
        enc = Encoder(EncoderSettings(input_file_name=src, output_file_name=stream,
                                      scaling=scaling, palette_count=64),
                      device="cuda", log=None)
        t0 = time.monotonic()
        enc.run_all()
        wall = time.monotonic() - t0
        host = video.load_video(src, scaling=scaling)[0]
        th, tw = host.shape[1:3]
        got = enc.state.frames_rgb.cpu().numpy()[:, :th, :tw]
        if (enc.state.height, enc.state.width) != (-(-th // 8) * 8, -(-tw // 8) * 8):
            raise AssertionError(f"scaling={scaling}: ingested {enc.state.width}x"
                                 f"{enc.state.height}, the host {tw}x{th}")
        mse = float(np.mean((got.astype(np.float64) - host) ** 2))
        db = 10 * np.log10(255 * 255 / mse) if mse else float("inf")
        if scaling == 1.0 and not np.array_equal(got, host):
            raise AssertionError("the planar ingest at scaling=1 differs from the host's")
        if db < 40.0:
            raise AssertionError(f"scaling={scaling}: {db:.2f} dB against the host's resize")
        frames = GTMDecoder(stream).decode_frames()
        if len(frames) != F or frames[0].shape[:2] != (enc.state.height, enc.state.width):
            raise AssertionError(f"scaling={scaling}: decoded {len(frames)} frames of "
                                 f"{frames[0].shape}")
        print(f"[y4m x{scaling:g}] {W}x{H}x{F} planar 4:2:0 -> {enc.state.width}x"
              f"{enc.state.height}: ingest "
              + ("bit-identical to the host's" if mse == 0 else f"{db:.2f} dB from the host's")
              + f"; encode {wall:.3f} s, load {enc.timings['load']:.3f} s, "
              f"{enc.stats.total_bytes} bytes, PSNR-HVS {enc.state.total_psnr:.4f} dB",
              flush=True)
        out[scaling] = {"wall_s": wall, "bytes": enc.stats.total_bytes, "ingest_db": db}
    return out


def resaved(**defaults):
    """encode_path's after-hook of the EPU table settings: the encoder's
    state saved once more under the settings text of ``defaults`` (the
    stream embeds its settings, and EpuFusedFp is one of them), so that
    the bytes compare with the stream of the path without the setting."""
    import dataclasses

    def save(enc, stream):
        settings = enc.settings
        enc.settings = dataclasses.replace(settings, **defaults)
        enc.save(stream + ".resaved")
        enc.settings = settings
        with open(stream + ".resaved", "rb") as f:
            return {"resaved": f.read()}

    return save


def epu_paths(default, wide256):
    """The EPU's two table settings (point 9 of the module docstring),
    against the paths without them."""
    from tiler_tpu_torch.config import EncoderSettings

    wide = dict(palette_count=16, palette_size=256)
    out = {"wide256_two_stage": encode_path(
        "wide256_two_stage", EncoderSettings(**wide, epu_two_stage=True), ("tk_select_wide",),
        F=8, min_corpus=0, after=read_back(16, 256))}
    out["wide256_fused"] = encode_path(
        "wide256_fused", EncoderSettings(**wide, epu_fused_fp=True), ("tk_select_wide",),
        F=8, min_corpus=0, again=False, after=resaved(epu_fused_fp=False))
    out["fused_fp"] = encode_path("fused_fp", EncoderSettings(epu_fused_fp=True),
                                  ("tk_select", "knn_bucket_top2"), again=False,
                                  after=resaved(epu_fused_fp=False))
    for name, ref in (("wide256_two_stage", wide256), ("wide256_fused", wide256),
                      ("fused_fp", default)):
        run = out[name]
        check_against_reference(name, run, corpus=None if name.startswith("wide") else CORPUS_T)
        if "resaved" in run and run.pop("resaved") != ref["stream"]:
            raise AssertionError(f"the {name} encode, saved under the settings text of the "
                                 "path without the setting, is not that path's stream")
        stages = run.get("second_stage_s", run["stage_s"])
        print(f"[{name}] against {'wide256' if ref is wide256 else 'default'}: PSNR-HVS "
              f"{run['psnr_hvs_db'] - ref['psnr_hvs_db']:+.4f} dB, bytes "
              f"{(run['bytes'] - ref['bytes']) / ref['bytes']:+.4%}, T {run['corpus_tiles']} / "
              f"{ref['corpus_tiles']}, reconstruct {stages['reconstruct']:.3f} / "
              f"{ref['second_stage_s']['reconstruct']:.3f} s, peak device memory allocated "
              f"{run['peak_bytes']} / {ref['peak_bytes']} bytes"
              + ("" if "two_stage" in name else ", the same stream to the byte"), flush=True)
    print("[wide256_two_stage] second encode, stage (s): wide256_two_stage / wide256: "
          + " ".join(f"{k}={v:.3f}/{wide256['second_stage_s'][k]:.3f}"
                     for k, v in out["wide256_two_stage"]["second_stage_s"].items()), flush=True)
    return out


class BlockifyDepths:
    """Records the depth K of every blockify_field call that the motion
    search makes while it is open (the wrapper itself counts launches)."""

    def __enter__(self):
        from tiler_tpu_torch.pipeline import motion

        self.motion, self.real, self.depths = motion, motion.blockify_field, []

        def record(F):
            self.depths.append(F.shape[-1])
            return self.real(F)

        motion.blockify_field = record
        return self

    def __exit__(self, *exc):
        self.motion.blockify_field = self.real


def search_paths(default, im2row_v1):
    """The last motion and corpus-search settings (point 10 of the module
    docstring), against the default encode and im2row_v1."""
    from tiler_tpu_torch.config import EncoderSettings

    out = {"ivf": encode_path("ivf", EncoderSettings(knn_backend="ivf"), ("tk_select",),
                              again=False)}
    run = out["ivf"]
    check_against_reference("ivf", run)
    d_db = run["psnr_hvs_db"] - default["psnr_hvs_db"]
    print(f"[ivf] {run['ivf_blocks']} blocks of 128 tiles, {run['ivf_overflow']:.6%} of the "
          f"cells' probes dropped by the capacity (the last row's padding, its last cell "
          f"repeated, not counted); against the default: PSNR-HVS {d_db:+.4f} dB, "
          f"bytes {(run['bytes'] - default['bytes']) / default['bytes']:+.4%}; stage (s): "
          "ivf / default's second encode: "
          + " ".join(f"{k}={v:.3f}/{default['second_stage_s'][k]:.3f}"
                     for k, v in run["stage_s"].items()), flush=True)
    if not run["ivf_blocks"] > 0:
        raise AssertionError("the ivf encode did not search through an IVF")
    if not run["ivf_overflow"] < 0.01:
        raise AssertionError(f"the IVF dropped {run['ivf_overflow']:.4%} of its probes")
    if abs(d_db) > 1.0:
        raise AssertionError(f"the ivf encode is {d_db:+.4f} dB from the default")
    out["rank48"] = encode_path("rank48", EncoderSettings(motion_rank_dims=48),
                                ("tk_select", "knn_bucket_top2"), again=False)
    check_against_reference("rank48", out["rank48"], corpus=None)
    with BlockifyDepths() as rec:
        out["rank27_im2row"] = encode_path(
            "rank27_im2row", EncoderSettings(motion_field="im2row", motion_rank_dims=27),
            ("tk_select", "knn_bucket_top2", "blockify_field"), again=False)
    check_against_reference("rank27_im2row", out["rank27_im2row"], corpus=None)
    if set(rec.depths) != {27} or len(rec.depths) != out["rank27_im2row"]["launches"][
            "blockify_field"]:
        raise AssertionError(f"rank27_im2row relaid out its field at depths {rec.depths}")
    for name in ("rank48", "rank27_im2row"):
        run = out[name]
        print(f"[{name}] T {run['corpus_tiles']}; stage (s) {name} / default: "
              + " ".join(f"{k}={v:.3f}/{default['second_stage_s'][k]:.3f}"
                         for k, v in run["stage_s"].items())
              + "".join(f"; against {ref_name}: PSNR-HVS "
                        f"{run['psnr_hvs_db'] - ref['psnr_hvs_db']:+.4f} dB, bytes "
                        f"{(run['bytes'] - ref['bytes']) / ref['bytes']:+.4%}"
                        for ref_name, ref in (("default", default), ("im2row_v1", im2row_v1))),
              flush=True)
    print(f"[rank27_im2row] blockify_field at K = {sorted(set(rec.depths))}, "
          f"{len(rec.depths)} calls", flush=True)
    return out


def wide_paths(default):
    """The wide palettes and the other palette and dither settings (point
    8 of the module docstring), each against the default encode."""
    from tiler_tpu_torch.config import EncoderSettings

    out = {"wide256": encode_path(
        "wide256", EncoderSettings(palette_count=16, palette_size=256), ("tk_select_wide",),
        F=8, min_corpus=0, after=read_back(16, 256))}
    check_against_reference("wide256", out["wide256"], corpus=None)
    out["wide64"] = encode_path("wide64", EncoderSettings(palette_size=64),
                                ("tk_select_wide", "knn_bucket_top2"), after=read_back(1024, 64))
    check_against_reference("wide64", out["wide64"])
    out["plain_tk"] = encode_path("plain_tk", EncoderSettings(use_pallas_tk=False),
                                  ("knn_bucket_top2",), again=False)
    check_against_reference("plain_tk", out["plain_tk"])
    if out["plain_tk"]["stream"] != default["stream"]:
        raise AssertionError("the plain Thomas Knoll path wrote another stream than tk_select")
    out["mediancut_wavelets"] = encode_path(
        "mediancut_wavelets", EncoderSettings(color_quantizer="mediancut",
                                              dithering_mode="wavelets"),
        ("tk_select", "knn_bucket_top2"), again=False)
    check_against_reference("mediancut_wavelets", out["mediancut_wavelets"])
    for name, run in out.items():
        print(f"[{name}] against the default: PSNR-HVS "
              f"{run['psnr_hvs_db'] - default['psnr_hvs_db']:+.4f} dB, bytes "
              f"{(run['bytes'] - default['bytes']) / default['bytes']:+.4%}, peak device memory "
              f"allocated {run['peak_bytes']} bytes"
              + (", stream identical" if run["stream"] == default["stream"] else ""), flush=True)
    for name in ("wide256", "wide64"):
        print(f"[{name}] second encode, stage (s): {name} / default: "
              + " ".join(f"{k}={v:.3f}/{default['second_stage_s'][k]:.3f}"
                         for k, v in out[name]["second_stage_s"].items()), flush=True)
    return out


MESH_RANKS = 4
MESH_TIMEOUT = 900  # seconds the gloo group has for its encode
MESH_CLIP = (32, 720, 1280)  # frames, height, width: both mesh encodes
MESH_PICK_FRAMES = (0, 16)  # frames whose phase-A picks are held against an exact top-k


def sharded_topk_split(T=CORPUS_T, N=14400, k=64):
    """The mesh branch's top-k of one frame's N cells against T tiles at
    world 1, by its chunks of rows, in its two parts, each parallel/knn.py's
    own: the float32 distances (``sq_dists``) and the stable ranking of the
    int64 keys (``stable_topk``), timed apart on random features. Returns
    ms a frame."""
    import torch

    from tiler_tpu_torch.parallel import knn

    gen = torch.Generator(device="cuda").manual_seed(3)
    feats = torch.randn(N, 192, device="cuda", generator=gen) * 50
    ds = torch.randn(T, 192, device="cuda", generator=gen) * 50
    rows = knn.chunk_rows(T)
    f, dn = feats[:rows], (ds * ds).sum(dim=1)
    chunks = -(-N // rows)
    d2 = knn.sq_dists(f, ds, dn)
    out = {"distances_ms": chunks * cuda_ms(lambda: knn.sq_dists(f, ds, dn), 5),
           "stable_topk_ms": chunks * cuda_ms(lambda: knn.stable_topk(d2, k), 5)}
    print(f"sharded_topk at world 1, one frame ({N} cells x {T} tiles, k={k}, {chunks} chunks "
          f"of {rows} rows): float32 distances {out['distances_ms']:.2f} ms, stable top-{k} "
          f"of the int64 keys {out['stable_topk_ms']:.2f} ms", flush=True)
    return out


def mesh_picks(enc, frames=MESH_PICK_FRAMES, k=64):
    """Phase A's top-k on the mesh held against a plain, meshless exact
    top-k. ``enc`` holds a mesh encode's state after the dither: its
    corpus features, this rank's shard of them as reconstruct cuts it
    (padded to the "corpus" axis), sharded_topk of each frame's cells, and
    beside it the float64 distances of the same cells to the whole corpus.
    No pick may be a padding row; each row's errors must ascend and lie
    within tol of the float64 distances; every pick must be of the exact
    top-k but at near-ties: its float64 distance at most the k-th's plus
    tol, and every tile more than tol below the k-th picked (tol = 1e-5
    (|f|^2 + max |d|^2), a cell's float32 rounding with a wide margin).
    Returns the recall of the exact top-k (tied picks aside, those that
    torch.topk of the float64 distances also took)."""
    import torch

    from tiler_tpu_torch.parallel.knn import sharded_topk
    from tiler_tpu_torch.pipeline import reconstruct as rc
    from tiler_tpu_torch.pipeline.motion import tile_features_raster

    st = enc.state
    dev = st.corpus_pal_pixels.device
    ds = tile_features_raster(rc._render_corpus(
        st.palettes_rgb.long(), st.corpus_pal_initial.long(), st.corpus_pal_pixels).float())
    T = ds.shape[0]
    ds_local = rc.mesh_corpus_shard(ds, enc.mesh)
    dsd = ds.double()
    d2d = (dsd * dsd).sum(dim=1)
    hit = picked = 0
    for fr in frames:
        feats = tile_features_raster(torch.as_tensor(st.tiles_canon[fr], device=dev).float())
        idx, err = sharded_topk(feats, ds_local, k, enc.mesh)
        if int(idx.max()) >= T:
            raise AssertionError(f"a padding row of the sharded corpus ranked in frame {fr}")
        if bool((err[:, 1:] < err[:, :-1]).any()):
            raise AssertionError(f"sharded_topk's errors do not ascend in frame {fr}")
        idx, err = idx.long(), err.double()
        for c0 in range(0, feats.shape[0], 1024):
            fc = feats[c0:c0 + 1024].double()
            f2 = (fc * fc).sum(dim=1, keepdim=True)
            dist = f2 - 2.0 * (fc @ dsd.T) + d2d
            tol = 1e-5 * (f2 + d2d.max())
            exact = torch.topk(dist, k, dim=1, largest=False)
            kth = exact.values[:, -1:]
            sel = idx[c0:c0 + 1024]
            got = dist.gather(1, sel)
            if (bool((got > kth + tol).any())
                    or bool(((got < kth - tol).sum(1) != (dist < kth - tol).sum(1)).any())
                    or bool(((err[c0:c0 + 1024] - got).abs() > tol).any())):
                raise AssertionError(f"sharded_topk's picks in frame {fr}, cells {c0}.. are not "
                                     "the exact top-k")
            hit += int((sel[:, :, None] == exact.indices[:, None, :]).any(-1).sum())
            picked += sel.numel()
    return hit / picked


def mesh_nccl1(default):
    """The mesh encode in an NCCL group of one rank, mesh (1, 1) ("data",
    "corpus"): every cell through the exact sharded top-k (no B2, no
    compaction), tk_select once. Held to REF_ENCODES' figure for this
    path, and its phase-A picks to an exact float64 top-k (mesh_picks).
    Against the meshless default, another encoder (float32 rankings,
    another k-means seeding), the gap is printed."""
    import torch.distributed as dist

    from tiler_tpu_torch.config import EncoderSettings
    from tiler_tpu_torch.parallel.mesh import free_port, make_mesh
    from tiler_tpu_torch.pipeline.encoder import Encoder
    from tiler_tpu_torch.utils.clips import synthetic_clip

    F, H, W = MESH_CLIP
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, ("data", "corpus"))
        run = encode_path("mesh_nccl1", EncoderSettings(), ("tk_select",), F=F, H=H, W=W,
                          mesh=mesh)
        enc = Encoder(EncoderSettings(), mesh=mesh, log=None)
        enc.load_frames(synthetic_clip(F, H, W), 25.0)
        enc.predict_motion().reduce().prepare_palettes().dither()
        run["pick_recall"] = mesh_picks(enc)
        del enc
    finally:
        dist.destroy_process_group()
    print(f"[mesh_nccl1] phase A's top-64 of frames {list(MESH_PICK_FRAMES)}: the exact "
          f"float64 top-64 but at near-ties, recall {run['pick_recall']:.6f}", flush=True)
    check_against_reference("mesh_nccl1", run)
    if run["knn_kernel_cells"] != 0:
        raise AssertionError(f"the mesh path sent {run['knn_kernel_cells']} cells to a top-k "
                             "kernel")
    d_db = run["psnr_hvs_db"] - default["psnr_hvs_db"]
    d_bytes = (run["bytes"] - default["bytes"]) / default["bytes"]
    print(f"[mesh_nccl1] against the meshless default (another encoder): PSNR-HVS "
          f"{d_db:+.4f} dB, bytes {d_bytes:+.4%}", flush=True)
    run.update({"d_db": d_db, "d_bytes": d_bytes, "topk_split": sharded_topk_split()})
    print("[mesh_nccl1] second encode, stage (s): mesh_nccl1 / default: "
          + " ".join(f"{k}={v:.3f}/{default['second_stage_s'][k]:.3f}"
                     for k, v in run["second_stage_s"].items())
          + f"; peak device memory allocated {run['peak_bytes']} / {default['peak_bytes']} "
          "bytes", flush=True)
    return run


# the kernels the profile phase looks for in its traces: the step whose
# trace holds them, and how a kernel event's name is recognized
PROFILE_KERNELS = {
    "tk_select": ("dither", lambda n: "tk_select_kernel" in n),
    # B2 is knn_top2_wgmma<depth, false> (v1: true); demangled or mangled
    "knn_bucket_top2": ("reconstruct",
                        lambda n: "knn_top2_wgmma" in n and ("false" in n or "Lb0E" in n)),
}


def profile_encode(default):
    """One default encode with TILER_TPU_PROFILE set: a Chrome trace per
    step (utils/progress.trace_step, torch.profiler with CUDA activity).
    The dither trace must name tk_select's kernel and the reconstruct
    trace B2's, each as many times as its wrapper counted launches; the
    stream must be the default's. Prints each step's kernel time from its
    trace beside Encoder.timings."""
    from tiler_tpu_torch.config import EncoderSettings
    from tiler_tpu_torch.pipeline.encoder import STEPS

    prof_dir = os.path.join(STREAM_DIR, "profile")
    shutil.rmtree(prof_dir, ignore_errors=True)
    os.environ["TILER_TPU_PROFILE"] = prof_dir
    try:
        run = encode_path("profile", EncoderSettings(), ("tk_select", "knn_bucket_top2"),
                          again=False)
    finally:
        del os.environ["TILER_TPU_PROFILE"]
    kernel_ms, in_trace = {}, {}
    for step in STEPS[1:-1]:
        with open(os.path.join(prof_dir, f"{step}.json")) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
        kernel_ms[step] = sum(e.get("dur", 0) for e in events) / 1e3
        for kname, (kstep, match) in PROFILE_KERNELS.items():
            if step == kstep:
                in_trace[kname] = sum(1 for e in events if match(e.get("name", "")))
    shutil.rmtree(prof_dir)
    print("[profile] step: kernel time in its trace (ms) / Encoder.timings (s): "
          + " ".join(f"{k}={kernel_ms[k]:.3f}/{run['stage_s'][k]:.3f}" for k in kernel_ms),
          flush=True)
    print(f"[profile] launches in the traces {in_trace}, by the wrappers' counts "
          f"{ {k: run['launches'][k] for k in in_trace} }", flush=True)
    for kname, n in in_trace.items():
        if n == 0 or n != run["launches"][kname]:
            raise AssertionError(f"the {PROFILE_KERNELS[kname][0]} trace shows {n} launches "
                                 f"of {kname}, its wrapper counted {run['launches'][kname]}")
    if run["stream"] != default["stream"]:
        raise AssertionError("the profiled encode wrote another stream than the default's")
    return {"kernel_ms": kernel_ms, "stage_s": run["stage_s"], "trace_launches": in_trace}


def ordered_on_card(T=CORPUS_T, seed=0):
    """The palettization's fixed-order arithmetic (ops/ordered.py) on the
    card against the CPU, bit for bit: the corpus features at the encode's
    corpus size (the default mode and wavelets), and the k-means segment
    sum of the first k-means' shape ([131,072, 193] rows into 512) and of
    single values. Times the features on the card."""
    import torch

    from tiler_tpu_torch.ops import dct, ordered

    rng = np.random.default_rng(seed)
    tiles = torch.from_numpy(rng.integers(0, 256, (T, 8, 8, 3), dtype=np.uint8)).float()
    gtiles = tiles.cuda()
    for mode in ("weighted_spe_dct", "wavelets"):
        want = dct.tile_features(tiles, mode, use_lab=True)
        got = dct.tile_features(gtiles, mode, use_lab=True).cpu()
        if not torch.equal(got, want):
            raise AssertionError(f"the ordered {mode} features differ between the card and "
                                 f"the CPU at {int((got != want).sum())} entries")
    ms = cuda_ms(lambda: dct.tile_features(gtiles, "weighted_spe_dct", use_lab=True), 3)
    vals = torch.from_numpy((rng.standard_normal((131072, 193)) * 1000).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 512, 131072))
    for v in (vals, vals[:, 0].contiguous()):
        want = ordered.segment_sum(v, ids, 512)
        got = ordered.segment_sum(v.cuda(), ids.cuda(), 512).cpu()
        if not torch.equal(got, want):
            raise AssertionError(f"segment_sum of {list(v.shape)} differs between the card "
                                 "and the CPU")
    print(f"[ordered] features of {T} tiles (weighted_spe_dct, wavelets) and segment sums "
          f"([131072, 193] and [131072] into 512): card and CPU bit-identical; the features "
          f"take {ms:.3f} ms on the card", flush=True)


def motion_order(H=720, W=1280, radius=32):
    """The default motion search (passes field, 192 dims) on frames 1 and
    0 of the 720p clip on the card, twice: both runs must give the same
    vectors and error bits. Prints how many vectors differ from the
    port's CPU search of the same pair, which runs in the JAX package's
    CPU float order (the card keeps cuBLAS's bf16 product and plain
    float32 passes, so the count has no limit), and times the card's
    search beside the field built in that order on the card, the reason
    the card keeps its own arithmetic."""
    import torch

    from tiler_tpu_torch.pipeline import motion
    from tiler_tpu_torch.utils.clips import synthetic_clip

    clip = torch.from_numpy(synthetic_clip(2, H, W))
    cur, prev = clip[1].cuda(), clip[0].cuda()
    runs = [[v.cpu() for v in motion.motion_search(cur, prev, radius)] for _ in range(2)]
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(*runs)):
        raise AssertionError("two runs of the motion search on the card differ")
    t0 = time.monotonic()
    cy, cx, ce = motion.motion_search(clip[1], clip[0], radius)
    cpu_s = time.monotonic() - t0
    gy, gx, ge = runs[0]
    differ = int(((gy != cy) | (gx != cx)).sum())
    search_ms = cuda_ms(lambda: motion.motion_search(cur, prev, radius), 3)
    th, tw, P = H // 8, W // 8, 32
    mh, mw = -(-(H - 7 + 2 * P) // 8), -(-(W - 7 + 2 * P) // 8)
    mu = torch.zeros(192, device="cuda")
    field_ms = {o: cuda_ms(lambda o=o: motion._window_field_blocks(prev, mu, P, mh, mw, 192, o), 3)
                for o in (False, True)}
    print(f"[motion_order] {H}x{W}, radius {radius}: two runs on the card bit-identical; "
          f"{differ} of {th * tw} vectors differ from the CPU's XLA-order search "
          f"({cpu_s:.1f} s on the CPU); the card's search {search_ms:.3f} ms, its field "
          f"{field_ms[False]:.3f} ms, the field in XLA's order on the card "
          f"{field_ms[True]:.3f} ms", flush=True)
    return {"differ": differ, "search_ms": search_ms, "field_ms": field_ms}


def reconstruct_order(H=720, W=1280, band=128, seed=0, device="cuda"):
    """Reconstruct's and the k-means seeding's ordered per-cell code on the
    card against the same calls on the CPU, bit for bit, each timed on the
    card: the features of a 720p frame's 14,400 tiles in XLA's CPU order
    (as a program fuses the luma, and as the corpus's are taken, unfused),
    their exact errors against random (tile, palette) picks of a 4,096-tile
    corpus, and prng.gumbel (1,024 keys of 2,048 draws, the palette
    seeding's shape). Then the top ``band`` rows of the first two frames
    of the 720p clip, at full width, brought through the dither on the
    card, reconstruct once on the card (its own arithmetic) and once on
    the CPU (the JAX package's CPU order) from the same state: prints how
    many of frame 1's EPU winners and phase-B flags differ (no limit: the
    card keeps its own arithmetic) and the CPU's time."""
    import copy

    import torch

    from tiler_tpu_torch.config import EncoderSettings
    from tiler_tpu_torch.models.convert import state_from_numpy, state_to_numpy
    from tiler_tpu_torch.ops import prng
    from tiler_tpu_torch.pipeline import reconstruct as rc
    from tiler_tpu_torch.pipeline.encoder import Encoder
    from tiler_tpu_torch.utils.clips import synthetic_clip

    def same(a, b, what):
        a, b = a.cpu(), b.cpu()
        if not torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b):
            raise AssertionError(f"reconstruct_order: {what} differ between the card and the "
                                 f"CPU at {int((a != b).sum())} entries")

    clip = synthetic_clip(2, H, W)
    tiles = torch.from_numpy(clip[1]).reshape(H // 8, 8, W // 8, 8, 3).transpose(1, 2)
    tiles = tiles.reshape(-1, 8, 8, 3).float()
    gtiles = tiles.to(device)
    ms = {}
    for name, luma in (("cell features", True), ("corpus features", False)):
        for a, b in zip(rc._features(gtiles, False, True, luma), rc._features(tiles, False, True, luma)):
            same(a, b, name)
        ms[name] = cuda_ms(lambda luma=luma: rc._features(gtiles, False, True, luma), 3)
    rng = np.random.default_rng(seed)
    T, P, S, N = 4096, 64, 16, len(tiles)
    cpu = [torch.from_numpy(v) for v in (rng.integers(0, T, N), rng.integers(0, P, N),
                                         rng.integers(0, S, (T, 8, 8), dtype=np.uint8),
                                         rng.integers(0, 256, (P, S, 3), dtype=np.uint8))]
    z, feats = rc._features(tiles, False, True)
    gargs = [v.to(device) for v in (feats, *cpu)]
    gz = z.to(device)
    same(rc._exact_choice_err(*gargs, False, gz), rc._exact_choice_err(feats, *cpu, False, z),
         "exact errors")
    ms["exact errors"] = cuda_ms(lambda: rc._exact_choice_err(*gargs, False, gz), 3)
    keys = prng.split(prng.prng_key(seed), 1024)
    same(prng.gumbel(keys.to(device), (2048,), device=device), prng.gumbel(keys, (2048,)),
         "Gumbel draws")
    ms["gumbel"] = cuda_ms(lambda: prng.gumbel(keys.to(device), (2048,), device=device), 3)

    settings = EncoderSettings()
    enc = Encoder(settings, log=None, device=device)
    enc.load_frames(np.ascontiguousarray(clip[:, :band]), 25.0)
    enc.predict_motion().reduce().prepare_palettes().dither()
    snap = state_to_numpy(copy.copy(enc.state))
    card = rc.reconstruct(state_from_numpy(snap, device), settings).tilemap
    t0 = time.monotonic()
    host = rc.reconstruct(state_from_numpy(snap, "cpu"), settings).tilemap
    cpu_s = time.monotonic() - t0
    both = ~card.predicted[1] & ~host.predicted[1]
    winners = int((both & ((card.tile_idx[1] != host.tile_idx[1])
                           | (card.pal_idx[1] != host.pal_idx[1]))).sum())
    flags = int((card.predicted[1] != host.predicted[1]).sum())
    print(f"[reconstruct_order] card = CPU bit for bit: the features of {N} tiles (cells, "
          f"corpus), their exact errors, {keys.shape[0]}x2048 Gumbel draws; card ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f". Frame 1 of {band}x{W} (T={len(snap.corpus_rgb)}): {winners} of "
          f"{int(both.sum())} EPU winners and {flags} of {both.size} phase-B flags differ "
          f"between the card's arithmetic and the CPU's XLA order (the CPU's reconstruct {cpu_s:.1f} s)", flush=True)
    return {"ms": ms, "winners": winners, "flags": flags, "cpu_s": cpu_s}


def kmodes_on_card(n=50000, d=64, values=16, k=64, max_iter=10, seed=0):
    """cluster/kmodes.py on the card against its own run on the CPU: a
    seeded [n, d] uint8 set of ``values`` values (k clusters' modes with
    half the attributes redrawn), k modes, max_iter iterations. Modes,
    labels and the iteration count must be identical. Prints both times."""
    import torch

    from tiler_tpu_torch.cluster.kmodes import kmodes

    rng = np.random.default_rng(seed)
    centers = rng.integers(0, values, (k, d))
    x = centers[rng.integers(0, k, n)]
    x = np.where(rng.random((n, d)) < 0.5, rng.integers(0, values, (n, d)), x)
    x = torch.from_numpy(x.astype(np.uint8))
    t0 = time.monotonic()
    want = kmodes(x, k, max_iter)
    cpu_s = time.monotonic() - t0
    gx = x.cuda()
    kmodes(gx, k, 1)  # warm-up: allocator and kernel start-up
    torch.cuda.synchronize()
    t0 = time.monotonic()
    got = kmodes(gx, k, max_iter)
    torch.cuda.synchronize()
    card_s = time.monotonic() - t0
    if not (got[2] == want[2] and torch.equal(got[0].cpu(), want[0])
            and torch.equal(got[1].cpu(), want[1])):
        raise AssertionError("kmodes on the card differs from its run on the CPU")
    print(f"[kmodes] [{n}, {d}] uint8 of {values} values, k={k}, max_iter={max_iter}: "
          f"{got[2]} iterations, modes and labels equal on the card and the CPU; card "
          f"{card_s * 1e3:.1f} ms, CPU {cpu_s * 1e3:.1f} ms ({torch.get_num_threads()} "
          f"threads) on {card_line()}", flush=True)
    return {"card_s": card_s, "cpu_s": cpu_s, "iterations": got[2]}


def _gloo_rank(rank: int, port: int, stream: str, queue):
    """One rank of the gloo group on the one card: the (2, 2)-mesh encode
    of the clip at the reference defaults (rank 0 writes ``stream``), with
    its phase-A picks held by mesh_picks between the dither and
    reconstruct; sends back its state's hash, stage times, launches and
    peak."""
    import traceback
    from datetime import timedelta

    try:
        import torch
        import torch.distributed as dist

        from tiler_tpu_torch.config import EncoderSettings
        from tiler_tpu_torch.kernels import launch_counts, reset_launch_counts
        from tiler_tpu_torch.models.convert import state_digest
        from tiler_tpu_torch.parallel.mesh import make_mesh, mesh_shape
        from tiler_tpu_torch.pipeline.encoder import Encoder
        from tiler_tpu_torch.utils.clips import synthetic_clip

        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=MESH_RANKS, rank=rank,
                                timeout=timedelta(seconds=MESH_TIMEOUT))
        try:
            mesh = make_mesh(MESH_RANKS, ("data", "corpus"), device_type="cpu")
            enc = Encoder(EncoderSettings(), device="cuda", mesh=mesh, log=None)
            clip = synthetic_clip(*MESH_CLIP)
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.monotonic()
            enc.load_frames(clip, 25.0)
            enc.predict_motion().reduce().prepare_palettes().dither()
            wall = time.monotonic() - t0
            counts = launch_counts()
            recall = mesh_picks(enc)
            reset_launch_counts()
            t0 = time.monotonic()
            enc.reconstruct().reindex().save(stream)
            wall += time.monotonic() - t0
            counts = {k: v + counts[k] for k, v in launch_counts().items()}
            res = {"mesh": mesh_shape(mesh), "device": str(enc.device), "wall_s": wall,
                   "stage_s": enc.timings, "launches": counts,
                   "peak_bytes": torch.cuda.max_memory_allocated(),
                   "hash": state_digest(enc.state), "bytes": enc.stats.total_bytes,
                   "psnr_hvs_db": enc.state.total_psnr, "pick_recall": recall,
                   "corpus_tiles": enc.step_stats["corpus_tiles"],
                   "knn_kernel_cells": enc.step_stats["knn_kernel_cells"]}
        finally:
            dist.destroy_process_group()
        queue.put((rank, res, None))
    except Exception:  # the parent reports it and fails
        queue.put((rank, None, traceback.format_exc()))


def mesh_gloo4(world1):
    """Four gloo ranks on the one card (NCCL refuses two ranks on one
    card), mesh (2, 2): the collectives stage through host memory. The
    kernels are built before the ranks start. Every rank must end with
    the same state, launch tk_select once and B2 never, and hold its
    phase-A picks (the corpus in two shards, one padded) to the exact
    top-k; rank 0's stream must decode to every frame and stay within
    0.1 dB PSNR-HVS and 2% bytes of the world-1 mesh encode (another
    shard count: another k-means seeding)."""
    import multiprocessing
    import queue as queue_mod

    from tiler_tpu_torch.bitstream.gtm import GTMDecoder
    from tiler_tpu_torch.parallel.mesh import free_port
    from tiler_tpu_torch.utils.clips import synthetic_clip

    F, H, W = MESH_CLIP
    os.makedirs(STREAM_DIR, exist_ok=True)
    stream = os.path.join(STREAM_DIR, "mesh_gloo4.gtm")
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    t0 = time.monotonic()
    procs = [ctx.Process(target=_gloo_rank, args=(r, port, stream, q))
             for r in range(MESH_RANKS)]
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        for _ in range(MESH_RANKS):
            try:
                rank, res, err = q.get(timeout=MESH_TIMEOUT)
            except queue_mod.Empty:
                errors.append(f"no answer from {MESH_RANKS - len(got) - len(errors)} ranks "
                              f"in {MESH_TIMEOUT} s")
                break
            if err:
                errors.append(f"rank {rank}:\n{err}")
            else:
                got[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
    wall = time.monotonic() - t0
    if errors:
        raise AssertionError("the gloo mesh encode failed:\n" + "\n".join(errors))
    runs = [got[r] for r in range(MESH_RANKS)]
    r0 = runs[0]
    print(f"[mesh_gloo4] {MESH_RANKS} gloo ranks on {r0['device']}, mesh {r0['mesh']}, "
          f"{W}x{H}x{F}: {wall:.3f} s from spawn to the last rank's end; rank 0's encode "
          f"{r0['wall_s']:.3f} s, stages "
          + " ".join(f"{k}={v:.3f}" for k, v in r0["stage_s"].items())
          + f"; slowest rank's encode {max(r['wall_s'] for r in runs):.3f} s; peak device "
          f"memory allocated by rank {[r['peak_bytes'] for r in runs]}; launches by rank "
          f"{[r['launches'] for r in runs]}; T={r0['corpus_tiles']}, PSNR-HVS "
          f"{r0['psnr_hvs_db']:.4f} dB, {r0['bytes']} bytes; phase A's top-64 of frames "
          f"{list(MESH_PICK_FRAMES)} the exact one but at near-ties on every rank, recall "
          f"{[round(r['pick_recall'], 6) for r in runs]}", flush=True)
    if len({r["hash"] for r in runs}) != 1 or len({r["bytes"] for r in runs}) != 1:
        raise AssertionError(f"the ranks ended with different states: "
                             f"{[(r['hash'][:12], r['bytes']) for r in runs]}")
    for r in runs:
        if (r["launches"]["tk_select"], r["launches"]["knn_bucket_top2"],
                r["knn_kernel_cells"]) != (1, 0, 0):
            raise AssertionError(f"a gloo rank launched {r['launches']}, "
                                 f"{r['knn_kernel_cells']} top-k kernel cells")
    frames = np.stack(GTMDecoder(stream).decode_frames())
    if frames.shape != (F, H, W, 4):
        raise AssertionError(f"the gloo mesh stream decoded to {frames.shape}")
    clip = synthetic_clip(F, H, W)
    mse = float(np.mean((frames[..., :3].astype(np.float64) - clip) ** 2))
    r0 = {**r0, "psnr_rgb_db": 10 * np.log10(255 * 255 / max(mse, 1e-9)), "spawn_wall_s": wall}
    print(f"[mesh_gloo4] every rank's state hashes {r0['hash'][:16]}; decoded {len(frames)} "
          f"frames, RGB-PSNR {r0['psnr_rgb_db']:.4f} dB", flush=True)
    # another shard count (another k-means seeding): the JAX package's mesh
    # envelope, docs/DETERMINISM.md
    d_db = r0["psnr_hvs_db"] - world1["psnr_hvs_db"]
    d_bytes = (r0["bytes"] - world1["bytes"]) / world1["bytes"]
    print(f"[mesh_gloo4] against the world-1 mesh encode: PSNR-HVS {d_db:+.4f} dB, bytes "
          f"{d_bytes:+.4%}", flush=True)
    if abs(d_db) > 0.1 or abs(d_bytes) > 0.02:
        raise AssertionError("the gloo mesh encode left the world-1 mesh encode's 0.1 dB / "
                             "2% envelope")
    r0.update({"d_db": d_db, "d_bytes": d_bytes})
    r0["launches_by_rank"] = [r["launches"] for r in runs]
    r0["peak_bytes_by_rank"] = [r["peak_bytes"] for r in runs]
    return r0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible", file=sys.stderr)
        return 2
    from tiler_tpu_torch.config import EncoderSettings
    from tiler_tpu_torch.kernels import _build

    card = card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    t_start = t0 = time.monotonic()
    so = _build.build(verbose=True)
    print(f"kernels built in {time.monotonic() - t0:.2f} s -> {os.path.relpath(so, ROOT)}",
          flush=True)
    n_mma = sass_tensor_core_mmas(so)
    print("SASS: " + (f"{n_mma} HGMMA instructions" if n_mma >= 0 else "no cuobjdump, not read"),
          flush=True)
    if n_mma == 0:
        raise AssertionError("the top-k kernels' SASS holds no tensor-core MMA (HGMMA)")
    checks = {"tk_select": check_tk(torch, dev), "knn_bucket_top2": check_knn(torch, dev),
              "knn_bucket_top2_v1": check_knn_v1(torch, dev),
              "blockify_field": check_blockify(torch, dev)}
    torch.cuda.empty_cache()
    # determinism: the two default encodes must write the same stream
    default = encode_path("default", EncoderSettings(), ("tk_select", "knn_bucket_top2"),
                          same_stream=True)
    torch.cuda.empty_cache()
    im2row_v1 = encode_path(
        "im2row_v1", EncoderSettings(motion_field="im2row", knn_backend="pallas_v1"),
        ("blockify_field", "knn_bucket_top2_v1", "tk_select"))
    # the same top-k with the passes field: the im2row field must not move
    # the encode (docs/DETERMINISM.md's 0.1 dB and 2% bytes)
    passes_v1 = encode_path("passes_v1", EncoderSettings(knn_backend="pallas_v1"),
                            ("knn_bucket_top2_v1", "tk_select"), again=False)
    for ref in (passes_v1, default):
        d_db = im2row_v1["psnr_hvs_db"] - ref["psnr_hvs_db"]
        d_bytes = (im2row_v1["bytes"] - ref["bytes"]) / ref["bytes"]
        print(f"im2row_v1 - {'passes_v1' if ref is passes_v1 else 'default'}: "
              f"PSNR-HVS {d_db:+.6f} dB, bytes {d_bytes:+.4%}", flush=True)
    if (abs(im2row_v1["psnr_hvs_db"] - passes_v1["psnr_hvs_db"]) > 0.1
            or abs(im2row_v1["bytes"] - passes_v1["bytes"]) > 0.02 * passes_v1["bytes"]):
        raise AssertionError("the im2row field moves the encode off the passes field's")
    # v1 ranks otherwise than B2 (knn_on_encode_data): it may change the
    # stream, but must not lose quality
    if im2row_v1["psnr_hvs_db"] < default["psnr_hvs_db"] - 0.1:
        raise AssertionError("the im2row / pallas_v1 encode lost quality against the default")
    torch.cuda.empty_cache()
    # the other ditherer: plain tensor passes, no tk_select launch
    yliluoma2 = encode_path("yliluoma2", EncoderSettings(dithering_use_thomas_knoll=False),
                            ("knn_bucket_top2",))
    print(f"yliluoma2 - default: PSNR-HVS "
          f"{yliluoma2['psnr_hvs_db'] - default['psnr_hvs_db']:+.4f} dB, bytes "
          f"{(yliluoma2['bytes'] - default['bytes']) / default['bytes']:+.4%}", flush=True)
    for name, run in (("default", default), ("im2row_v1", im2row_v1),
                      ("yliluoma2", yliluoma2)):
        check_against_reference(name, run)
    torch.cuda.empty_cache()
    # the reference's phase B: a motion search against the reconstruction
    # in every frame but a keyframe's first, on int16 features (which move
    # the motion PSNRs that reduce thresholds, so T may differ)
    research = encode_path("research_int16",
                           EncoderSettings(phase_b_motion="research", int16_features=True),
                           ("tk_select", "knn_bucket_top2"))
    check_against_reference("research_int16", research, corpus=None)
    if research["phase_b_searches"] != research["frames"] - research["keyframes"]:
        raise AssertionError(f"phase B re-searched {research['phase_b_searches']} frames, not "
                             f"{research['frames']} less {research['keyframes']} keyframes")
    print(f"[research_int16] T={research['corpus_tiles']} (default {default['corpus_tiles']}); "
          "second encode, stage (s): research_int16 / default: "
          + " ".join(f"{k}={v:.3f}/{default['second_stage_s'][k]:.3f}"
                     for k, v in research["second_stage_s"].items()), flush=True)
    torch.cuda.empty_cache()
    # the clip over the device budget: frames and tiles stream from host
    # RAM, and past the host budget the tiles spill to a disk memmap
    print(f"host paths: the clip's {CLIP_BYTES} device bytes against budgets of "
          f"{HOST_BUDGET:.0f}", flush=True)
    host_stream = encode_path("host_stream", EncoderSettings(hbm_frames_budget=HOST_BUDGET),
                              ("tk_select", "knn_bucket_top2"), after=host_check(False))
    check_host_path("host_stream", host_stream, default)
    if not host_stream["peak_bytes"] < default["peak_bytes"]:
        raise AssertionError("the host_stream encode did not lower the device memory peak")
    torch.cuda.empty_cache()
    spill = encode_path("spill", EncoderSettings(hbm_frames_budget=HOST_BUDGET,
                                                 host_ram_budget=HOST_BUDGET),
                        ("tk_select", "knn_bucket_top2"), again=False, after=host_check(True))
    check_host_path("spill", spill, default)
    torch.cuda.empty_cache()
    wide = wide_paths(default)
    torch.cuda.empty_cache()
    epu_paths(default, wide["wide256"])
    torch.cuda.empty_cache()
    search = search_paths(default, im2row_v1)
    torch.cuda.empty_cache()
    mesh1 = mesh_nccl1(default)
    mesh4 = mesh_gloo4(mesh1)
    checks["tk_select_wide"] = check_tk_wide(
        torch, dev, {"wide256": (wide["wide256"]["corpus_tiles"], 16, 256),
                     "wide64": (wide["wide64"]["corpus_tiles"], 1024, 64)})
    for shape in checks["tk_select_wide"]["shapes"]:
        shape["launches"] = wide[shape["path"]]["launches"]["tk_select_wide"]
    # blockify's launches at each depth: the encode paths that run it
    path_at = {192: im2row_v1, 27: search["rank27_im2row"]}
    for shape in checks["blockify_field"]["shapes"]:
        shape["launches"] = path_at[shape["K"]]["launches"]["blockify_field"] \
            if shape["K"] in path_at else 0
    torch.cuda.empty_cache()
    knn_on_encode_data()
    small_clip_agreement()
    small_clip_agreement(dithering_use_thomas_knoll=False)
    small_clip_agreement(phase_b_motion="research", int16_features=True)
    small_clip_agreement(phase_b_motion="research")
    small_clip_agreement(knn_backend="ivf", ivf_min_corpus=1)
    small_clip_agreement(motion_rank_dims=48, phase_b_motion="research")
    small_clip_agreement(motion_field="im2row", motion_rank_dims=12)
    yliluoma2_dither_agreement()
    y4m_device_ingest()
    ordered_on_card()
    motion_order()
    reconstruct_order()
    profile_encode(default)
    kmodes_on_card()

    # each kernel's launches: from the encode of the path that it serves
    # (tk_select serves both; its count is the default path's)
    path_of = {"tk_select": default, "tk_select_wide": wide["wide256"],
               "knn_bucket_top2": default, "knn_bucket_top2_v1": im2row_v1,
               "blockify_field": im2row_v1}
    sources = {"tk_select": ("tk_dither.cu", "tiler_tpu/kernels/tk_dither.py:147"),
               "tk_select_wide": ("tk_dither.cu", "tiler_tpu/kernels/tk_dither.py:147"),
               "knn_bucket_top2": ("knn_topk.cu", "tiler_tpu/kernels/knn_topk.py:149"),
               "knn_bucket_top2_v1": ("knn_topk.cu", "tiler_tpu/kernels/knn_topk.py:204"),
               "blockify_field": ("blockify.cu", "tiler_tpu/kernels/blockify.py:46")}
    kernels = [
        {"name": name, "route": "cuda", "source": f"tiler_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": path_of[name]["launches"][name],
         **{key: checks[name][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")},
         # tk_select also: its issue-rate floors, the clock they were taken
         # at, and ptxas's registers and spill; tk_select_wide its figures
         # at each wide path's launch
         **{key: checks[name][key] for key in ("issue_floor_ms", "int32_floor_ms",
                                               "sm_clock_mhz", "registers",
                                               "spill_bytes", "shapes")
            if key in checks[name]},
         # its launches on the two mesh encodes (the gloo one by rank)
         "mesh_launches": {"mesh_nccl1": mesh1["launches"][name],
                           "mesh_gloo4": [c[name] for c in mesh4["launches_by_rank"]]}}
        for name, (src, replaces) in sources.items()]
    print(f"chip_smoke: every phase passed in {time.monotonic() - t_start:.1f} s", flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
