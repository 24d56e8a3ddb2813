#!/usr/bin/env python3
"""Where the time goes in a tiler_tpu_torch encode on one CUDA card.

Run from the repository root:  python3 scripts/torch_profile.py

For each path (the reference defaults, and motion_field="im2row" with
knn_backend="pallas_v1"), encodes the 1280x720x32 synthetic clip once to
warm up, then once more under torch.profiler (CPU and CUDA activities),
and prints:
- the wall time of the profiled encode and its per-stage seconds;
- device time: the sum of all kernel and copy times, and the union of
  their intervals (busy time); idle share = 1 - busy / wall;
- the kernels with the most self device time (name, calls, ms), then
  the port's own kernels (csrc/) wherever they rank.
The first line names the card and its power limit (nvidia-smi).

    python3 scripts/torch_profile.py --knn-breakdown

instead splits the corpus top-k kernels' time at one launch's shape
(8,192 cells x the encode's 116,097-tile corpus): it builds two
diagnostic copies of csrc/knn_topk.cu into build/knn_breakdown/, one
whose epilogue only folds the accumulators into one sum (the product and
the corpus stream alone) and one without the MMAs (the key packing and
top-2 alone, on accumulators the compiler cannot see), and times them
beside the kernel itself, in turns, by CUDA events.

    python3 scripts/torch_profile.py --encode-times [--root DIR]

instead encodes the clip three times on each path without the profiler
and prints every encode's wall time and per-stage seconds (the first
pays the start-up costs). --root DIR imports tiler_tpu_torch from another
checkout (an unpacked parent commit, say), so that two commits can be
timed in turns within one call on one card.

    python3 scripts/torch_profile.py --tk-wide

instead times tk_select by CUDA events at the main path's corpus (T =
116,097 tiles, P = 1,024 palettes) for S = 16 (the narrow kernel) and
S = 33, 64, 128, 256 (tk_select_wide), then at the wide256 and wide64
paths' launches (T = 36,307, P = 16, S = 256; T = 116,097, P = 1,024,
S = 64), on random tiles and palettes with every slot valid and with
90% of them valid, each beside its bound (~14 integer operations per
pixel, step and valid candidate color at the 67 TFLOP/s fp32 rate). It
first prints ptxas's report of both kernels and the issue slots a triple
of the wide scan's innermost loop, counted in the SASS (IMADs x 2, the
rest x 1), and with them the time those slots take for the valid rows
(the group padding left out) at the SM clock. With --root DIR it times
another checkout's kernels (an unpacked parent commit, say).

    python3 scripts/torch_profile.py --wide-memory [FRAMES ...] [--epu two_stage|fused]

instead encodes 1280x720xFRAMES synthetic clips (8, 16, 32, 48 and 64 frames
by default) at palette_count=16, palette_size=256, once each, and prints
for each the corpus size T, the peak of allocated device memory, the wall
time and the stage split, the peak of reserved device memory and the
caching allocator's retries (a retry frees the cache and synchronizes);
an encode that runs out of device memory is
printed with its T and the run goes on. The EPU tables grow with T
(394,752 bytes of Q and 32,768 of G a tile at S = 256), so this finds the
largest corpus that fits the card at the widest palette. With
``--epu two_stage`` or ``--epu fused`` (after the frame counts) the
encodes take epu_two_stage=True or epu_fused_fp=True.

    python3 scripts/torch_profile.py --wide-profile [--epu two_stage|fused]

instead profiles the widest palette's encode as the default mode profiles
the two paths: palette_count=16, palette_size=256 on the 1280x720x32 clip,
under the EPU table setting --epu names.

    python3 scripts/torch_profile.py --long-clip [FRAMES]

instead encodes a long synthetic clip, 1280x720x1600 by default (64 s at
25 fps, 8.85e9 device bytes: over the default hbm_frames_budget, so the
frames and tiles stream from host RAM), twice: at EncoderSettings(), and
with host_ram_budget=4e9 (the tiles spill to a disk memmap in
TILER_TPU_SPILL_DIR, by default build/spill). For each it prints the wall
time and the stage split, the peak of allocated device memory, the peak
resident host memory of the process during the encode (VmHWM, reset just
before), the corpus size T and the stream. A corpus that overflows the
int32 (tile, palette) packing raises in reconstruct: the error is printed
and the run goes on; FRAMES then sets a shorter clip.

    python3 scripts/torch_profile.py --order-cost

instead times, on the 1280x720x32 clip, the code that the CPU computes
in the JAX package's float order and the card in its own, each in both
forms on the card, in turns by CUDA events: load's mean LAB and
correlations over its chunks (rgb_to_lab's mean and pearson against
tile_mean_lab_ordered and pearson_ordered), and the EPU's quadratic
table of the default encode's corpus (_quad_rows's bmm against the JAX
package's CPU order, one FMA chain over v by ops/ordered.fma_dot, 2,048
tiles at a time). It prints how many correlations and table entries the
two forms give otherwise, whether the keyframes they decide differ,
whether the ordered load gives the CPU's bits on the card, and the
default encode's load and reconstruct seconds beside them.

    python3 scripts/torch_profile.py --mesh-gap

instead takes the mesh encode apart against the meshless ones, on the
1280x720x32 clip in an NCCL group of one rank, mesh (1, 1) ("data",
"corpus"): the default (B2), knn_backend="xla" (the exact top-k of
bf16-rounded distances), an encoder whose stages up to dither run
meshless and whose reconstruct runs on the mesh (the same palettes as
xla: only phase A's float32 ranking differs), and the whole mesh encode
(its first k-means sharded too). It prints each one's PSNR-HVS, bytes,
final tile count and reconstruct seconds (after one warm-up encode of
each), and the gaps; then profiles the mesh encode as the default mode
profiles a path.
"""
import ctypes
import os
import resource
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if "--root" in sys.argv[1:]:
    ROOT = os.path.abspath(sys.argv[sys.argv.index("--root") + 1])
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from tiler_tpu_torch.config import EncoderSettings  # noqa: E402
from tiler_tpu_torch.pipeline.encoder import Encoder  # noqa: E402
from tiler_tpu_torch.utils.clips import synthetic_clip  # noqa: E402

PATHS = {
    "default": EncoderSettings(),
    "im2row_v1": EncoderSettings(motion_field="im2row", knn_backend="pallas_v1"),
}


# the device functions of tiler_tpu_torch/csrc
OWN_KERNELS = ("knn_top2_wgmma", "tk_select_kernel", "tk_select_wide_kernel",
               "blockify_kernel")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _busy_us(prof):
    """(sum, union) of the device intervals of the trace, in us."""
    spans = []
    for evt in prof.events():
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            spans.append((evt.time_range.start, evt.time_range.end))
    spans.sort()
    total = sum(e - s for s, e in spans)
    union, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                union += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        union += cur_e - cur_s
    return total, union


def profile_path(name, settings, clip, top=12, mesh=None):
    from torch.profiler import ProfilerActivity, profile

    out = os.path.join(ROOT, "build", "torch_profile", f"{name}.gtm")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    Encoder(settings, device="cuda", log=None, mesh=mesh).run_all(clip, fps=25.0, out_path=out)
    enc = Encoder(settings, device="cuda", log=None, mesh=mesh)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        enc.run_all(clip, fps=25.0, out_path=out)
        wall = time.monotonic() - t0
    total, busy = _busy_us(prof)
    print(f"[{name}] profiled encode {wall:.3f} s; stages "
          + " ".join(f"{k}={v:.3f}" for k, v in enc.timings.items()), flush=True)
    print(f"[{name}] device time {total / 1e6:.3f} s summed, {busy / 1e6:.3f} s busy; "
          f"idle share {1 - busy / 1e6 / wall:.3f}", flush=True)
    rows = sorted(prof.key_averages(), key=_device_us, reverse=True)
    # the top kernels, then the port's own kernels wherever they rank
    own = [r for r in rows[top:] if any(k in r.key for k in OWN_KERNELS)]
    for r in rows[:top] + own:
        print(f"[{name}]   {_device_us(r) / 1e3:10.3f} ms  {r.count:7d} calls  {r.key[:90]}",
              flush=True)


def knn_breakdown(N=8192, T=116097, reps=20, rounds=2):
    from tiler_tpu_torch.kernels import _build
    from tiler_tpu_torch.kernels import knn_topk as kn

    csrc = os.path.join(ROOT, "tiler_tpu_torch", "csrc")
    out = os.path.join(ROOT, "build", "knn_breakdown")
    os.makedirs(out, exist_ok=True)
    src = open(os.path.join(csrc, "knn_topk.cu")).read()
    for name in os.listdir(csrc):
        if name.endswith((".cuh", ".h")):
            with open(os.path.join(csrc, name)) as f, open(os.path.join(out, name), "w") as g:
                g.write(f.read())
    e0 = src.index("#pragma unroll\n      for (int j = 0; j < 16; ++j) {")
    e1 = src.index("      if (t == kTilesPerBucket - 1) {")
    fold = ("      {\n        float sum = 0.f;\n#pragma unroll\n"
            "        for (int r = 0; r < 64; ++r) sum += acc0[r] + acc1[r];\n"
            "        m1[0] = min(m1[0], __float_as_int(sum));\n      }\n")
    variants = {"kernel": src, "product and stream": src[:e0] + fold + src[e1:],
                "epilogue": re.sub(r".*wgmma_m64n128k16_bf16_tb\(acc.*\n", "", src)}
    builds = {}
    for i, text in enumerate(variants.values()):
        cu = os.path.join(out, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        builds[i] = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                                      os.path.join(out, f"v{i}.so"), cu],
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for (name, _), (i, proc) in zip(variants.items(), builds.items()):
        _, err = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} copy:\n{err}")
        lib = ctypes.CDLL(os.path.join(out, f"v{i}.so"))
        for fn, argtypes in _build._SIGNATURES:
            if fn.startswith("knn"):
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda")
    Tp = -(-T // kn.TP_ALIGN) * kn.TP_ALIGN
    gen = torch.Generator(device=dev).manual_seed(2)
    feats = torch.randn(N, 192, device=dev, generator=gen) * 50
    ds = torch.randn(T, 192, device=dev, generator=gen) * 50
    fa, dsTa = kn.fold_cells(feats, N), kn.knn_prep2(ds, Tp)
    fb = feats.to(torch.bfloat16)
    dsT, d2 = kn.knn_prep_v1(ds, Tp)
    k1 = torch.empty(Tp // kn.TB, N, dtype=torch.int32, device=dev)
    k2 = torch.empty_like(k1)
    stream = torch.cuda.current_stream().cuda_stream
    calls = {
        "B2": lambda lib: lib.knn_bucket_top2_launch(
            fa.data_ptr(), dsTa.data_ptr(), k1.data_ptr(), k2.data_ptr(), N, Tp, stream),
        "v1": lambda lib: lib.knn_bucket_top2_v1_launch(
            fb.data_ptr(), dsT.data_ptr(), d2.data_ptr(), k1.data_ptr(), k2.data_ptr(),
            N, Tp, stream),
    }
    for rnd in range(rounds):
        for kname, call in calls.items():
            times = []
            for name, lib in libs.items():
                if call(lib) != 0:
                    raise RuntimeError(f"{kname} {name}: launch refused")
                torch.cuda.synchronize()
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(reps):
                    call(lib)
                b.record()
                torch.cuda.synchronize()
                times.append(f"{name} {a.elapsed_time(b) / reps:.4f} ms")
            print(f"[knn breakdown, round {rnd}] {kname} at {N} x {T}: " + ", ".join(times),
                  flush=True)


def _turns_ms(fns, rounds=3):
    """{name: [ms of each round]} of the calls in ``fns``, in turns (the
    order reversed every other round), each timed by CUDA events after a
    warm-up call."""
    times = {name: [] for name in fns}
    for fn in fns.values():
        fn()
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fns[name]()
            b.record()
            torch.cuda.synchronize()
            times[name].append(a.elapsed_time(b))
    return times


def order_cost(clip, device="cuda"):
    import numpy as np

    from tiler_tpu_torch.ops.color import rgb_to_lab, tile_mean_lab_ordered
    from tiler_tpu_torch.ops.dct import DCT_WEIGHTS
    from tiler_tpu_torch.ops.metrics import pearson, pearson_ordered
    from tiler_tpu_torch.ops.ordered import fma_dot
    from tiler_tpu_torch.pipeline import load as ld
    from tiler_tpu_torch.pipeline import reconstruct as rc

    settings = EncoderSettings()
    F, H, W, _ = clip.shape
    step = ld._frames_per_chunk(H, W)
    frames = torch.from_numpy(clip).to(device)

    def tiles(fr):  # _load_chunk's tiles, one frame of overlap a chunk
        t = fr.reshape(len(fr), H // 8, 8, W // 8, 8, 3).permute(0, 1, 3, 2, 4, 5)
        return t.reshape(len(fr), -1, 8, 8, 3).float()

    chunks = [tiles(frames[max(0, s - 1):s + step]) for s in range(0, F, step)]

    def corr(ordered, chunks=chunks):
        out = []
        for i, tf in enumerate(chunks):
            m = (tile_mean_lab_ordered(tf) if ordered
                 else rgb_to_lab(tf).mean(dim=(2, 3))).reshape(len(tf), -1)
            c = (pearson_ordered if ordered else pearson)(m[:-1], m[1:])
            out.append(torch.cat([torch.ones(1, device=c.device), c]) if i == 0 else c)
        return torch.cat(out)

    times = _turns_ms({"plain": lambda: corr(False), "ordered": lambda: corr(True)})
    print(f"[order cost] load's mean LAB and correlations, {F} frames in {len(chunks)} "
          "chunks, ms a load in turns: "
          + "; ".join(f"{k} " + ", ".join(f"{v:.3f}" for v in vs) for k, vs in times.items()),
          flush=True)
    cp, co = corr(False).cpu(), corr(True).cpu()
    cc = corr(True, [t.cpu() for t in chunks])
    kf = [ld._detect_keyframes(F, c.numpy(), 25.0, settings, None)[0] for c in (cp, co)]
    print(f"[order cost] correlations: {int((cp != co).sum())} of {F} differ between the "
          f"forms on the card (max |diff| {float((cp - co).abs().max()):.3e}); keyframes "
          f"{'equal' if np.array_equal(*kf) else 'differ'} ({int(kf[0].sum())}, "
          f"{int(kf[1].sum())}); the ordered form on the card = CPU bit for bit: "
          f"{torch.equal(co.view(torch.int32), cc.view(torch.int32))}", flush=True)
    del chunks, frames

    enc = Encoder(settings, device=device, log=None)
    enc.run_all(clip, fps=25.0, out_path=os.path.join(ROOT, "build", "order_cost.gtm"))
    enc = Encoder(settings, device=device, log=None)
    enc.load_frames(clip, 25.0).predict_motion().reduce().prepare_palettes().dither()
    pp, S = enc.state.corpus_pal_pixels, settings.palette_size
    enc.reconstruct()
    print(f"[order cost] the default encode's stages: "
          + " ".join(f"{k}={v:.3f}" for k, v in enc.timings.items()), flush=True)
    T = pp.shape[0]
    w = torch.as_tensor(DCT_WEIGHTS, dtype=torch.float32, device=device)
    wf2 = (w * w).permute(1, 2, 0).reshape(64, 3)
    tri = rc._triangle(S, device)
    chunk = min(rc.IDCT_CHUNK, rc._quad_chunk(S))
    gs = [rc._indicator_dcts(pp[i:i + chunk], S).to(torch.bfloat16).float()
          for i in range(0, T, chunk)]

    def chain(g, tri_i, tri_j, dbl):
        return torch.stack([fma_dot((g * wf2[:, c][None, :, None])[:, :, tri_i].transpose(1, 2),
                                    g[:, :, tri_j].transpose(1, 2)) * dbl for c in range(3)],
                           dim=1).reshape(g.shape[0], -1)

    def quad(ordered):
        if ordered:
            return [chain(t, *tri) for g in gs for t in g.split(2048)]
        return [rc._quad_rows(g, wf2, *tri) for g in gs]

    times = _turns_ms({"plain": lambda: quad(False), "ordered": lambda: quad(True)}, rounds=2)
    print(f"[order cost] the EPU's quadratic table, T = {T}, S = {S}, ms in turns: "
          + "; ".join(f"{k} " + ", ".join(f"{v:.3f}" for v in vs) for k, vs in times.items()),
          flush=True)
    qp, qo = torch.cat(quad(False)), torch.cat(quad(True))
    print(f"[order cost] quadratic table: {int((qp != qo).sum())} of {qp.numel()} entries "
          "differ between the forms on the card", flush=True)


def encode_times(clip, reps=3):
    out = os.path.join(ROOT, "build", "torch_profile")
    os.makedirs(out, exist_ok=True)
    for name, settings in PATHS.items():
        for r in range(reps):
            enc = Encoder(settings, device="cuda", log=None)
            t0 = time.monotonic()
            enc.run_all(clip, fps=25.0, out_path=os.path.join(out, f"{name}.gtm"))
            wall = time.monotonic() - t0
            print(f"[{name}] encode {r} of {ROOT}: {wall:.3f} s; "
                  + " ".join(f"{k}={v:.3f}" for k, v in enc.timings.items())
                  + f"; PSNR-HVS {enc.state.total_psnr:.4f} dB, {enc.stats.total_bytes} bytes",
                  flush=True)


def sass_loop_slots(so, kernel="tk_select_wide_kernel", marker="FFMA.RZ", triples=32):
    """The innermost loop of ``kernel`` in the library's SASS (cuobjdump
    -sass): the smallest span between a backward branch and its target
    that holds ``marker`` at least ``triples / 2`` times (the wide scan's
    group of 16 rows for two pixels: 32 FFMA.RZ). Returns (issue slots a
    triple at IMADs x 2 and every other instruction x 1, {opcode: count}),
    None without cuobjdump; raises if the kernel has no such loop."""
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    body = next(part for part in text.split("Function : ")[1:]
                if part.split()[0].find(kernel) >= 0)
    ins, labels = [], {}
    for line in body.splitlines():
        lab = re.match(r"\s*\.(L_x_\d+):", line)
        if lab:
            labels[lab.group(1)] = len(ins)
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            ins.append((int(m.group(1), 16), m.group(2).strip()))
    at = {addr: i for i, (addr, _) in enumerate(ins)}
    loops = []
    for i, (_, op) in enumerate(ins):
        if not re.search(r"(^|\s)BRA(\.\S+)?\s", op):
            continue
        lab = re.search(r"\.(L_x_\d+)", op)
        hexa = re.search(r"BRA\S*\s+(?:\S+,\s*)?0x([0-9a-f]+)", op)
        j = labels.get(lab.group(1)) if lab else (at.get(int(hexa.group(1), 16)) if hexa
                                                   else None)
        if j is not None and j <= i:
            loops.append(ins[j:i + 1])
    hits = [lp for lp in loops if sum(marker in op for _, op in lp) >= triples // 2]
    if not hits:
        raise RuntimeError(f"no loop of {kernel} holds {triples // 2} {marker}")
    ops = {}
    for _, op in min(hits, key=len):
        name = op.split()[1] if op.startswith("@") else op.split()[0]
        ops[name] = ops.get(name, 0) + 1
    slots = sum(n * (2 if name.startswith("IMAD") else 1) for name, n in ops.items())
    return slots / triples, dict(sorted(ops.items(), key=lambda kv: -kv[1]))


def tk_wide(T=116097, P=1024, reps=5):
    from tiler_tpu_torch.kernels import _build
    from tiler_tpu_torch.kernels import tk_dither as tk

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs

    so = _build.build(verbose=True)
    for r in _build.kernel_resources("tk_select"):
        print(f"[tk wide] ptxas {r}", flush=True)
    try:
        sass = sass_loop_slots(so)
        print("[tk wide] SASS: " + (f"the wide scan's group loop takes {sass[0]:.3f} issue "
                                    f"slots a triple (IMAD x 2); opcodes {sass[1]}" if sass
                                    else "no cuobjdump"), flush=True)
    except RuntimeError as e:  # another design (an older checkout under --root)
        sass = None
        print(f"[tk wide] SASS: {e}", flush=True)
    dev = torch.device("cuda")
    launches = [(T, P, S) for S in (16, 33, 64, 128, 256)]
    # the two wide paths' launches in chip_smoke.py: wide256 and wide64
    launches += [(36307, 16, 256), (116097, 1024, 64)]
    for T, P, S in launches:
        pix, mirror, pidx, _ = cs._tk_random(torch, dev, T, P, S, S)
        for valid in (1.0, 0.9):
            table = cs._tk_random(torch, dev, 1, P, S, S, valid=valid)[3]
            args = (pix, mirror, pidx, table)
            ms = cs.cuda_ms(lambda: tk.tk_select(*args), reps)
            clock = cs.sm_clock_hz()
            bms, by, triples = cs._tk_bound(tk, *args)
            kname = "tk_select" if S <= tk.NARROW_S else "tk_select_wide"
            floor = (f"; at {clock / 1e6:.0f} MHz the SASS's slots take "
                     f"{1e3 * sass[0] * triples / (128 * cs.SM_COUNT * clock):.3f} ms for "
                     "the valid rows" if sass and S > tk.NARROW_S else "")
            print(f"[tk wide] {kname} T={T} P={P} S={S}, {valid:.0%} of the slots valid: "
                  f"{ms:.3f} ms, bound {bms:.3f} ms ({by}), {bms / ms:.1%} of the bound{floor}",
                  flush=True)
        del pix, mirror, pidx, table, args
        torch.cuda.empty_cache()


# --epu: the EPU table settings a --wide-memory run can take
EPU = {"default": {}, "two_stage": {"epu_two_stage": True}, "fused": {"epu_fused_fp": True}}


def wide_memory(frames=(8, 16, 32, 48, 64), H=720, W=1280, epu="default"):
    out = os.path.join(ROOT, "build", "torch_profile")
    os.makedirs(out, exist_ok=True)
    settings = EncoderSettings(palette_count=16, palette_size=256, **EPU[epu])
    print(f"[wide memory] EPU tables: {epu}", flush=True)
    for F in frames:
        clip = synthetic_clip(F, H, W)
        enc = Encoder(settings, device="cuda", log=None)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.reset_accumulated_memory_stats()
        t0 = time.monotonic()
        try:
            enc.run_all(clip, fps=25.0, out_path=os.path.join(out, f"wide256_{F}.gtm"))
        except torch.cuda.OutOfMemoryError as e:
            print(f"[wide memory] {W}x{H}x{F}: out of device memory after "
                  f"{time.monotonic() - t0:.1f} s, T={len(enc.state.corpus_rgb)}, "
                  f"stages {enc.timings}, peak allocated {torch.cuda.max_memory_allocated()} "
                  f"bytes: {str(e).splitlines()[0]}", flush=True)
        else:
            print(f"[wide memory] {W}x{H}x{F}: T={enc.step_stats['corpus_tiles']}, peak "
                  f"device memory allocated {torch.cuda.max_memory_allocated()} bytes "
                  f"(reserved {torch.cuda.max_memory_reserved()}, allocator retries "
                  f"{torch.cuda.memory_stats().get('num_alloc_retries', 0)}), "
                  f"encode {time.monotonic() - t0:.3f} s; stages "
                  + " ".join(f"{k}={v:.3f}" for k, v in enc.timings.items())
                  + f"; PSNR-HVS {enc.state.total_psnr:.4f} dB, {enc.stats.total_bytes} bytes",
                  flush=True)
        del enc, clip
        torch.cuda.empty_cache()


def _host_peak_bytes(reset=False):
    """The process's peak resident memory since the last reset (Linux's
    VmHWM, which writing 5 to clear_refs resets), or ru_maxrss, the peak
    over the process's whole life, where that is unavailable."""
    try:
        if reset:
            with open("/proc/self/clear_refs", "w") as f:
                f.write("5")
            return None
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return 1024 * int(line.split()[1])
    except OSError:
        pass
    return None if reset else 1024 * resource.getrusage(resource.RUSAGE_SELF).ru_maxrss


def long_clip(F=1600, H=720, W=1280):
    from tiler_tpu_torch.pipeline.load import clip_bytes

    os.environ.setdefault("TILER_TPU_SPILL_DIR", os.path.join(ROOT, "build", "spill"))
    os.makedirs(os.environ["TILER_TPU_SPILL_DIR"], exist_ok=True)
    out = os.path.join(ROOT, "build", "torch_profile")
    os.makedirs(out, exist_ok=True)
    t0 = time.monotonic()
    clip = synthetic_clip(F, H, W)
    print(f"[long clip] {W}x{H}x{F}: {clip_bytes(F, H, W)} device bytes, made in "
          f"{time.monotonic() - t0:.1f} s; host RSS now {_host_peak_bytes()} bytes", flush=True)
    for name, settings in (("host", EncoderSettings()),
                           ("spill", EncoderSettings(host_ram_budget=4e9))):
        enc = Encoder(settings, device="cuda", log=lambda *a: print(*a, flush=True))
        torch.cuda.reset_peak_memory_stats()
        _host_peak_bytes(reset=True)
        t0 = time.monotonic()
        try:
            enc.run_all(clip, fps=25.0, out_path=os.path.join(out, f"long_{name}.gtm"))
        except ValueError as e:
            print(f"[long clip {name}] failed after {time.monotonic() - t0:.1f} s "
                  f"(stages {enc.timings}): {e}", flush=True)
            continue
        wall = time.monotonic() - t0
        st = enc.state
        print(f"[long clip {name}] encode {wall:.3f} s; stages "
              + " ".join(f"{k}={v:.3f}" for k, v in enc.timings.items())
              + f"; frames {type(st.frames_rgb).__name__}, tiles "
              f"{type(st.tiles_canon).__name__}; peak device memory allocated "
              f"{torch.cuda.max_memory_allocated()} bytes, peak host RSS "
              f"{_host_peak_bytes()} bytes; T={enc.step_stats['corpus_tiles']}, "
              f"{len(st.keyframes)} keyframes, PSNR-HVS {st.total_psnr:.4f} dB, "
              f"{enc.stats.total_bytes} bytes", flush=True)
        del enc, st
        torch.cuda.empty_cache()


def mesh_gap(clip, device="cuda"):
    import torch.distributed as dist

    from tiler_tpu_torch.parallel.mesh import BACKENDS, free_port, make_mesh

    out = os.path.join(ROOT, "build", "torch_profile", "mesh_gap.gtm")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    dist.init_process_group(BACKENDS[device], init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, ("data", "corpus"), device_type=device)

        def encode(settings, mesh_from=None):
            """Meshless, or on the mesh from "reconstruct" or "load" on."""
            enc = Encoder(settings, device=device, log=None,
                          mesh=mesh if mesh_from == "load" else None)
            enc.load_frames(clip, 25.0).predict_motion().reduce().prepare_palettes().dither()
            enc.mesh = mesh if mesh_from else None
            return enc.reconstruct().reindex().save(out)

        runs = {"default": lambda: encode(EncoderSettings()),
                "xla": lambda: encode(EncoderSettings(knn_backend="xla")),
                "mesh_reconstruct": lambda: encode(EncoderSettings(), "reconstruct"),
                "mesh": lambda: encode(EncoderSettings(), "load")}
        got = {}
        for name, run in runs.items():
            run()  # warm-up
            enc = run()
            got[name] = (enc.state.total_psnr, enc.stats.total_bytes,
                         len(enc.state.corpus_pal_pixels), enc.timings["reconstruct"])
            print(f"[mesh_gap] {name}: PSNR-HVS {got[name][0]:.4f} dB, {got[name][1]} bytes, "
                  f"{got[name][2]} final tiles, reconstruct {got[name][3]:.3f} s", flush=True)
        for a, b in (("mesh_reconstruct", "xla"), ("xla", "default"), ("mesh", "default"),
                     ("mesh", "mesh_reconstruct")):
            print(f"[mesh_gap] {a} - {b}: PSNR-HVS {got[a][0] - got[b][0]:+.4f} dB, bytes "
                  f"{(got[a][1] - got[b][1]) / got[b][1]:+.4%}, final tiles "
                  f"{got[a][2] - got[b][2]:+d}", flush=True)
        if device == "cuda":
            profile_path("mesh_nccl1", EncoderSettings(), clip, mesh=mesh)
    finally:
        dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA card is visible", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.splitlines()[0]
    print(f"card: {card}", flush=True)
    if "--knn-breakdown" in sys.argv[1:]:
        knn_breakdown()
        return 0
    if "--tk-wide" in sys.argv[1:]:
        tk_wide()
        return 0
    args = sys.argv[1:]
    epu = args[args.index("--epu") + 1] if "--epu" in args else "default"
    if epu not in EPU:
        print(f"torch_profile: --epu takes one of {sorted(EPU)}", file=sys.stderr)
        return 2
    if "--wide-memory" in args:
        rest = args[args.index("--wide-memory") + 1:]
        frames = [int(a) for a in rest[:rest.index("--epu")] if a.isdigit()] if "--epu" in rest \
            else [int(a) for a in rest if a.isdigit()]
        wide_memory(*([tuple(frames)] if frames else []), epu=epu)
        return 0
    if "--long-clip" in sys.argv[1:]:
        rest = sys.argv[sys.argv.index("--long-clip") + 1:]
        long_clip(int(rest[0]) if rest and rest[0].isdigit() else 1600)
        return 0
    clip = synthetic_clip(32, 720, 1280)
    if "--wide-profile" in sys.argv[1:]:
        profile_path(f"wide256_{epu}", EncoderSettings(palette_count=16, palette_size=256,
                                                       **EPU[epu]), clip)
        return 0
    if "--encode-times" in sys.argv[1:]:
        encode_times(clip)
        return 0
    if "--order-cost" in sys.argv[1:]:
        order_cost(clip)
        return 0
    if "--mesh-gap" in sys.argv[1:]:
        mesh_gap(clip)
        return 0
    for name, settings in PATHS.items():
        profile_path(name, settings, clip)
    return 0


if __name__ == "__main__":
    sys.exit(main())
