"""Encoder facade: runs the 8 pipeline steps on one device, or on every
rank of a device mesh.

Counterpart of ``tiler_tpu/pipeline/encoder.py``; it runs on ``cuda``
unless the caller names another device. With a mesh
(``parallel/mesh.py``) every rank of the process group runs the same
encoder on the same clip and settings: predict_motion, prepare_palettes
and reconstruct shard their work over the mesh and gather it, the other
steps run whole on each rank, and after each step every rank holds the
same state. Rank 0 alone writes the stream and checkpoints; the others
receive its stream statistics, so ``Encoder.stats`` is the same on every
rank. Checkpoints use the JAX
package's format, a pickle of the numpy ``EncodeState`` and the settings,
written with the port's own classes; :meth:`Encoder.load_checkpoint` also
reads the JAX package's checkpoints by mapping its class names onto the
port's copies (:class:`_CheckpointUnpickler`), without importing it. A
disk-spilled (memmap) field is written to a sidecar ``<ckpt>.<field>.npy``
and mapped again on load, in both packages' format. With
``TILER_TPU_PROFILE=dir`` set, each of the six steps from predict_motion
to reindex runs under ``torch.profiler`` and leaves a Chrome trace in
``dir/<step>.json`` (``utils/progress.trace_step``).
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import PSYVIS_MODES, EncoderSettings
from ..models import state as state_mod
from ..models.convert import state_from_numpy, state_to_numpy
from ..models.state import EncodeState
from ..parallel import mesh as mesh_mod
from ..utils.progress import trace_step
from . import dither as dither_mod
from . import load as load_mod
from . import palettes as palettes_mod
from . import predict as predict_mod
from . import reconstruct as reconstruct_mod
from . import reduce as reduce_mod
from . import reindex as reindex_mod
from . import save as save_mod

STEPS = (
    "load",
    "predict_motion",
    "reduce",
    "prepare_palettes",
    "dither",
    "reconstruct",
    "reindex",
    "save",
)


class GTMReloadError(Exception):
    """Stream/video mismatch on re-import (ETilingEncoderGTMReloadError,
    tilingencoder.pas:112, raised :5030)."""


class _SpilledRef:
    """Checkpoint placeholder for a disk-spilled (memmap) state field;
    names the sidecar .npy written next to the pickle."""

    def __init__(self, name: str):
        self.name = name


# the JAX package's pickled class names -> the port's copies
_CHECKPOINT_CLASSES = {
    ("tiler_tpu.config", "EncoderSettings"): EncoderSettings,
    ("tiler_tpu.pipeline.encoder", "_SpilledRef"): _SpilledRef,
    **{("tiler_tpu.models.state", name): getattr(state_mod, name)
       for name in ("EncodeState", "KeyFrameInfo", "TileMapSoA")},
}


def _lowfreq_dims_ok(dims: int) -> bool:
    """dims = 3 r^2 with 1 <= r <= 8: each channel's r x r low-frequency
    DCT block (the two-stage EPU's and the motion ranking's depths)."""
    return any(dims == 3 * r * r for r in range(1, 9))


def check_settings(s: EncoderSettings):
    """Raise ValueError naming the first setting the port does not run."""
    rules = (
        ("knn_backend", s.knn_backend not in ("pallas", "pallas_v1", "xla", "ivf"),
         "the top-k backends are 'pallas', 'pallas_v1', 'xla' and 'ivf'"),
        ("ivf_probes", s.knn_backend == "ivf" and s.ivf_probes < 1,
         "the IVF search probes at least one block a cell"),
        ("epu_stage1_dims", s.epu_two_stage and not _lowfreq_dims_ok(s.epu_stage1_dims),
         "the two-stage EPU ranks on the low-frequency r x r block of each "
         "channel's 8 x 8 DCT, so its dims are 3*r^2 with 1 <= r <= 8"),
        ("epu_stage1_m", s.epu_two_stage and s.epu_stage1_m < 1,
         "the two-stage EPU re-ranks at least one pair a cell exactly"),
        ("motion_field", s.motion_field not in ("passes", "im2row"),
         "only the 'passes' and 'im2row' window fields exist"),
        ("motion_rank_dims", not _lowfreq_dims_ok(s.motion_rank_dims),
         "motion candidates rank on the low-frequency r x r block of each "
         "channel's 8 x 8 DCT, so the dims are 3*r^2 with 1 <= r <= 8"),
        ("phase_b_motion", s.phase_b_motion not in ("reuse", "research"),
         "only the 'reuse' and 'research' phase-B modes exist"),
        ("dithering_yliluoma2_mixed_colors",
         not 1 <= s.dithering_yliluoma2_mixed_colors <= 16,
         "Yliluoma2 plans hold 1..16 mixed colors (a plan of up to twice "
         "that is ranked by the 6-bit Bayer value)"),
        ("dithering_mode", s.dithering_mode not in PSYVIS_MODES,
         f"the psy-vis modes are {PSYVIS_MODES}"),
        ("color_quantizer", s.color_quantizer not in ("kmeans", "mediancut"),
         "the color quantizers are 'kmeans' and 'mediancut'"),
        ("scaling", not s.scaling > 0, "the scaling factor must be positive"),
        ("palette_size", not 1 <= s.palette_size <= 256,
         "GTM writes a palette slot as a byte, so a palette holds 1..256 colors"),
    )
    for flag, off_slice, why in rules:
        if off_slice:
            raise ValueError(f"{flag}={getattr(s, flag)!r}: {why} in tiler_tpu_torch")


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def resolve_mesh(mesh, device=None):
    """``"auto"``: a one-axis ("corpus") mesh of every rank when the
    process group (initialized here from torchrun's environment if it is
    not yet) has more than one, else None, as the JAX package does on one
    device; the mesh's devices are of ``device``'s type (default cuda).
    A DeviceMesh or None is returned as it is; anything else raises."""
    from torch.distributed.device_mesh import DeviceMesh

    if mesh is None or isinstance(mesh, DeviceMesh):
        return mesh
    if not (isinstance(mesh, str) and mesh == "auto"):
        raise ValueError(f"mesh={mesh!r}: a DeviceMesh (parallel.make_mesh), 'auto' or None")
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world <= 1:
        return None
    device_type = torch.device(device).type if device is not None else "cuda"
    mesh_mod.init_process_group(device_type)
    return mesh_mod.make_mesh(device_type=device_type)


class Encoder:
    """Drives an EncodeState through the pipeline steps on ``device``.

    ``mesh``: a ``DeviceMesh`` (``parallel.make_mesh``) spanning every rank
    of the process group, or ``"auto"`` (:func:`resolve_mesh`); every rank
    constructs its Encoder and runs the same steps. ``device`` defaults to
    ``cuda``, and with a mesh to this rank's device on it."""

    def __init__(self, settings: Optional[EncoderSettings] = None, log=print,
                 mesh=None, *, device=None):
        settings = settings or EncoderSettings()
        if not isinstance(settings, EncoderSettings):
            # an equal dataclass (the JAX package's): keep the port's own
            # class, so checkpoints name only the port's classes
            settings = EncoderSettings(**dataclasses.asdict(settings))
        self.settings = settings
        check_settings(self.settings)
        self.mesh = resolve_mesh(mesh, device)
        if device is None:
            device = "cuda" if self.mesh is None else mesh_mod.rank_device(self.mesh.device_type)
        self.device = torch.device(device)
        self.state = EncodeState()
        self.log = log or (lambda *_: None)
        self.timings = {}
        self.stats = None
        self.step_stats = {}

    # --- ingest -----------------------------------------------------------
    def load_frames(self, frames_rgb, fps: float = 24.0, manual_keyframes=None,
                    resample_to=None):
        """frames_rgb: [F, H, W, 3] uint8 RGB or an io.video.PlanarClip;
        resample_to=(H, W) resamples on the device (ops/resample.py)."""
        t0 = self._start()
        self.state = load_mod.load(EncodeState(), frames_rgb, fps, self.settings,
                                   manual_keyframes=manual_keyframes,
                                   resample_to=resample_to, device=self.device, log=self.log)
        self._stamp("load", t0)
        self.log(f"{self.state.n_frames} frames, {self.state.width}x"
                 f"{self.state.height} @ {fps:.3f} fps")
        return self

    def load_video(self, path: Optional[str] = None):
        """Ingest ``path``. With ``device_resample`` (the default) a
        natively planar source (y4m, 4:2:0 video) ships its raw planes
        and an RGB source with ``scaling != 1`` its source-size frames,
        and the device converts and resamples; which route a source takes
        follows from its type, and a failure on that route raises.
        Otherwise the host converts and scales (PIL Lanczos). Past
        ``host_ram_budget`` the decoded frames go to a disk memmap."""
        from ..io import video

        s = self.settings
        path = path or s.input_file_name
        count = s.frame_count or None
        spill = int(s.host_ram_budget)
        scale = lambda n: max(1, round(n * s.scaling))  # noqa: E731
        if s.device_resample:
            clip = video.load_video_planar(path, s.start_frame, count, spill)
            if clip is not None:
                rt = (scale(clip.src_h), scale(clip.src_w)) if s.scaling != 1.0 else None
                manual = video.manual_keyframes(path, s.start_frame, clip.n_frames)
                return self.load_frames(clip, clip.fps, manual_keyframes=manual,
                                        resample_to=rt)
            if s.scaling != 1.0:
                frames, fps = video.load_video(path, start_frame=s.start_frame,
                                               frame_count=count, scaling=1.0,
                                               spill_budget=spill)
                manual = video.manual_keyframes(path, s.start_frame, len(frames))
                return self.load_frames(
                    frames, fps, manual_keyframes=manual,
                    resample_to=(scale(frames.shape[1]), scale(frames.shape[2])))
        frames, fps = video.load_video(path, start_frame=s.start_frame,
                                       frame_count=count, scaling=s.scaling,
                                       spill_budget=spill)
        manual = video.manual_keyframes(path, s.start_frame, len(frames))
        return self.load_frames(frames, fps, manual_keyframes=manual)

    # --- steps ------------------------------------------------------------
    def predict_motion(self):
        t0 = self._start()
        with trace_step("predict_motion", device=self.device):
            predict_mod.predict_motion(self.state, self.settings, self.mesh, device=self.device)
        self._stamp("predict_motion", t0)
        self.log(f"{len(self.state.keyframes)} keyframes")
        return self

    def reduce(self):
        t0 = self._start()
        with trace_step("reduce", device=self.device):
            reduce_mod.reduce_tiles(self.state, self.settings, device=self.device)
        self._stamp("reduce", t0)
        self.log(f"corpus: {len(self.state.corpus_rgb)} tiles")
        return self

    def prepare_palettes(self):
        t0 = self._start()
        with trace_step("prepare_palettes", device=self.device):
            palettes_mod.prepare_palettes(self.state, self.settings, stats=self.step_stats,
                                          mesh=self.mesh)
        self._stamp("prepare_palettes", t0)
        inner = self.step_stats["two_opt_inner"]
        self.log(f"2-opt: {sum(inner)} inner iterations in {len(inner)} rounds {inner}")
        return self

    def dither(self):
        t0 = self._start()
        with trace_step("dither", device=self.device):
            dither_mod.dither(self.state, self.settings, stats=self.step_stats)
        self._stamp("dither", t0)
        # the step's device counters, read once _stamp has waited for it
        stats = self.step_stats
        if "yl2_candidates" in stats:
            for key in ("dither_colors", "yl2_candidates"):
                stats[key] = int(stats[key])
            self.log(f"dither: {stats['yl2_candidates']} Yliluoma2 trials over "
                     f"{stats['dither_colors']} valid colors of the pixels' palettes")
        return self

    def reconstruct(self):
        t0 = self._start()
        with trace_step("reconstruct", device=self.device):
            reconstruct_mod.reconstruct(self.state, self.settings, stats=self.step_stats,
                                        mesh=self.mesh)
        self._stamp("reconstruct", t0)
        self.log(f"phase A: {self.step_stats['corpus_tiles']} corpus tiles, "
                 f"{self.step_stats['epu_table_cells']} cells ranked through the Q.R table")
        for kf in self.state.keyframes:
            self.log(f"KF {kf.start_frame:6d} PSNR-HVS: {self.state.kf_psnr[kf.index]:10.6f} (by tile)")
        self.log(f"All {self.state.n_frames:6d} PSNR-HVS: {self.state.total_psnr:10.6f} (by tile)")
        return self

    def reindex(self):
        t0 = self._start()
        with trace_step("reindex", device=self.device):
            reindex_mod.reindex(self.state, self.settings)
        self._stamp("reindex", t0)
        self.log(f"reindex: {len(self.state.corpus_pal_pixels)} final tiles")
        return self

    @property
    def writes(self) -> bool:
        """Whether this rank writes files: without a mesh, or rank 0."""
        return self.mesh is None or dist.get_rank() == 0

    def save(self, path: Optional[str] = None):
        """Write the stream (rank 0 of a mesh; the others receive its
        statistics)."""
        t0 = self._start()
        stats = [None]
        if self.writes:
            stats[0] = save_mod.save(state_to_numpy(self.state), self.settings,
                                     path or self.settings.output_file_name)
        if self.mesh is not None:
            dist.broadcast_object_list(stats, src=0)
        self.stats = stats[0]
        self._stamp("save", t0)
        s = self.stats
        kbps = s.total_bytes / 1024.0 * 8.0 / max(1, s.frame_count) * self.state.fps
        self.log(f"written {s.total_bytes} bytes ({kbps:.2f} kbps)")
        return self

    def run_all(self, frames_rgb=None, fps: float = 24.0, out_path=None):
        if frames_rgb is not None:
            self.load_frames(frames_rgb, fps)
        elif self.state.n_frames == 0:
            self.load_video()
        return (
            self.predict_motion()
            .reduce()
            .prepare_palettes()
            .dither()
            .reconstruct()
            .reindex()
            .save(out_path)
        )

    def reload_gtm(self, path: str):
        """Re-import an encoded .gtm into the encoder's state for inspection
        (ReloadGTM, tilingencoder.pas:2059-2074; validation :5022-5030),
        through the port's GTMReader. The tiles and palettes go to the
        encoder's device, as the stages keep them; the tilemap and the
        keyframes stay numpy. Raises GTMReloadError when the stream does
        not match a loaded video."""
        from ..bitstream.gtm import GTMReader

        g = GTMReader.read(path)
        st = self.state
        if st.n_frames:
            problems = []
            if len(g.frames) != st.n_frames:
                problems.append(f"GTM FrameCount = {len(g.frames)}; FrameCount = {st.n_frames}")
            if g.width != st.width:
                problems.append(f"GTM ScreenWidth = {g.width}; ScreenWidth = {st.width}")
            if g.height != st.height:
                problems.append(f"GTM ScreenHeight = {g.height}; ScreenHeight = {st.height}")
            if problems:
                raise GTMReloadError("Mismatch between GTM and loaded video!\n"
                                     + "\n".join(problems))
        st.tilemap_w, st.tilemap_h = g.tilemap_w, g.tilemap_h
        st.fps = g.fps or st.fps
        F, N = len(g.frames), g.tilemap_w * g.tilemap_h
        tm = state_mod.TileMapSoA.zeros(F, N)
        for f, fr in enumerate(g.frames):
            tm.tile_idx[f] = fr.tile_idx
            tm.pal_idx[f] = fr.pal_idx
            tm.predicted[f] = fr.predicted
            tm.pred_x[f] = fr.pred_x
            tm.pred_y[f] = fr.pred_y
            tm.hmirror[f] = fr.hmirror
            tm.vmirror[f] = fr.vmirror
        st.tilemap = tm
        T = len(g.tiles_pal)
        st.corpus_use = np.zeros(T, np.int64)
        np.add.at(st.corpus_use, tm.tile_idx[tm.tile_idx >= 0], 1)

        def dev(a):
            return None if a is None else torch.as_tensor(np.array(a), device=self.device)

        st.corpus_pal_pixels = dev(g.tiles_pal)
        st.corpus_pal_initial = dev(np.zeros(T, np.int32))
        st.palettes_rgb = dev(g.palettes_rgb)
        st.palettes_valid = (None if g.palettes_rgb is None
                             else dev(np.ones(g.palettes_rgb.shape[:2], bool)))
        st.keyframes = []
        start = 0
        for k, end in enumerate(i for i, e in enumerate(g.keyframe_end) if e):
            st.keyframes.append(state_mod.KeyFrameInfo(k, start, end))
            start = end + 1
        st.frame_kf = np.zeros(F, np.int32)
        for kf in st.keyframes:
            st.frame_kf[kf.start_frame:kf.end_frame + 1] = kf.index
        return self

    # --- checkpoint/resume --------------------------------------------------
    def save_checkpoint(self, path: str):
        """Pickle the numpy state + settings (the JAX package's format). A
        memmap field goes to ``<path>.<field>.npy`` instead (pickling would
        read it into RAM); the live encoder keeps its memmap. On a mesh
        rank 0 alone writes, and every rank returns once it has."""
        if self.writes:
            self._write_checkpoint(path)
        if self.mesh is not None:
            dist.barrier()

    def _write_checkpoint(self, path: str):
        st = state_to_numpy(self.state)
        for fld in dataclasses.fields(st):
            v = getattr(st, fld.name)
            if isinstance(v, np.memmap):
                side = f"{path}.{fld.name}.npy"
                np.save(side, v)
                setattr(st, fld.name, _SpilledRef(os.path.basename(side)))
        with open(path, "wb") as f:
            pickle.dump({"state": st, "settings": self.settings}, f)

    @classmethod
    def load_checkpoint(cls, path: str, log=print, device=None, mesh=None) -> "Encoder":
        """Resume from a checkpoint written by either package (``device``
        and ``mesh`` as for the constructor; on a mesh every rank reads
        the file). Unpickling runs code named in the file: load only
        checkpoints you wrote."""
        with open(path, "rb") as f:
            d = _CheckpointUnpickler(f).load()
        enc = cls(d["settings"], log=log, device=device, mesh=mesh)
        st = d["state"]
        for fld in dataclasses.fields(st):
            v = getattr(st, fld.name)
            if isinstance(v, _SpilledRef):
                side = os.path.join(os.path.dirname(path) or ".", v.name)
                setattr(st, fld.name, np.load(side, mmap_mode="r"))
        host = st.frames_rgb is not None and (
            isinstance(st.frames_rgb, np.memmap) or isinstance(st.tiles_canon, np.memmap)
            or load_mod.clip_bytes(*st.frames_rgb.shape[:3]) > enc.settings.hbm_frames_budget)
        enc.state = state_from_numpy(st, enc.device, host_resident=host)
        return enc

    def _start(self) -> float:
        _sync(self.device)
        return time.monotonic()

    def _stamp(self, step: str, t0: float):
        _sync(self.device)  # per-step times that include the device work
        dt = time.monotonic() - t0
        self.timings[step] = dt
        self.log(f"[{step}] {dt:.3f}s")


class _CheckpointUnpickler(pickle.Unpickler):
    """Reads the JAX package's class names as the port's copies of them;
    any other name of that package is refused, so loading a checkpoint
    never imports it."""

    def find_class(self, module, name):
        if (module, name) in _CHECKPOINT_CLASSES:
            return _CHECKPOINT_CLASSES[module, name]
        if module == "tiler_tpu" or module.startswith("tiler_tpu."):
            raise pickle.UnpicklingError(
                f"checkpoint names {module}.{name}, which tiler_tpu_torch "
                f"has no copy of")
        return super().find_class(module, name)
