"""Encoder settings: dataclass + INI round-trip, mirroring the reference's
settings surface (tilingencoder.pas:3738-3845) key for key so existing
settings files drive this encoder unchanged.

The port's own copy of ``tiler_tpu/config.py``: the same fields, defaults
and INI keys, so one settings file drives both packages. Settings the
port does not run are refused by ``pipeline/encoder.py::check_settings``.
"""
from __future__ import annotations

import configparser
import io
import math
from dataclasses import dataclass, field


def equal_quality_tile_count(tile_count: float) -> int:
    """EqualQualityTileCount = round(sqrt(n) * log2(1+n)) (utils.pas:1038)."""
    return round(math.sqrt(tile_count) * math.log2(1 + tile_count))


# TPsyVisMode order (tilingencoder.pas:21)
PSYVIS_MODES = ("dct", "weighted_dct", "wavelets", "spe_dct", "weighted_spe_dct")


@dataclass
class EncoderSettings:
    # [Load]
    input_file_name: str = ""
    output_file_name: str = ""
    start_frame: int = 0
    frame_count: int = 0
    scaling: float = 1.0
    shot_trans_max_seconds_per_kf: float = 15.0
    shot_trans_min_seconds_per_kf: float = 1.0
    shot_trans_correl_lo_thres: float = 0.8
    # [MotionPredict]
    motion_predict_radius: int = 32
    # [GlobalTiling]
    global_tiling_use_target_psnr: bool = False
    global_tiling_target_psnr: float = 20.0
    global_tiling_quality_based_tile_count: float = 7.0
    global_tiling_tile_count: int = 0  # explicit count has priority when > 0
    # [Dither]
    palette_size: int = 16
    palette_count: int = 1024
    dithering_mode: str = "weighted_spe_dct"
    dithering_use_thomas_knoll: bool = True
    dithering_yliluoma2_mixed_colors: int = 4
    # [FrameTiling]
    frame_tiling_extended_palette_usage: bool = True
    # [Misc]
    max_thread_count: int = 0  # informational; TPU path ignores it

    # --- TPU-specific knobs (not in the reference INI surface) ---
    epu_knn_k: int = 64  # cEpuKnnK (tilingencoder.pas:1433)
    kmeans_iters: int = 30
    corpus_chunk: int = 8192  # corpus matmul chunk for KNN
    seed: int = 0x42381337  # CRandomSeed (extern.pas:226)
    epu_pal_k: int = 16  # caps the EPU palette candidates to the top-k
    # tiles' palettes; 0 = full cartesian (reference parity). 16 is
    # BYTE-IDENTICAL to full at q=7 on city (docs/PARITY.md A/B) and
    # quarters the cartesian re-rank
    color_quantizer: str = "kmeans"  # per-palette color quantizer:
    # "kmeans" (yakmo parity) or "mediancut" (the dlquant DL1/DL3 role,
    # extern.pas:195-196 — deterministic box cuts, host-side)
    device_resample: bool = True  # ingest ships SOURCE-resolution pixels
    # (raw 4:2:0/4:4:4 planes for y4m and natively-4:2:0 video) and runs
    # chroma upsample + YUV->RGB + the Lanczos `Scaling` resize ON DEVICE
    # (ops/resample.py) instead of the host PIL/sws path the reference
    # uses (extern.pas:759-789 — it has no device). Output-affecting only
    # when scaling != 1 (the Lanczos implementations differ in rounding
    # detail; measured ~50 dB vs the host filter, tests/test_resample.py);
    # at scaling == 1 the planar conversion is bit-identical to load_y4m.
    int16_features: bool = False  # round psy-vis features to integers
    # (SmallInt semantics, tilingencoder.pas:3126) in the motion/
    # reconstruct EXACT error paths — near-tie selections then match the
    # reference's quantized distances; ranking stays bf16 either way
    phase_b_motion: str = "reuse"  # "reuse" (default): exactly evaluate
    # the PHASE-A vector against the reconstruction (the pred-vs-knn
    # decision still sees a true reconstruction error, only the vector is
    # not re-optimized); "research": full-radius re-search vs the
    # reconstruction every frame (reference parity, tilingencoder.pas:
    # 1496-1532). A/B on the bench clip (docs/PARITY.md): reuse is 0.35s
    # faster AND +0.67 dB PSNR-HVS at 8% smaller stream — re-searching
    # against the lossy reconstruction locks onto its artifacts
    lzma_mode: str = "optimal"  # "optimal" (ratio preset: price-DP parse,
    # 0.996x the reference's own stream sizes) or "fast" (hash-5 lazy
    # greedy, ~2.2x faster at ~1.04x size) — native/lzma.cpp
    knn_skip_perfect_pred: bool = True  # skip phase-A KNN/EPU for cells
    # already predicted with a perfect-threshold motion PSNR (>= 48.13 dB
    # = euclidean TOL 192) — the reference's own skip (mpErr <= cTileDCTSize
    # bypasses the kd-tree, tilingencoder.pas:1535-1547), tested here on
    # the phase-A PSNR instead of the phase-B reconstruction error
    count_predicted_tiles: bool = False  # reference Reindex parity
    # (:2012-2030): prediction-overridden cells keep their KNN tile_idx
    # and count into the TileSet (never emitted as commands — a larger
    # stream for no fidelity gain; off reproduces our smaller default)
    use_pallas_tk: bool = True  # Pallas Thomas Knoll kernel (falls back to XLA)
    knn_backend: str = "pallas"  # phase-A corpus top-k backend:
    # "pallas" (v2 block top-k kernel: every distance term folded into
    # the matmul so the MXU emits true distances and the VPU does ~6
    # ops/elem — the r5 roofline put v1 at ~6% MXU with the wall in key
    # packing; CHIP VERDICT r5 battery: the v1 revert measured -6.3%
    # fps at identical output, confirming v2), "pallas_v1" (the r4
    # kernel, kept selectable for A/Bs;
    # rankings differ only in near-tie rounding), "xla" (lax.top_k over
    # the distance matmul), or "ivf" (two-level inverted-file search,
    # pipeline/ivf.py — approximate like the reference's ANN kd-trees,
    # extern.pas:182-185; the EPU re-ranks survivors with exact errors).
    # CHIP VERDICT (r4 battery, docs/PERF.md): ivf LOSES at bench corpus
    # size — 4.67 vs 5.32 fps; the KNN matmul was never the wall
    ivf_probes: int = 8  # IVF blocks probed per query (recall knob)
    ivf_min_corpus: int = 4096  # brute force below this corpus size
    # (block probing only beats one matmul on large corpora)
    epu_two_stage: bool = False  # two-stage EPU re-rank: stage 1 ranks
    # all kk x kp pairs with an int8 LOW-FREQUENCY G (epu_stage1_dims)
    # + int16 Q (per-column scales folded exactly into the palette
    # outer products), stage 2 re-ranks the top epu_stage1_m pairs with
    # EXACT pixel-render errors. Gi gather bytes /8, Qi /2; measured
    # 99.3% winner agreement, +0.21% mean exact-err at CIF/256
    # (scripts/ab_epu_lowrank.py). CHIP VERDICT (r4 battery,
    # docs/PERF.md): dead end at bench settings — M=16 fails the
    # quality gate (-0.47 dB tie-collapse), M=32 restores fidelity but
    # measured NO reconstruct win; stays selectable for large-corpus
    # regimes where the gather arithmetic changes.
    motion_field: str = "passes"  # window-DCT field formulation:
    # "passes" (r4: shifted elementwise pass A/B in block layout) or
    # "im2row" (r5: one MXU contraction over the 64 window pixels + the
    # Pallas blockify relayout — the roofline measured "passes" 10x+ off
    # its bandwidth floor). Values differ only by f32 contraction-order
    # rounding in a ranking-only quantity; battery-gated.
    epu_fused_fp: bool = False  # fuse the DEFAULT full-precision Gi/Qi
    # gathers into ONE int8 byte-row gather (G bf16 bytes ++ f32 Q
    # bytes, bitcast on device) — halves the gather ROW count at the
    # same total bytes, with ranking values bit-identical to the
    # default path by construction (tests/test_epu_oracle.py).
    # CHIP VERDICT (r5 battery, docs/PERF.md): LOSES -20% fps — the
    # gather engine's row rate is NOT width-independent at these sizes
    # (a fused 3.6 KB row gathers at ~half the rows/s of the separate
    # 2.0/1.6 KB rows) and the device bitcast/split adds VPU work. The
    # int8/int16 COMPACT forms of the same lever (epu_compact_tables /
    # epu_fused_gather) were DELETED after the same battery: dominated
    # on both axes (slower AND a -0.26 dB used-tile-shrink). This flag
    # stays selectable as the quality-safe form for regimes with much
    # wider rows (bigger S) where the row-rate argument may reopen.
    epu_stage1_dims: int = 48  # stage-1 rank dims (3*r^2; 48 -> the
    # 4x4 low-frequency DCT block per channel)
    epu_stage1_m: int = 16  # exact-re-ranked survivors per cell
    motion_rank_dims: int = 192  # candidate RANKING dims for motion search:
    # 3*r^2 low-frequency DCT coefficients per channel (192 = exact full
    # search; the winner's error is always exact 192-dim fp32). MEASURED
    # SLOWER at 48 on v5e: sub-128 minor dims pad to full lanes and the
    # 16-channel grouped conv falls off the fast path — keep 192 unless a
    # future backend changes the math
    hbm_frames_budget: float = 8e9  # larger videos stream from host RAM
    host_ram_budget: float = 0.0  # >0: videos whose host footprint
    # (frames + canonical tiles, ~384 B/tile total) exceeds this spill
    # both arrays to unlinked temp-file memmaps (utils/spill.py) — the
    # encode becomes disk-capacity-bound instead of RAM-bound. No effect
    # on output bytes; INI [Misc] HostRamBudget (with MaxThreadCount,
    # the host-resource section).

    def derived_tile_count(self, total_raw_tiles: int) -> int:
        """GlobalTilingTileCount resolution (tilingencoder.pas:2937-2948)."""
        if self.global_tiling_tile_count > 0:
            return min(self.global_tiling_tile_count, total_raw_tiles)
        eqtc = equal_quality_tile_count(total_raw_tiles)
        return max(1, min(round(self.global_tiling_quality_based_tile_count * eqtc), total_raw_tiles))

    # ---- INI round-trip (SaveSettings/LoadSettings parity) ----
    _INI_MAP = (
        ("Load", "InputFileName", "input_file_name", str),
        ("Load", "OutputFileName", "output_file_name", str),
        ("Load", "StartFrame", "start_frame", int),
        ("Load", "FrameCount", "frame_count", int),
        ("Load", "Scaling", "scaling", float),
        ("MotionPredict", "MotionPredictRadius", "motion_predict_radius", int),
        ("GlobalTiling", "GlobalTilingUseTargetPSNR", "global_tiling_use_target_psnr", bool),
        ("GlobalTiling", "GlobalTilingTargetPSNR", "global_tiling_target_psnr", float),
        ("GlobalTiling", "GlobalTilingQualityBasedTileCount", "global_tiling_quality_based_tile_count", float),
        ("GlobalTiling", "GlobalTilingTileCount", "global_tiling_tile_count", int),
        ("Dither", "PaletteSize", "palette_size", int),
        ("Dither", "PaletteCount", "palette_count", int),
        ("Dither", "DitheringMode", "dithering_mode", "psyvis"),
        ("Dither", "DitheringUseThomasKnoll", "dithering_use_thomas_knoll", bool),
        ("Dither", "DitheringYliluoma2MixedColors", "dithering_yliluoma2_mixed_colors", int),
        ("FrameTiling", "FrameTilingExtendedPaletteUsage", "frame_tiling_extended_palette_usage", bool),
        ("Misc", "MaxThreadCount", "max_thread_count", int),
        ("Misc", "HostRamBudget", "host_ram_budget", float),
        ("Load", "ShotTransMaxSecondsPerKF", "shot_trans_max_seconds_per_kf", float),
        ("Load", "ShotTransMinSecondsPerKF", "shot_trans_min_seconds_per_kf", float),
        ("Load", "ShotTransCorrelLoThres", "shot_trans_correl_lo_thres", float),
        # [TPU] — every OUTPUT-AFFECTING TPU-specific knob round-trips
        # here so a stream reproduces from its embedded settings text
        # (the reference embeds its full settings the same way,
        # tilingencoder.pas:5331-5335); perf-only/platform knobs
        # (use_pallas_tk, corpus_chunk, TILER_TPU_* profiling hooks)
        # deliberately stay out.
        ("TPU", "EpuKnnK", "epu_knn_k", int),
        ("TPU", "EpuPalK", "epu_pal_k", int),
        ("TPU", "KMeansIters", "kmeans_iters", int),
        ("TPU", "Seed", "seed", int),
        ("TPU", "ColorQuantizer", "color_quantizer", str),
        ("TPU", "Int16Features", "int16_features", bool),
        ("TPU", "PhaseBMotion", "phase_b_motion", str),
        ("TPU", "LzmaMode", "lzma_mode", str),
        ("TPU", "KnnSkipPerfectPred", "knn_skip_perfect_pred", bool),
        ("TPU", "CountPredictedTiles", "count_predicted_tiles", bool),
        ("TPU", "MotionRankDims", "motion_rank_dims", int),
        ("TPU", "KnnBackend", "knn_backend", str),
        ("TPU", "IvfProbes", "ivf_probes", int),
        ("TPU", "IvfMinCorpus", "ivf_min_corpus", int),
        ("TPU", "EpuTwoStage", "epu_two_stage", bool),
        ("TPU", "EpuFusedFp", "epu_fused_fp", bool),
        ("TPU", "EpuStage1Dims", "epu_stage1_dims", int),
        ("TPU", "EpuStage1M", "epu_stage1_m", int),
        ("TPU", "DeviceResample", "device_resample", bool),
        ("TPU", "MotionField", "motion_field", str),
    )

    # Settings keys that earlier rounds emitted (so they exist in old
    # streams' embedded settings text) but that were later REMOVED from
    # the surface. from_ini must not silently ignore them — a stream that
    # set one would otherwise reproduce a different (default) encoder
    # config with no hint (stream-reproducibility contract).
    _REMOVED_INI_KEYS = (
        ("TPU", "EpuInt8Tables",
         "one-stage int8 EPU tables were deleted in round 4 (superseded "
         "by EpuTwoStage; see docs/PERF.md battery verdicts)"),
        ("TPU", "EpuCompactTables",
         "deleted in round 5: the r5 chip battery measured the compact "
         "int8/int16 EPU tables slower AND -0.26 dB (docs/PERF.md)"),
        ("TPU", "EpuFusedGather",
         "deleted in round 5: dominated by EpuFusedFp on both axes in "
         "the r5 chip battery (docs/PERF.md)"),
    )

    def apply_overrides(self, spec: str) -> "EncoderSettings":
        """Apply a comma-separated ``field=value`` override string (the
        A/B-script `PB_SETTINGS` syntax) in place, coercing each value to
        the field's current type. Unknown fields raise AttributeError —
        a typo'd A/B child must fail loudly, not silently measure the
        baseline. Returns self for chaining."""
        for kv in spec.split(","):
            if not kv:
                continue
            k, v = kv.split("=", 1)
            t = type(getattr(self, k))
            if t is bool:  # same forms as from_ini: 0/1 and true/false
                low = v.strip().lower()
                val = low == "true" if low in ("true", "false") else bool(int(v))
            else:
                val = t(v)
            setattr(self, k, val)
        return self

    def to_ini(self) -> str:
        cp = configparser.ConfigParser()
        cp.optionxform = str
        for section, key, attr, typ in self._INI_MAP:
            if not cp.has_section(section):
                cp.add_section(section)
            v = getattr(self, attr)
            if typ == "psyvis":
                v = PSYVIS_MODES.index(v)
            elif typ is bool:
                v = int(v)
            elif typ is float and float(v) == int(v):
                v = int(v)
            cp.set(section, key, str(v))
        buf = io.StringIO()
        cp.write(buf, space_around_delimiters=False)
        return buf.getvalue()

    @classmethod
    def from_ini(cls, text_or_path: str) -> "EncoderSettings":
        cp = configparser.ConfigParser(strict=False)
        cp.optionxform = str
        if "\n" in text_or_path or "=" in text_or_path:
            cp.read_string(text_or_path)
        else:
            cp.read(text_or_path)
        self = cls()
        for section, key, attr, typ in cls._INI_MAP:
            if not cp.has_option(section, key):
                continue
            raw = cp.get(section, key)
            if typ == "psyvis":
                idx = max(0, min(int(float(raw)), len(PSYVIS_MODES) - 1))
                setattr(self, attr, PSYVIS_MODES[idx])
            elif typ is bool:
                # accept 0/1 (our to_ini) and True/False (hand-written
                # INIs / FreePascal TIniFile style)
                low = raw.strip().lower()
                if low in ("true", "false"):
                    setattr(self, attr, low == "true")
                else:
                    setattr(self, attr, bool(int(float(raw))))
            elif typ is int:
                setattr(self, attr, int(float(raw)))
            elif typ is float:
                setattr(self, attr, float(raw))
            else:
                setattr(self, attr, raw)
        for section, key, why in cls._REMOVED_INI_KEYS:
            if cp.has_option(section, key):
                import warnings

                warnings.warn(
                    f"settings key [{section}]{key} was removed: {why}. "
                    "A stream encoded with it set will not reproduce "
                    "exactly from its embedded settings.",
                    stacklevel=2)
        return self
