"""Palettes of 33..256 colors and the plain Thomas Knoll path, against
tiler_tpu. All integer where the dither is concerned: bit-identical. The
JAX side runs with 64-bit mode off, as in production.

- tk_select's plain version (the wide kernel's reference on the card)
  against the Pallas kernel in interpret mode at S = 33 and 64, on the
  adversarial tiles (equal lumas across every slot, duplicates, one or no
  valid slot). At S = 256 the Pallas kernel's interpret-mode compile
  alone takes over five minutes on a CPU (its color scan is unrolled over
  S), beyond the suite's budget, so there the reference is the JAX
  package's XLA Thomas Knoll path, which tests/test_tk_kernel.py holds
  bit-identical to the Pallas kernel;
- the port's thomas_knoll_lists (``use_pallas_tk=False``) against the JAX
  one, and its slots against tk_select's;
- Yliluoma2 at S = 64, and chunks sized from S;
- two end-to-end encodes within docs/DETERMINISM.md's gate (0.1 dB
  RGB-PSNR, 2% bytes): S = 64, and a tiny clip at P = 2, S = 256, whose
  stream the port's reader reads as the JAX reader does, and whose
  checkpoint loads in both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import synthetic_clip
from tiler_tpu.bitstream.gtm import GTMDecoder as JaxDecoder
from tiler_tpu.bitstream.gtm import GTMReader as JaxReader
from tiler_tpu.config import EncoderSettings as JaxSettings
from tiler_tpu.kernels import tk_dither as j_tk
from tiler_tpu.pipeline import dither as j_dither
from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
from tiler_tpu_torch.bitstream.gtm import GTMReader
from tiler_tpu_torch.config import EncoderSettings
from tiler_tpu_torch.kernels import tk_dither as t_tk
from tiler_tpu_torch.kernels import yl2_dither as t_yl
from tiler_tpu_torch.pipeline import dither as t_dither
from tiler_tpu_torch.pipeline.encoder import Encoder

from test_torch_e2e import _as_jax_checkpoint

FPS = 25.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors in many steps: one intra-op thread each, so that the
    suite's parallel workers do not leave pools of spinning threads
    waiting on each other (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bayer(mirror):
    T = len(mirror)
    hm, vm = (mirror & 1) != 0, (mirror & 2) != 0
    bay = np.broadcast_to(j_dither.BAYER8, (T, 8, 8))
    bay = np.where(hm[:, None, None], bay[:, :, ::-1], bay)
    return np.where(vm[:, None, None], bay[:, ::-1, :], bay), hm, vm


def _jax_tk(pix, mirror, pidx, pal, valid, pallas):
    """The JAX package's Thomas Knoll slots of the port's arguments: the
    Pallas kernel in interpret mode, or the XLA path."""
    T = len(pix)
    bay, hm, vm = _bayer(mirror)
    tiles = pix.reshape(T, 8, 8, 3)
    with jax.enable_x64(False):
        if pallas:
            out = j_tk.tk_dither_pallas(jnp.asarray(tiles), jnp.asarray(pidx), jnp.asarray(pal),
                                        jnp.asarray(valid), jnp.asarray(bay), interpret=True)
        else:
            out = j_dither._dither_chunk(
                jnp.asarray(tiles), jnp.asarray(pidx), jnp.asarray(hm), jnp.asarray(vm),
                jnp.asarray(pal), jnp.asarray(valid), pal.shape[1], True, 4)
    return np.asarray(out).reshape(T, 64)


def _port_args(pix, mirror, pidx, pal, valid):
    return (torch.from_numpy(pix), torch.from_numpy(mirror), torch.from_numpy(pidx),
            t_tk.pal_table(torch.from_numpy(pal), torch.from_numpy(valid)))


@pytest.mark.parametrize("S", [33, 64])
def test_tk_plain_matches_pallas_wide(S):
    case = t_tk.adversarial_case(S, seed=S, reps=1)
    got = t_tk.tk_select_wide(*_port_args(*case)).numpy()
    assert np.array_equal(got, _jax_tk(*case, pallas=True))


def test_tk_plain_matches_the_xla_path_at_256():
    """Every slot of the equal-luma palettes has one luma (98 distinct
    colors, repeated), so the picks of many slots interleave by step."""
    case = t_tk.adversarial_case(256, seed=256, reps=1)
    lum = case[3] @ np.array([299, 587, 114])
    assert len(np.unique(lum[3])) == 1 and len(np.unique(case[3][3], axis=0)) > 32
    got = t_tk.tk_select(*_port_args(*case)).numpy()
    assert np.array_equal(got, _jax_tk(*case, pallas=False))


@pytest.mark.parametrize("S", [40, 200])
def test_tk_plain_matches_the_xla_path_on_slot_edges(S):
    """Invalid slots below the first valid one that hold valid colors, no
    valid color, a single valid slot at S - 1, groups of 16 rows left
    partly padded (kernels/tk_dither.py slot_edge_case)."""
    case = t_tk.slot_edge_case(S, seed=S)
    assert case[3].shape == (8, S, 3)  # test_torch_cuda.SLOT_EDGES names the eight
    got = t_tk.tk_select(*_port_args(*case)).numpy()
    assert np.array_equal(got, _jax_tk(*case, pallas=False))
    pidx = case[2]
    assert (got[pidx == 2] == 0).all() and (got[pidx == 3] == S - 1).all()


def _tk_wide_model(pix, mirror, pidx, table):
    """csrc/tk_dither.cu's wide kernel in numpy, step for step: the valid
    rows compacted in slot order and padded to whole groups of 16 with
    copies of the last one (16 black rows of slot 0 without a valid
    color), the key 208 * bits + ((B * B + bias) << 9 | j) modulo 2^32
    with j the row's position in its group, each group's minimum merged
    into the best by a strict < on the key with its 4 position bits
    cleared, the position mapped back to its slot, and the rank found by
    the 24-bit binary search over the stored keys."""
    M = 1 << 32
    c001, c009 = float(np.float32(0.001)), float(np.float32(0.09))
    out = np.zeros((len(pix), 64), np.uint8)
    for t in range(len(pix)):
        pal = table[pidx[t]].astype(np.int64)
        vs = np.flatnonzero(pal[:, 4] > 0)
        rows = 16 * -(-len(vs) // 16) if len(vs) else 16
        src = np.concatenate([vs, np.full(rows - len(vs), vs[-1] if len(vs) else -1)])
        color = np.where(src[:, None] >= 0, pal[np.maximum(src, 0), :4], 0)  # r, g, b, luma
        psq = (color[:, :3] ** 2).sum(1)
        j = np.arange(rows) % 16
        px = pix[t].astype(np.int64)
        err = np.zeros((64, 3), np.int64)
        keys = np.zeros((64, 64), np.int64)  # [step, pixel]
        for c in range(64):
            tgt = px + np.sign(err) * np.floor(np.abs(err) * c009).astype(np.int64)
            lum_t = tgt @ np.array([299, 587, 114])
            bias = ((208 * (tgt * tgt).sum(1) - 0x24000000 + 511) % M) >> 9
            bits = 0x4B400000 + psq[None, :] - 2 * tgt @ color[:, :3].T  # [64, rows]
            q = np.floor(np.abs(lum_t[:, None] - color[None, :, 3]) * c001).astype(np.int64)
            B = 0x4B000000 + q
            key = (208 * bits + ((((B * B + bias[:, None]) << 9) % M) | j)) % M
            gmin = key.reshape(64, rows // 16, 16).min(-1)
            best = np.full(64, M - 1)
            group = np.zeros(64, np.int64)
            for g in range(rows // 16):
                lt = gmin[:, g] < (best & ~15)
                best = np.where(lt, gmin[:, g], best)
                group = np.where(lt, g, group)
            pos = 16 * group + (best & 15)
            err += px - color[pos, :3]
            keys[c] = ((color[pos, 3] * 64 + c) << 8) | np.maximum(src[pos], 0)
        bay, _, _ = _bayer(mirror[t:t + 1])
        for p in range(64):
            k, lo = keys[:, p], 0
            for bit in range(23, -1, -1):
                mid = lo | (1 << bit)
                if (k < (mid << 8)).sum() <= bay[0].reshape(64)[p]:
                    lo = mid
            out[t, p] = k[(k >> 8) == lo][-1] & 255
    return out


@pytest.mark.parametrize("S,case", [(48, "slot_edge"), (33, "adversarial")])
def test_tk_wide_kernel_design_matches_plain(S, case):
    """The wide kernel's design (csrc/tk_dither.cu header points 9-11),
    modelled in numpy, picks what the plain version picks, on the tiles
    that provoke its compaction and on the equal-luma, duplicate and
    error-growth tiles."""
    if case == "slot_edge":
        pix, mirror, pidx, pal, valid = t_tk.slot_edge_case(S, seed=S)
    else:
        pix, mirror, pidx, pal, valid = t_tk.adversarial_case(S, seed=S, reps=1)
        pix, mirror, pidx = pix[:24], mirror[:24], pidx[:24]
    args = _port_args(pix, mirror, pidx, pal, valid)
    want = t_tk.tk_select_plain(*args).numpy()
    assert np.array_equal(_tk_wide_model(pix, mirror, pidx, args[3].numpy()), want)


def test_wide_wrapper_takes_only_wide_palettes():
    case = t_tk.adversarial_case(16, seed=0, reps=1)
    with pytest.raises(ValueError, match="not above 32"):
        t_tk.tk_select_wide(*_port_args(*case))
    pix, mirror, pidx, pal, valid = case
    wide = np.concatenate([pal] * 17, axis=1)  # S = 272
    with pytest.raises(ValueError, match="outside 1..256"):
        t_tk.tk_select(*_port_args(pix, mirror, pidx, wide, np.concatenate([valid] * 17, 1)))


def _pixel_case(B, S, seed):
    """Pixels with their palettes; some palettes lose slots, a few keep
    one slot or none, a few repeat one color in every slot."""
    rng = np.random.default_rng(seed)
    pix = rng.integers(0, 256, (B, 3)).astype(np.int32)
    pal = rng.integers(0, 256, (B, S, 3)).astype(np.int32)
    valid = rng.random((B, S)) < 0.8
    valid[:4] = False
    valid[4:8] = False
    valid[4:8, S // 2] = True
    pal[8:12] = pal[8:12, :1]
    return pix, pal, valid


@pytest.mark.parametrize("S", [16, 64])
def test_thomas_knoll_lists_bit_identical(S):
    pix, pal, valid = _pixel_case(300, S, S)
    with jax.enable_x64(False):
        want = j_dither.thomas_knoll_lists(jnp.asarray(pix), jnp.asarray(pal),
                                           jnp.asarray(valid), S)
    got = t_dither.thomas_knoll_lists(torch.from_numpy(pix), torch.from_numpy(pal),
                                      torch.from_numpy(valid), S)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("S", [16, 64, 256])
def test_plain_thomas_knoll_path_equals_tk_select(S):
    """use_pallas_tk=False (plain tensor passes, in chunks that do not
    divide the tiles) writes tk_select's slots."""
    pix, mirror, pidx, pal, valid = t_tk.adversarial_case(S, seed=S + 1, reps=1)
    want = t_tk.tk_select(*_port_args(pix, mirror, pidx, pal, valid))
    got = t_dither.thomas_knoll_select(
        torch.from_numpy(pix.reshape(-1, 8, 8, 3)), torch.from_numpy(mirror),
        torch.from_numpy(pidx), torch.from_numpy(pal), torch.from_numpy(valid), chunk=7)
    assert torch.equal(got.reshape(-1, 64), want)


def test_yliluoma2_lists_at_64():
    pix, pal, valid = _pixel_case(120, 64, 3)
    with jax.enable_x64(False):
        want_lists, want_count = j_dither.yliluoma2_lists(
            jnp.asarray(pix), jnp.asarray(pal), jnp.asarray(valid), 64, 4)
    lists, count = t_yl.yliluoma2_lists(
        torch.from_numpy(pix), torch.from_numpy(pal), torch.from_numpy(valid), 64, 4)
    assert np.array_equal(count.numpy(), np.asarray(want_count))
    assert np.array_equal(lists.numpy(), np.asarray(want_lists))


@pytest.mark.parametrize("S,mixed,tiles", [(16, 4, 8192), (256, 4, 512), (256, 16, 128),
                                           (1, 1, 1 << 19)])
def test_yliluoma2_chunk_follows_the_palette_size(S, mixed, tiles):
    """The [pixels, S, 2 * mixed, 4] int32 candidate table of a chunk
    stays at 1 GiB."""
    assert t_yl.yliluoma2_chunk(S, mixed) == tiles
    assert tiles * 64 * S * 2 * mixed * 4 * 4 == 1 << 30


def _encode_both(kw, clip, out_dir):
    """The clip through both packages. The JAX side takes its XLA Thomas
    Knoll path (the Pallas kernel's interpret-mode compile grows with S);
    the port's default path runs tk_select. Returns {name: (RGB-PSNR,
    bytes, path)} and the port's encoder."""
    res, port = {}, None
    for name in ("jax", "torch"):
        out = out_dir / f"{name}.gtm"
        if name == "jax":
            with jax.enable_x64(False):
                enc = JaxEncoder(JaxSettings(**kw, use_pallas_tk=False), log=None)
                enc.run_all(clip, fps=FPS, out_path=str(out))
        else:
            port = enc = Encoder(EncoderSettings(**kw), log=None, device="cpu")
            enc.run_all(clip, fps=FPS, out_path=str(out))
        frames = np.stack(JaxDecoder(str(out)).decode_frames())[..., :3]
        assert frames.shape == clip.shape
        mse = np.mean((frames.astype(np.float64) - clip) ** 2)
        res[name] = (10 * np.log10(255 * 255 / max(mse, 1e-9)), enc.stats.total_bytes, out)
    return res, port


def _gate(res):
    assert abs(res["torch"][0] - res["jax"][0]) <= 0.1
    assert abs(res["torch"][1] - res["jax"][1]) <= 0.02 * res["jax"][1]


WIDE64 = dict(palette_count=4, palette_size=64, motion_predict_radius=4, epu_knn_k=8,
              kmeans_iters=4)
WIDE256 = dict(palette_count=2, palette_size=256, motion_predict_radius=2, epu_knn_k=4,
               kmeans_iters=2)


def test_run_all_at_64_within_the_determinism_gate(tmp_path):
    clip = synthetic_clip(4, 64, 96, seed=0)
    res, port = _encode_both(WIDE64, clip, tmp_path)
    _gate(res)
    assert len(port.step_stats["two_opt_inner"]) >= 1
    # the plain Thomas Knoll path writes the same stream to the byte
    out = tmp_path / "plain_tk.gtm"
    Encoder(EncoderSettings(**WIDE64, use_pallas_tk=False), log=None,
            device="cpu").run_all(clip, fps=FPS, out_path=str(out))
    assert out.read_bytes() == res["torch"][2].read_bytes()


@pytest.fixture(scope="module")
def wide256(tmp_path_factory):
    clip = synthetic_clip(2, 64, 96, seed=1)
    return _encode_both(WIDE256, clip, tmp_path_factory.mktemp("wide256"))


def test_run_all_at_256_within_the_determinism_gate(wide256):
    _gate(wide256[0])


def test_port_reader_reads_a_256_color_stream_as_the_jax_reader(wide256):
    raw = wide256[0]["torch"][2].read_bytes()
    got, want = GTMReader.read(raw), JaxReader.read(raw)
    assert got.palette_size == want.palette_size == 256
    assert got.palettes_rgb.shape == (2, 256, 3)
    assert np.array_equal(got.palettes_rgb, want.palettes_rgb)
    assert np.array_equal(got.tiles_pal, want.tiles_pal)
    assert int(got.tiles_pal.max()) > 32  # slots past the narrow kernels' range
    assert len(got.frames) == len(want.frames) == 2
    for a, b in zip(got.frames, want.frames):
        assert dataclasses.asdict(a).keys() == dataclasses.asdict(b).keys()
        for k, v in dataclasses.asdict(a).items():
            assert np.array_equal(np.asarray(v), np.asarray(dataclasses.asdict(b)[k])), k
    assert (got.width, got.height, got.settings_text) == (want.width, want.height,
                                                           want.settings_text)


def test_checkpoint_at_256_loads_in_both_packages(wide256, tmp_path):
    port = wide256[1]
    ck = tmp_path / "wide.ckpt"
    port.save_checkpoint(str(ck))
    mine = Encoder.load_checkpoint(str(ck), log=None, device="cpu")
    assert mine.settings.palette_size == 256
    assert tuple(mine.state.palettes_rgb.shape) == (2, 256, 3)
    jck = tmp_path / "as_jax.ckpt"
    _as_jax_checkpoint(ck, jck)
    with jax.enable_x64(False):
        theirs = JaxEncoder.load_checkpoint(str(jck), log=None)
    assert theirs.settings.palette_size == 256
    assert np.array_equal(np.asarray(theirs.state.palettes_rgb),
                          mine.state.palettes_rgb.numpy())
    assert np.array_equal(np.asarray(theirs.state.corpus_pal_pixels),
                          mine.state.corpus_pal_pixels.numpy())
