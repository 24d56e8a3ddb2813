"""The port's host tooling against tiler_tpu's: ``Encoder.reload_gtm``
(and ``GTMReloadError``), the CLI's encode flags ``--steps``,
``--resume``, ``--export-y4m``, ``--export-input-y4m``,
``--export-pngs`` and ``--mesh auto`` (in one process, a no-op), the
render pages (``render.py``) and the preview server (``preview.py``, the
CLI's ``preview``). All on the CPU.

- reload_gtm: every field it writes equals the JAX package's on the same
  stream (the port's tensors read back to numpy), and both refuse a
  stream of another size than the loaded video with the same message.
- The CLI: an encode cut into two step ranges, the second resumed from
  the first's checkpoint, writes the stream of one whole encode to the
  byte; its Y4M exports equal the JAX package's export of the same frames
  to the byte, and the PNG base its frames and palette dump.
- render.py is the original's copy byte for byte, and each page equals
  the JAX package's render of the same numpy state.
- A PreviewServer on port 0 serves its four pages, and preview_gtm (and
  the CLI's preview) serves a re-imported stream.
"""
import io
import json
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from bench import synthetic_clip
from tiler_tpu import render as j_render
from tiler_tpu.bitstream.gtm import GTMDecoder as JaxDecoder
from tiler_tpu.io import export as j_export
from tiler_tpu.io import video as j_video
from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
from tiler_tpu.pipeline.encoder import STEPS as JAX_STEPS
from tiler_tpu.pipeline.encoder import GTMReloadError as JaxReloadError
from tiler_tpu_torch import cli, render
from tiler_tpu_torch.config import EncoderSettings
from tiler_tpu_torch.models.convert import state_to_numpy
from tiler_tpu_torch.pipeline.encoder import STEPS, Encoder, GTMReloadError
from tiler_tpu_torch.preview import PreviewServer, preview_gtm

torch.set_num_threads(1)  # many small tensor passes: workers share the host

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(palette_count=8, motion_predict_radius=4, epu_knn_k=8, kmeans_iters=4)
CLIP = synthetic_clip(6, 64, 96, seed=0)
INI = """[Dither]
PaletteCount=8
[TPU]
EpuKnnK=8
KMeansIters=4
"""


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """A small clip through the port on the CPU: (encoder, stream path)."""
    path = tmp_path_factory.mktemp("tooling") / "out.gtm"
    enc = Encoder(EncoderSettings(**SMALL), log=None, device="cpu")
    enc.run_all(CLIP, fps=25.0, out_path=str(path))
    return enc, str(path)


def test_steps_match_the_reference():
    assert STEPS == JAX_STEPS


RELOADED = ("fps", "tilemap_w", "tilemap_h", "corpus_pal_pixels", "corpus_use",
            "corpus_pal_initial", "palettes_rgb", "palettes_valid", "frame_kf")


def test_reload_gtm_matches_the_reference(encoded):
    _, path = encoded
    with jax.enable_x64(False):
        want = JaxEncoder(log=None).reload_gtm(path).state
    enc = Encoder(log=None, device="cpu").reload_gtm(path)
    assert isinstance(enc.state.corpus_pal_pixels, torch.Tensor)  # on the encoder's device
    got = state_to_numpy(enc.state)
    for name in RELOADED:
        a, b = getattr(got, name), getattr(want, name)
        assert np.array_equal(a, b) and np.asarray(a).dtype == np.asarray(b).dtype, name
    for name in ("tile_idx", "pal_idx", "pred_x", "pred_y", "predicted", "hmirror",
                 "vmirror", "psnr"):
        a, b = getattr(got.tilemap, name), getattr(want.tilemap, name)
        assert np.array_equal(a, b) and a.dtype == b.dtype, name
    assert got.keyframes == [type(got.keyframes[0])(**vars(k)) for k in want.keyframes]
    assert got.n_frames == want.n_frames == 0  # no video was loaded


def test_reload_gtm_refuses_another_video(encoded):
    _, path = encoded
    other = synthetic_clip(6, 64, 88, seed=1)
    with jax.enable_x64(False):
        with pytest.raises(JaxReloadError) as want:
            JaxEncoder(log=None).load_frames(other, 25.0).reload_gtm(path)
    with pytest.raises(GTMReloadError) as got:
        Encoder(log=None, device="cpu").load_frames(other, 25.0).reload_gtm(path)
    assert str(got.value) == str(want.value)
    assert "GTM ScreenWidth = 96; ScreenWidth = 88" in str(got.value)


def test_cli_steps_resume_and_exports(tmp_path):
    y4m = tmp_path / "clip.y4m"
    j_export.write_y4m(str(y4m), CLIP, 25.0)
    ini = tmp_path / "s.ini"
    ini.write_text(INI)
    # one output name for both runs: the stream embeds its settings text
    part = tmp_path / "out.gtm"
    base = ["encode", "-i", str(y4m), "--device", "cpu"]
    assert cli.main(base + ["-o", str(part), "-s", str(ini)]) == 0
    whole = part.rename(tmp_path / "whole.gtm")
    ck = tmp_path / "dither.ckpt"
    assert cli.main(base + ["-o", str(part), "-s", str(ini), "--steps", "load:dither",
                            "--checkpoint", str(ck)]) == 0
    assert not part.exists()  # the range stopped before save
    out_y4m, in_y4m, pngs = tmp_path / "out.y4m", tmp_path / "in.y4m", tmp_path / "png" / "f"
    pngs.parent.mkdir()
    assert cli.main(["encode", "--resume", str(ck), "--device", "cpu", "-o", str(part),
                     "--steps", "reconstruct:", "--export-y4m", str(out_y4m),
                     "--export-input-y4m", str(in_y4m), "--export-pngs", str(pngs)]) == 0
    assert part.read_bytes() == whole.read_bytes()
    frames = JaxDecoder(str(part)).decode_frames()
    ref_out, ref_in = tmp_path / "ref_out.y4m", tmp_path / "ref_in.y4m"
    j_export.write_y4m(str(ref_out), [f[..., :3] for f in frames], 25.0)
    # the input as the JAX package's CLI loads it (the y4m's YUV, rounded)
    j_export.write_y4m(str(ref_in), j_video.load_video(str(y4m))[0], 25.0)
    assert out_y4m.read_bytes() == ref_out.read_bytes()
    assert in_y4m.read_bytes() == ref_in.read_bytes()
    for i, f in enumerate(frames):
        assert np.array_equal(np.asarray(Image.open(f"{pngs}_{i:04d}.png")), f[..., :3])
    dump = (tmp_path / "png" / "f.txt").read_text().split()
    assert len(dump) == 8 * 16  # every color of the 8 palettes of 16


def test_cli_mesh_auto_in_one_process_is_a_noop(tmp_path, monkeypatch):
    """--mesh auto outside a torchrun group (one process, no process
    group): the meshless encode, to the byte (the JAX CLI's rule,
    tests/test_cli_config.py::test_cli_mesh_auto_single_device_is_noop)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert Encoder(log=None, device="cpu", mesh="auto").mesh is None
    y4m = tmp_path / "clip.y4m"
    j_export.write_y4m(str(y4m), CLIP[:3], 25.0)
    ini = tmp_path / "s.ini"
    ini.write_text(INI)
    out = tmp_path / "out.gtm"  # one name: the stream embeds its settings text
    base = ["encode", "-i", str(y4m), "-o", str(out), "-s", str(ini), "--device", "cpu"]
    assert cli.main(base) == 0
    meshless = out.read_bytes()
    assert cli.main(base + ["--mesh", "auto"]) == 0
    assert out.read_bytes() == meshless


def test_cli_step_ranges():
    """"a:b" with open ends, and a bare step name for that step alone."""
    assert cli._step_range("reduce", STEPS) == ("reduce",)
    assert cli._step_range(":reduce", STEPS) == STEPS[:3]
    assert cli._step_range("reindex:", STEPS) == ("reindex", "save")
    assert cli._step_range("load:save", STEPS) == STEPS


def test_render_is_the_original_byte_for_byte():
    assert (ROOT / "tiler_tpu_torch" / "render.py").read_bytes() == \
        (ROOT / "tiler_tpu" / "render.py").read_bytes()


def test_render_pages_equal_the_reference(encoded):
    enc, _ = encoded
    st = state_to_numpy(enc.state)
    for f in (0, 3, 5):
        assert np.array_equal(render.render_input(st, f), j_render.render_input(st, f))
        assert np.array_equal(render.render_output(st, f), j_render.render_output(st, f))
        assert render.frame_psnr(st, f) == j_render.frame_psnr(st, f)
    assert np.array_equal(render.render_tiles(st), j_render.render_tiles(st))
    assert np.array_equal(render.render_tiles(st, 16, 2), j_render.render_tiles(st, 16, 2))
    assert np.array_equal(render.render_palettes(st), j_render.render_palettes(st))
    # the output page is the decoded stream
    assert np.array_equal(render.render_output(st, 5),
                          JaxDecoder(encoded[1]).decode_frames()[5][..., :3])


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_preview_server_serves_its_four_pages(encoded):
    enc, path = encoded
    srv = PreviewServer(state_to_numpy(enc.state), port=0)
    srv.start_background()
    try:
        info = json.loads(_get(srv.port, "/info.json")[2])
        assert info["pages"] == ["input", "output", "tiles", "palettes"]
        assert info["frames"] == 6 and (info["width"], info["height"]) == (96, 64)
        for page in info["pages"]:
            code, ctype, body = _get(srv.port, f"/render/{page}/2.png")
            assert code == 200 and ctype == "image/png", page
        img = np.asarray(Image.open(io.BytesIO(_get(srv.port, "/render/output/3.png")[2])))
        assert np.array_equal(img, JaxDecoder(path).decode_frames()[3][..., :3])
        assert b"tiler-tpu preview" in _get(srv.port, "/")[2]
        d = json.loads(_get(srv.port, "/inspect.json?page=palettes&frame=0&x=17&y=9")[2])
        assert (d["palette"], d["color"]) == (1, 2)
    finally:
        srv.shutdown()


def test_preview_of_a_reloaded_stream(encoded, monkeypatch):
    _, path = encoded
    srv = preview_gtm(path, port=0, device="cpu")
    srv.start_background()
    try:
        info = json.loads(_get(srv.port, "/info.json")[2])
        assert info["frames"] == 6 and "input" not in info["pages"]
        assert _get(srv.port, "/render/output/5.png")[:2] == (200, "image/png")
    finally:
        srv.shutdown()
    # the CLI's preview: serves until interrupted, then shuts down (here
    # an interrupt as soon as it would serve)
    calls = []

    def serve(self):
        calls.append("serve")
        raise KeyboardInterrupt

    def shutdown(self):
        calls.append("shutdown")
        self.httpd.server_close()

    monkeypatch.setattr(PreviewServer, "serve_forever", serve)
    monkeypatch.setattr(PreviewServer, "shutdown", shutdown)
    assert cli.main(["preview", path, "--port", "0", "--device", "cpu"]) == 0
    assert calls == ["serve", "shutdown"]
