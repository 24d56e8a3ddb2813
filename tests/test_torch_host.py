"""The port's own copies of the host side against tiler_tpu's originals,
and the rule that the port imports nothing of the JAX package.

- settings: the same fields and defaults, the same parse of an .ini;
- save, GTM decode and LZMA: byte-identical to the JAX package's;
- the two-thread optimal parse of the port's codec finishes on the
  payload that hangs the original (ROADMAP C6) and writes the bytes of
  one thread;
- checkpoints: the JAX package's load into the port's classes without
  importing it, and no other name of that package is unpickled;
- the disk spill: ``utils/spill.py`` and the readers' ``spill_budget``
  give what the originals give, memmaps included.

That the port and chip_smoke.py import nothing of jax, the JAX package
or bench.py is test_torch_ops.py::test_import_pulls_no_jax_or_triton;
the host modules that came with the IVF and the tooling (``pipeline/
ivf.py``, ``render.py``, ``preview.py``) are also imported one by one in
a process of their own here.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from bench import synthetic_clip
from tiler_tpu import native as j_native
from tiler_tpu.bitstream.gtm import GTMDecoder as JaxDecoder
from tiler_tpu.config import EncoderSettings as JaxSettings
from tiler_tpu.io import export as j_export
from tiler_tpu.io import video as j_video
from tiler_tpu.pipeline.save import save as jax_save
from tiler_tpu.utils import spill as j_spill
from tiler_tpu_torch import native as t_native
from tiler_tpu_torch.bitstream.gtm import GTMDecoder
from tiler_tpu_torch.io import video as t_video
from tiler_tpu_torch.config import EncoderSettings
from tiler_tpu_torch.models.convert import state_to_numpy
from tiler_tpu_torch.pipeline import encoder as t_encoder
from tiler_tpu_torch.pipeline.save import save
from tiler_tpu_torch.utils import clips
from tiler_tpu_torch.utils import spill as t_spill

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(palette_count=8, motion_predict_radius=4, epu_knn_k=8, kmeans_iters=4)

INI = """[Load]
InputFileName=clip.y4m
OutputFileName=out.gtm
StartFrame=3
Scaling=1
[Dither]
PaletteCount=64
PaletteSize=8
DitheringMode=4
DitheringUseThomasKnoll=True
[GlobalTiling]
GlobalTilingQualityBasedTileCount=3.5
[TPU]
MotionField=im2row
KnnBackend=pallas_v1
EpuKnnK=32
"""


@pytest.mark.parametrize("text", [None, INI], ids=["defaults", "ini"])
def test_settings_equal_the_reference(text):
    port = EncoderSettings.from_ini(text) if text else EncoderSettings()
    ref = JaxSettings.from_ini(text) if text else JaxSettings()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.to_ini() == ref.to_ini()


_IMPORT_ONE = """
import importlib, sys
importlib.import_module(sys.argv[1])
print(sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "tiler_tpu", "bench")))
"""


@pytest.mark.parametrize("module", ["tiler_tpu_torch.pipeline.ivf", "tiler_tpu_torch.render",
                                    "tiler_tpu_torch.preview"])
def test_host_module_imports_no_jax(module):
    out = subprocess.run([sys.executable, "-c", _IMPORT_ONE, module], capture_output=True,
                         text=True, check=True, cwd=ROOT, timeout=120).stdout
    assert out.strip() == "[]", out


def test_synthetic_clip_is_the_benchmark_clip():
    for args in ((3, 64, 96, 0), (2, 40, 48, 5)):
        assert np.array_equal(clips.synthetic_clip(*args), synthetic_clip(*args))


@pytest.fixture(scope="module")
def encoded_state():
    """A small clip through the port on the CPU, up to the writer."""
    enc = t_encoder.Encoder(EncoderSettings(**SMALL), log=None, device="cpu")
    enc.load_frames(synthetic_clip(6, 64, 96, seed=0), 25.0)
    enc.predict_motion().reduce().prepare_palettes().dither().reconstruct().reindex()
    return state_to_numpy(enc.state)


def test_save_and_decode_byte_identical(encoded_state, tmp_path):
    mine, ref = tmp_path / "port.gtm", tmp_path / "jax.gtm"
    stats = save(encoded_state, EncoderSettings(**SMALL), str(mine))
    jstats = jax_save(encoded_state, JaxSettings(**SMALL), str(ref))
    assert mine.read_bytes() == ref.read_bytes()
    assert stats.total_bytes == jstats.total_bytes
    frames = GTMDecoder(str(mine)).decode_frames()
    want = JaxDecoder(str(ref)).decode_frames()
    assert len(frames) == len(want) == 6
    assert all(np.array_equal(a, b) for a, b in zip(frames, want))


def _payloads():
    rng = np.random.default_rng(0)
    return [
        b"",
        bytes(5000),
        rng.integers(0, 256, 20000, dtype=np.uint8).tobytes(),
        (rng.integers(0, 4, 300_000, dtype=np.uint8).tobytes() + bytes(70_000)
         + b"tiles" * 9000),
    ]


@pytest.mark.parametrize("i", range(4))
def test_lzma_bytes_equal_the_reference(i):
    data = _payloads()[i]
    for depth in (-2, 2):  # the optimal and the fast parse
        mine = t_native.lzma_compress(data, depth=depth, threads=1)
        assert mine == j_native.lzma_compress(data, depth=depth, threads=1)
        assert t_native.lzma_decompress_stream(mine)[0] == data


_TWO_THREADS = textwrap.dedent("""
    from tiler_tpu_torch import native
    data = bytes(2 << 20)
    one = native.lzma_compress(data, threads=1)
    for _ in range(5):
        assert native.lzma_compress(data, threads=2) == one
    assert native.lzma_decompress_stream(one)[0] == data
    print("ok", len(one))
""")


def test_two_thread_optimal_parse_finishes():
    """2 MB of zeros: the consumer emits long runs directly and gets ahead
    of the match finder, which the original read as a full ring."""
    t_native.get_lib()  # build outside the time limit
    out = subprocess.run([sys.executable, "-c", _TWO_THREADS], capture_output=True,
                         text=True, timeout=60, cwd=ROOT, check=True)
    assert out.stdout.startswith("ok")


def test_jax_checkpoint_loads_into_the_port_classes(tmp_path):
    from tiler_tpu.models import state as j_state

    st = j_state.EncodeState(fps=25.0, tilemap_w=2, tilemap_h=1)
    st.tilemap = j_state.TileMapSoA.zeros(1, 2)
    st.keyframes = [j_state.KeyFrameInfo(0, 0, 0)]
    ck = tmp_path / "jax.ckpt"
    ck.write_bytes(pickle.dumps({"state": st, "settings": JaxSettings(**SMALL)}))
    enc = t_encoder.Encoder.load_checkpoint(str(ck), log=None, device="cpu")
    assert type(enc.settings) is EncoderSettings
    assert type(enc.state).__module__ == "tiler_tpu_torch.models.state"
    assert type(enc.state.tilemap).__name__ == "TileMapSoA"
    assert type(enc.state.keyframes[0]).__module__ == "tiler_tpu_torch.models.state"
    assert enc.state.tilemap_size == 2


def test_checkpoint_refuses_other_names_of_the_jax_package(tmp_path):
    ck = tmp_path / "bad.ckpt"
    # a pickle naming tiler_tpu.pipeline.encoder.Encoder, built by hand
    ck.write_bytes(b"\x80\x04c" + b"tiler_tpu.pipeline.encoder\nEncoder\n" + b"q\x00.")
    with pytest.raises(pickle.UnpicklingError, match="tiler_tpu.pipeline.encoder"):
        t_encoder.Encoder.load_checkpoint(str(ck), log=None, device="cpu")


def test_encoder_runs_on_the_card_unless_told_otherwise():
    assert t_encoder.Encoder(log=None).device.type == "cuda"
    assert t_encoder.Encoder(log=None, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("overrides", [dict(motion_field="im2row"),
                                       dict(knn_backend="pallas_v1"),
                                       dict(motion_field="im2row", knn_backend="pallas_v1")])
def test_slice_settings_are_accepted(overrides):
    enc = t_encoder.Encoder(EncoderSettings(**overrides), log=None, device="cpu")
    assert all(getattr(enc.settings, k) == v for k, v in overrides.items())


@pytest.mark.parametrize("shape,dtype", [((3, 5, 7), np.int16), ((2, 4, 8, 8, 3), np.uint8)])
def test_spill_memmap_equals_the_reference(shape, dtype, tmp_path, monkeypatch):
    """An unlinked temp-file memmap in TILER_TPU_SPILL_DIR, in both."""
    monkeypatch.setenv("TILER_TPU_SPILL_DIR", str(tmp_path))
    got, want = t_spill.spill_memmap(shape, dtype), j_spill.spill_memmap(shape, dtype)
    for mm in (got, want):
        assert isinstance(mm, np.memmap) and mm.shape == shape and mm.dtype == dtype
        assert mm.mode == "r+" and not mm.any()
        assert os.fstat(mm._spill_file.fileno()).st_dev == os.stat(tmp_path).st_dev
    assert list(tmp_path.iterdir()) == []  # unlinked: nothing to clean up
    got[:] = 7
    assert (got == 7).all()


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """A C444 y4m (the writer's format) and a PNG sequence of 5 frames."""
    from PIL import Image

    d = tmp_path_factory.mktemp("sources")
    clip = synthetic_clip(5, 24, 40, seed=3)
    j_export.write_y4m(str(d / "clip.y4m"), clip, fps=25.0)
    for i, f in enumerate(clip):
        Image.fromarray(f).save(d / f"frame{i:03d}.png")
    return d


@pytest.mark.parametrize("name,kwargs", [
    ("clip.y4m", {}), ("clip.y4m", dict(start_frame=1, frame_count=3)),
    ("clip.y4m", dict(scaling=0.5)), ("frame%03d.png", {}),
    ("frame%03d.png", dict(start_frame=2, frame_count=2)),
])
@pytest.mark.parametrize("spill_budget", [0, 1])
def test_load_video_spill_budget_equals_the_reference(sources, name, kwargs, spill_budget):
    path = str(sources / name)
    got, fps = t_video.load_video(path, spill_budget=spill_budget, **kwargs)
    want, jfps = j_video.load_video(path, spill_budget=spill_budget, **kwargs)
    assert fps == jfps and np.array_equal(got, want)
    assert isinstance(got, np.memmap) == isinstance(want, np.memmap) == bool(spill_budget)


@pytest.mark.parametrize("spill_budget", [0, 1])
def test_load_y4m_planar_spill_budget_equals_the_reference(sources, spill_budget):
    got = t_video.load_video_planar(str(sources / "clip.y4m"), 1, 3, spill_budget)
    want = j_video.load_video_planar(str(sources / "clip.y4m"), 1, 3, spill_budget)
    for a, b in ((got.y, want.y), (got.u, want.u), (got.v, want.v)):
        assert np.array_equal(a, b)
        assert isinstance(a, np.memmap) == isinstance(b, np.memmap) == bool(spill_budget)
    assert got.fps == want.fps
