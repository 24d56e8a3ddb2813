"""The plain decoder against streams the port writes on the CPU."""
import lzma as stdlib_lzma
import os

import numpy as np
import pytest
import torch

from gtm_bench import window
from gtm_bench.reference import gtm_decode, lzma, psnr_hvs
from tiler_tpu_torch.bitstream.gtm import GTMDecoder
from tiler_tpu_torch.config import EncoderSettings
from tiler_tpu_torch.utils.clips import synthetic_clip


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    clip = synthetic_clip(4, 64, 128, 3)
    path = str(tmp_path_factory.mktemp("gtm") / "small.gtm")
    enc, _ = window.encode_once(EncoderSettings(palette_count=16), clip, 25.0, path, "cpu")
    with open(path, "rb") as fh:
        return clip, fh.read(), window.final_state(enc), enc


def test_reads_every_frame_at_the_clip_size(encoded):
    clip, raw, _, _ = encoded
    st, frames = gtm_decode.decode(raw)
    assert frames.shape == clip.shape and st.header["frame_count"] == len(clip)
    assert (st.width, st.height) == (clip.shape[2], clip.shape[1])


def test_equals_the_port_decoder(encoded):
    _, raw, _, _ = encoded
    _, frames = gtm_decode.decode(raw)
    assert np.array_equal(frames, np.stack(GTMDecoder(raw).decode_frames())[..., :3])


def test_the_state_renders_as_its_stream(encoded):
    _, raw, s, _ = encoded
    _, frames = gtm_decode.decode(raw)
    want = gtm_decode.render_state(s["tilemap"], s["tiles"].numpy(), s["palettes"].numpy(),
                                   s["valid"].numpy(), s["height"], s["width"])
    assert np.array_equal(want, frames)


def test_psnr_hvs_near_the_encoders_own_figure(encoded):
    clip, raw, _, enc = encoded
    _, frames = gtm_decode.decode(raw)
    mse = psnr_hvs.per_cell_mse(torch.as_tensor(frames), torch.as_tensor(clip))
    assert abs(psnr_hvs.psnr_hvs(mse) - enc.state.total_psnr) < 1.0
    assert psnr_hvs.psnr_hvs(psnr_hvs.per_cell_mse(torch.as_tensor(clip), torch.as_tensor(clip))) == \
        pytest.approx(10 * np.log10(255 ** 2 / 0.5))


def test_a_corrupt_stream_raises(encoded):
    _, raw, _, _ = encoded
    bad = bytearray(raw)
    bad[len(bad) // 2] ^= 0xFF
    with pytest.raises(ValueError):
        gtm_decode.decode(bytes(bad[: len(bad) // 2 + 8]))


@pytest.mark.parametrize("lc,lp,pb", [(3, 0, 2), (0, 2, 0), (4, 0, 4)])
def test_lzma_matches_the_stdlib(lc, lp, pb):
    data = os.urandom(3000) * 20 + bytes(range(256)) * 50
    comp = stdlib_lzma.LZMACompressor(format=stdlib_lzma.FORMAT_ALONE, filters=[
        {"id": stdlib_lzma.FILTER_LZMA1, "lc": lc, "lp": lp, "pb": pb, "dict_size": 1 << 20}])
    blob = comp.compress(data) + comp.flush()
    assert lzma.split_streams(blob + blob) == [data, data]
