"""The one clip generator: seeded, and ``retro`` equal to the port's
synthetic_clip byte for byte."""
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from gtm_bench import clipgen
from tiler_tpu_torch.utils.clips import synthetic_clip

TRAFFIC = Path(__file__).resolve().parent / "traffic"


def traffic(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 977])
def test_retro_is_synthetic_clip(seed):
    got = clipgen.make_clip(traffic("retro"), 5, 72, 136, seed)
    assert np.array_equal(got, synthetic_clip(5, 72, 136, seed))


@pytest.mark.parametrize("name", ["retro", "grain"])
def test_deterministic_from_the_seed(name):
    a = clipgen.make_clip(traffic(name), 4, 64, 96, 2**31 + 5)
    b = clipgen.make_clip(traffic(name), 4, 64, 96, 2**31 + 5)
    c = clipgen.make_clip(traffic(name), 4, 64, 96, 2**31 + 6)
    assert a.dtype == np.uint8 and a.shape == (4, 64, 96, 3)
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_grain_redraws_its_noise_every_frame():
    retro = clipgen.make_clip(traffic("retro"), 3, 64, 96, 11)
    grain = clipgen.make_clip(traffic("grain"), 3, 64, 96, 11)
    assert np.array_equal(retro[0], grain[0])
    assert not np.array_equal(retro[1], grain[1])
    # same scene, same amplitude: the frames differ from the retro ones by
    # the difference of two noises, never by more than its range
    diff = (grain.astype(int) - retro.astype(int)) % 256
    assert np.isin(diff, list(range(0, 30)) + list(range(256 - 29, 256))).all()


def test_grain_frames_are_those_the_limits_were_read_on():
    # sha256 of the frames the limits and bounds were measured on
    got = clipgen.make_clip(traffic("grain"), 4, 64, 96, 2**31 + 5)
    assert hashlib.sha256(got.tobytes()).hexdigest() == (
        "0d354747351552bc972c352c923974121642ee0b73f1cad8bdd81b427fbd11fe")


def _one_shot(**shot):
    return {"shot_frames": 0, "shots": [shot]}


def test_scene_cuts_restart_each_shot_and_go_round_the_list():
    a = dict(background={"kind": "gradient"}, scroll=[3, 5],
             sprites=[{"size": 8, "rgb": [9, 9, 9], "x0": 1, "dx": 2, "y0": 3, "dy": 1}])
    b = dict(background={"kind": "plasma", "waves": 3, "period": 16.0}, scroll=[0, 2])
    cut = clipgen.make_clip({"shot_frames": 3, "shots": [a, b]}, 8, 32, 48, 1)
    only_a = clipgen.make_clip(_one_shot(**a), 3, 32, 48, 1)
    only_b = clipgen.make_clip(_one_shot(**b), 3, 32, 48, 1)
    assert np.array_equal(cut[0:3], only_a) and np.array_equal(cut[3:6], only_b)
    assert np.array_equal(cut[6:8], only_a[:2])


def test_plasma_is_seeded():
    shot = dict(background={"kind": "plasma", "waves": 4, "period": 24.0})
    a = clipgen.make_clip(_one_shot(**shot), 2, 40, 56, 2**31 + 1)
    assert np.array_equal(a, clipgen.make_clip(_one_shot(**shot), 2, 40, 56, 2**31 + 1))
    assert not np.array_equal(a, clipgen.make_clip(_one_shot(**shot), 2, 40, 56, 2**31 + 2))
    assert a.std() > 10


@pytest.mark.parametrize("chroma", ["420jpeg", "444"])
def test_a_y4m_clip_is_read_cropped_and_looped(tmp_path, chroma):
    W, H, n = 24, 20, 2
    sub = 2 if chroma.startswith("420") else 1
    rng = np.random.RandomState(3)
    body = b""
    planes = []
    for _ in range(n):
        y = rng.randint(0, 256, (H, W)).astype(np.uint8)
        uv = np.full((2, H // sub, W // sub), 128, np.uint8)
        planes.append(y)
        body += b"FRAME\n" + y.tobytes() + uv.tobytes()
    path = tmp_path / "clip.y4m"
    path.write_bytes(f"YUV4MPEG2 W{W} H{H} F25:1 Ip A1:1 C{chroma}\n".encode() + body)
    clip = clipgen.make_clip(_one_shot(background={"kind": "y4m", "file": str(path)}),
                             3, 16, 16, 0)
    assert clip.shape == (3, 16, 16, 3)
    for f in range(3):  # grey: R = G = B = Y
        for c in range(3):
            assert np.array_equal(clip[f, ..., c], planes[f % n][:16, :16])
