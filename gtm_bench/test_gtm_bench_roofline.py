"""The bound arithmetic at PERF.md section 6's launch shapes."""
import pytest
import torch

from gtm_bench import roofline


def test_knn_bound_at_the_default_launch():
    s, by = roofline.knn_bound(8192, 116097, 208, 118784)
    assert by == "operations" and s * 1e3 == pytest.approx(0.3692, abs=5e-4)


@pytest.mark.parametrize("T,P,S,ms", [(116097, 1024, 16, 1.590), (36307, 16, 256, 7.955)])
def test_tk_bound_on_full_palettes(T, P, S, ms):
    pix = torch.zeros(T, 64, 3, dtype=torch.uint8)
    mirror = torch.zeros(T, dtype=torch.uint8)
    pal_idx = torch.arange(T, dtype=torch.int32) % P
    table = torch.ones(P, S, 8, dtype=torch.int32)
    s, by = roofline.tk_bound(pix, mirror, pal_idx, table)
    assert by == "operations" and s * 1e3 == pytest.approx(ms, abs=1e-3)


def test_tk_bound_counts_valid_colors_only():
    pix = torch.zeros(100, 64, 3, dtype=torch.uint8)
    table = torch.ones(2, 16, 8, dtype=torch.int32)
    table[1, 8:, 4] = 0
    full = roofline.tk_bound(pix, pix[:, 0, 0], torch.zeros(100, dtype=torch.int32), table)[0]
    half = roofline.tk_bound(pix, pix[:, 0, 0], torch.ones(100, dtype=torch.int32), table)[0]
    assert half == pytest.approx(full / 2)


def test_bytes_bound_when_there_is_no_work():
    s, by = roofline.bound_s(3.35e12, 1.0, roofline.BF16_OPS)
    assert by == "bytes" and s == pytest.approx(1.0)
