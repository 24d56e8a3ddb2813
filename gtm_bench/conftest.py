"""pytest settings for the benchmark's own tests (``test_gtm_bench_*.py``)."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")
