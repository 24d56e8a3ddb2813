"""What the benchmark may import and read."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
SOURCES = sorted(p for p in BENCH.rglob("*.py") if not p.name.startswith("test_"))


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "tiler_tpu"}
    text = path.read_text()
    assert "bench.py" not in text.replace("gtm_bench", "")
    assert "BENCH_" not in text


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "tiler_tpu_torch" not in top_level_imports(path)


def test_a_run_loads_no_forbidden_module():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); import gtm_bench.run as r, gtm_bench.judge, "
            "gtm_bench.window, gtm_bench.trace, gtm_bench.control, gtm_bench.faults, "
            "tiler_tpu_torch.pipeline.encoder; print(r.forbidden_modules())") % str(BENCH.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
