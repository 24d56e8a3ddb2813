"""The per-test deadline (tests/_deadline.py), run on small suites.

Each case writes a temporary suite whose conftest registers the deadline
with DEADLINE_S = 3 and runs it with ``python -m pytest`` in a process of
its own. The suite imports nothing of jax. The test that hangs blocks in
C, as the reference's LZMA deadlock does (ROADMAP C6): ``pause()``
through ctypes, which drops the GIL.
"""
import os
import re
import signal
import subprocess
import sys
import textwrap
import time
import xml.etree.ElementTree as ET

import pytest

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
RUN_LIMIT_S = 60

CONFTEST = f"""
import sys
sys.path.insert(0, {TESTS_DIR!r})
import _deadline
_deadline.DEADLINE_S = 3


def pytest_configure(config):
    config.pluginmanager.register(_deadline, "deadline")
"""

HANGS = """
import ctypes


def test_before():
    pass


def test_block():
    ctypes.CDLL(None).pause()


def test_after():
    pass
"""

OTHER_FILE = """
def test_other():
    pass
"""

# --dist loadfile hands out the files with the most tests first, so each
# worker finishes one of test_0.py and test_1.py before it takes test_a.py
# or test_b.py: the worker that hangs has finished a file before.
FOUR = "".join(f"def test_{i}():\n    pass\n\n\n" for i in "wxyz")
XDIST_SUITE = {"test_0.py": FOUR, "test_1.py": FOUR,
               "test_a.py": HANGS, "test_b.py": OTHER_FILE}

QUIET = """
import time


def test_fast():
    pass


def test_sleep_1():
    time.sleep(1.5)


def test_sleep_2():
    time.sleep(1.5)


def test_sleep_3():
    time.sleep(1.5)
"""

XDIST = ["-p", "xdist", "-n", "2", "--dist", "loadfile"]


def _run(tmp_path, files, args):
    """Runs pytest on the suite in a temporary directory of its own.

    Returns the exit code, the output, each test's outcomes and failure
    text by name, the seconds it took, and the deadline records left in
    its temporary directory."""
    suite = tmp_path / "suite"
    suite.mkdir()
    (suite / "pytest.ini").write_text("[pytest]\n")
    (suite / "conftest.py").write_text(CONFTEST)
    for name, text in files.items():
        (suite / name).write_text(textwrap.dedent(text))
    temp = tmp_path / "tmp"
    temp.mkdir()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTEST_XDIST_", "PYTEST_CURRENT_TEST"))}
    env["TMPDIR"] = str(temp)
    xml = tmp_path / "report.xml"
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
           "-p", "no:randomly", f"--junitxml={xml}", *args]
    t0 = time.monotonic()
    proc = subprocess.Popen(cmd, cwd=suite, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=RUN_LIMIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"the run did not end within {RUN_LIMIT_S} s:\n{out}")
    seconds = time.monotonic() - t0
    outcomes, failures = {}, {}
    if xml.exists():
        for case in ET.parse(xml).iter("testcase"):
            name = case.get("name")
            kinds = [c.tag for c in case
                     if c.tag in ("failure", "error", "skipped")]
            outcomes.setdefault(name, []).extend(kinds or ["passed"])
            for c in case.iter("failure"):
                failures[name] = (c.get("message") or "") + (c.text or "")
    leftovers = [p.name for p in temp.iterdir()
                 if p.name.startswith("pytest-deadline-")]
    return proc.returncode, out, outcomes, failures, seconds, leftovers


def test_hung_test_fails_by_name_and_the_run_goes_on(tmp_path):
    """The worker that hangs is replaced; the new one fails the hung test
    by name and runs the rest of its file. Without the crash-item hook
    the new worker would be handed test_0.py or test_1.py again, finished
    already, and the run would wait until RUN_LIMIT_S."""
    rc, out, outcomes, failures, seconds, leftovers = _run(
        tmp_path, XDIST_SUITE, XDIST)
    assert seconds < RUN_LIMIT_S
    assert rc == 1, out
    # xdist reports the crash (an error) and the replacement worker's
    # named failure; the hung test never reads as passed or skipped
    assert sorted(outcomes["test_block"]) == ["error", "failure"], out
    assert "test_a.py::test_block ran past the 3 s" in failures["test_block"]
    assert "in test_block" in failures["test_block"]
    assert len(re.findall(r"\[gw\d+\] node down", out)) == 1, out
    # the neighbours, file B, and both finished files, once each
    others = [k for name, kinds in outcomes.items() if name != "test_block"
              for k in kinds]
    assert others == ["passed"] * 11, out
    assert outcomes["test_after"] == ["passed"], out
    assert leftovers == []  # the replacement consumed the record


def test_plain_run_exits_with_the_stack(tmp_path):
    rc, out, outcomes, _, seconds, _ = _run(
        tmp_path, {"test_a.py": HANGS}, [])
    assert seconds < RUN_LIMIT_S
    assert rc != 0
    assert "test_a.py::test_block ran past the 3 s" in out
    assert re.search(r'test_a\.py", line \d+ in test_block', out), out


@pytest.mark.parametrize("args", [[], XDIST], ids=["plain", "xdist"])
def test_quiet_run_leaves_no_record(tmp_path, args):
    """Tests under the deadline pass, however long the run: each test's
    clock starts anew (three 1.5 s sleeps run past 3 s together)."""
    rc, out, outcomes, _, seconds, leftovers = _run(
        tmp_path, {"test_q.py": QUIET}, args)
    assert seconds < RUN_LIMIT_S
    assert rc == 0, out
    assert all(kinds == ["passed"] for kinds in outcomes.values()), out
    assert len(outcomes) == 4
    assert leftovers == []
