"""A per-test deadline: a test that runs past DEADLINE_S fails by name.

Why (ROADMAP C6): the JAX reference's native LZMA parse, on two threads,
deadlocks inside C on some inputs. No Python signal handler runs until a C call
returns, and pytest's ``faulthandler_timeout`` only dumps the stack. A
thread still runs, since ctypes drops the GIL during the foreign call.
So each test gets a watchdog thread. Past the deadline it writes the
test's node id and every thread's stack to a record file and to stderr,
then ends the process with ``os._exit(1)``.

Under pytest-xdist the crash makes ``--dist loadfile`` hand the rest of
the test's file to a new worker, the hung test included. That worker
finds the record and fails the test by name instead of running it again,
so the run goes on. Without xdist the exit ends the session, after the
stack dump that names the test.

xdist's loadfile scheduler also hands back every file the crashed worker
had finished. A new worker given a finished file has nothing to run and
is never asked again, so once the other workers are done the run waits
forever. ``pytest_handlecrashitem`` drops the finished files first.

This module imports nothing of jax: ``tests/conftest.py`` and
``tests/test_tier1_deadline.py``'s temporary suites register it as a
plugin.
"""
import contextlib
import faulthandler
import hashlib
import os
import tempfile
import threading

import pytest

DEADLINE_S = 300  # ~2.5x the longest test of a whole tier-1 run (117 s)

_stderr = None  # a copy of fd 2, taken while pytest does not capture it


def _record_path(nodeid):
    # One directory per run, so a record never outlives its run: xdist's
    # workers share PYTEST_XDIST_TESTRUNUID, a plain run keys by its pid.
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID", f"pid{os.getpid()}")
    name = hashlib.sha1(nodeid.encode()).hexdigest()[:16] + ".txt"
    return os.path.join(tempfile.gettempdir(), f"pytest-deadline-{run}", name)


def _watch(nodeid, done):
    if done.wait(DEADLINE_S):
        return
    path = _record_path(nodeid)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w+") as f:
        f.write(f"{nodeid} ran past the {DEADLINE_S} s test deadline and "
                "its process exited. Stacks at the deadline:\n")
        f.flush()
        faulthandler.dump_traceback(f, all_threads=True)
        f.seek(0)
        os.write(_stderr, f.read().encode())
    os._exit(1)


def pytest_configure(config):
    global _stderr
    _stderr = os.dup(2)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    done = threading.Event()
    threading.Thread(target=_watch, args=(item.nodeid, done),
                     name="test-deadline", daemon=True).start()
    try:
        yield
    finally:
        done.set()


@pytest.hookimpl(tryfirst=True)
def pytest_runtest_call(item):
    path = _record_path(item.nodeid)
    if os.path.exists(path):
        with open(path) as f:
            record = f.read()
        os.remove(path)
        with contextlib.suppress(OSError):
            os.rmdir(os.path.dirname(path))
        pytest.fail(record, pytrace=False)


@pytest.hookimpl(optionalhook=True)
def pytest_handlecrashitem(crashitem, report, sched):
    queue = getattr(sched, "workqueue", None)  # loadscope and loadfile
    for scope, unit in list((queue or {}).items()):
        if all(unit.values()):
            del queue[scope]
