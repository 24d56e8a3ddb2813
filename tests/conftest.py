"""Test configuration shared by every test under tests/.

The JAX package is the reference the port is held against, and it runs
here on the CPU only: an 8-device virtual CPU mesh, set before jax is
imported, stands in for multi-device sharding. The port's card tests
carry the `cuda` marker registered below and skip without a card; on the
card they run with --noconftest, since this file imports jax.

Every test also gets a deadline (tests/_deadline.py): one that runs past
it fails by name and the run goes on. The reference's two-thread LZMA
parse deadlocks in C (ROADMAP C6), and without the deadline that one
test held every run until its time limit.
"""
import os

import _deadline

os.environ["JAX_PLATFORMS"] = "cpu"  # the reference runs on the CPU only
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# float64 for the exact math-invariant tests (the reference asserts exact
# colorspace/DCT round-trips in its self-test); production TPU paths use
# float32/bfloat16.
jax.config.update("jax_enable_x64", True)

# persistent compilation cache: the suite is compile-dominated otherwise
jax.config.update("jax_compilation_cache_dir", "/tmp/tiler_tpu_jax_cache")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def pytest_configure(config):
    config.pluginmanager.register(_deadline, "deadline")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")
    config.addinivalue_line(
        "markers", "slow: longer than tier-1 affords; deselected there by -m 'not slow'")
