"""Test config: force CPU backend with 8 virtual devices so multi-device
sharding paths compile/execute without accelerator hardware.

Tests that need the card carry the `gpu` marker and take the `gpu_host`
fixture, which skips them where no NVIDIA GPU is found (decided when the
test runs, never at import: every xdist worker must collect the same
tests).  Run them on a GPU host with `python -m pytest tests/ -m gpu`."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
# don't let throwaway test managers spend CPU warming neighbor-settings
# shapes (tests that exercise the warmer enable it explicitly)
os.environ.setdefault("THESIA_PRECOMPILE", "0")
# synchronous settings switches by default: the suite's hundreds of
# set_spec_setting call sites assert the post-switch state immediately.
# The deferred production path has dedicated tests (test_session.py passes
# defer=True explicitly).
os.environ.setdefault("THESIA_DEFER_SETTINGS", "0")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# the suite runs on the virtual 8-device CPU mesh even where a GPU plugin
# is installed and would otherwise be picked
jax.config.update("jax_platforms", "cpu")

import pathlib
import shutil
import subprocess

import pytest

SAMPLES_DIR = pathlib.Path("/root/reference/samples")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere (see gpu_host)"
    )


@pytest.fixture(scope="session")
def samples_dir():
    return SAMPLES_DIR


@pytest.fixture
def gpu_host():
    """Skip unless this host has an NVIDIA GPU (nvidia-smi lists one)."""
    smi = shutil.which("nvidia-smi")
    found = smi is not None and subprocess.run(
        [smi, "-L"], capture_output=True, text=True
    ).stdout.startswith("GPU")
    if not found:
        pytest.skip("no NVIDIA GPU on this host")
