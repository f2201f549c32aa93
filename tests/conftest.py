"""Test configuration: run on CPU with 8 virtual devices so multi-device
sharding paths are exercised without accelerator hardware.

The suite runs on the CPU unless ``JAX_PLATFORMS`` names another platform
(``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu`` runs the
card-only tests on a GPU machine).  Card-only tests carry the ``gpu`` marker
and take the ``gpu_device`` fixture, which skips them when JAX's default
device is not a GPU; the decision is made when the fixture runs, never at
import or collection time, so every test worker collects the same tests.
"""

import os
import sys
from pathlib import Path

import pytest

# Make the repo root (bench.py, chip_smoke.py, __graft_entry__.py) and tests/
# (shared helpers like qary_reference) importable regardless of
# invocation mode/cwd.
_ROOT = Path(__file__).resolve().parent.parent
for _p in (str(_ROOT), str(_ROOT / "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The default device, for tests that need a GPU; skips without one."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a GPU; the default device is {device.platform}")
    return device
