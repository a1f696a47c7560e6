"""Repo-level pytest configuration.

Tests run on the CPU backend with a *virtual 8-device mesh*
(``--xla_force_host_platform_device_count=8``) so multi-device sharding
paths compile and execute without accelerator hardware, and with x64
enabled so reference (NumPy float64) parity tolerances of <=1e-9 are
meaningful.

Tests marked ``gpu`` need a GPU backend: they skip elsewhere (decided in a
fixture, never at import).  The GPU lane runs them alone, in one process:
``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu -p no:xdist``.

This must run before JAX initializes a backend, hence the module-level
side effects.
"""

import os
import sys

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

import pytest  # noqa: E402

# CPU unless the caller names the platforms (the GPU lane does)
if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Persistent compilation cache (utils/precision.compile_cache_dir): XLA:CPU
# is slow compiling the df32 (two-float) programs; cache them across runs.
from psa_simulation_ode_rk_mvp_dispersion.utils.precision import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU backend (skips elsewhere)")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip(f"needs a GPU backend, not {jax.default_backend()!r}")
