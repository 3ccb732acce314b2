"""Test configuration.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``) with 8 virtual devices,
so the mesh-sharded engine is exercised without several GPUs. Tests marked
``chip`` need an NVIDIA GPU: they take the ``gpu`` fixture, skip elsewhere,
and run on the card with ``python -m pytest -m chip tests/`` (chip_smoke.py
runs them first). Env vars must be set before jax is imported.
"""
import os
import pathlib

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import pytest  # noqa: E402

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
REF_TOY = FIXTURES / "ref_toy"
TOY_SIGS = pathlib.Path("/root/reference/test/toy")


@pytest.fixture(scope="session")
def ref_toy_dir():
    return REF_TOY


@pytest.fixture(scope="session")
def toy_sig_dir():
    if not TOY_SIGS.exists():
        pytest.skip("reference toy signatures not available")
    return TOY_SIGS


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU (decided when
    the test runs, never at import)."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: python -m pytest -m chip tests/")
