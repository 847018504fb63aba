"""Test configuration: CPU JAX with an 8-device virtual mesh so sharding
logic is exercised without accelerators, the ``gpu`` fixture for the
tests that need the card, and the reference-oracle binary fixture.

``GNUAIS_TEST_GPU=1`` keeps JAX's default platform (the GPU on a machine
with a card) for the ``-m gpu`` tier; the CPU devices stay available for
plain-chain references either way."""

import os
import subprocess
from pathlib import Path

# Must happen before any jax import anywhere in the test session.
if os.environ.get("GNUAIS_TEST_GPU") != "1":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pytest

REPO = Path(__file__).resolve().parent.parent
ORACLE_BIN = REPO / ".oracle" / "build" / "gnuais_oracle"
REFERENCE_DIR = Path(os.environ.get("REFERENCE_DIR", "/root/reference"))


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU; skips the test otherwise
    (decided here, at run time, never while modules are imported)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform} "
                    "(run with GNUAIS_TEST_GPU=1 on a machine with a card)")
    return dev


@pytest.fixture(scope="session")
def oracle_bin():
    """Path to the reference gnuais binary; builds it on first use.
    Skips oracle-parity tests when the reference tree is unavailable."""
    if not ORACLE_BIN.exists():
        if not REFERENCE_DIR.exists():
            pytest.skip("reference tree not available for oracle build")
        subprocess.run(
            ["bash", str(REPO / "tools" / "build_oracle.sh")],
            check=True, capture_output=True,
        )
    return ORACLE_BIN
