"""Test harness: force an 8-virtual-device CPU platform before jax import.

Multi-device sharding paths are validated on this virtual mesh;
numerical tests are platform-agnostic.  Pallas kernels run here in
interpret mode; ``python chip_smoke.py`` drives their compiled GPU form
and the whole pipeline on the card.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# NO persistent compilation cache for the CPU suite: serializing the large
# chunked-stepping executable SIGSEGVs inside XLA:CPU AOT export (jax
# 0.9.0 — crash in put_executable_and_time), and entries written on one
# machine SIGILL/SIGSEGV when loaded on another with different CPU
# features.  Cold compiles cost a few extra minutes per run; a crashing
# suite costs everything.


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long end-to-end endurance scenarios"
    )


@pytest.fixture()
def rng():
    # fresh per test: keeps every test deterministic and order-independent
    return np.random.RandomState(0)
