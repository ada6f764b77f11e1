"""Test configuration: run on a virtual 8-device CPU mesh with float64.

Numerical-parity tests (Gram matrices, likelihoods, MLE optima) need f64;
the GPU path runs f32 separately through `chip_smoke.py`. Tests that need
the card carry the `gpu` marker and decide inside the test (never at
import) whether one is present.
"""
import os

# Must be set before jax initializes its backends.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long e2e/experiment tests, skipped in the default lane "
        "(run them with RUN_SLOW=1 or -m slow)")
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skips on a CPU-only host (the same "
        "checks run on the card as a phase of chip_smoke.py)")


def pytest_collection_modifyitems(config, items):
    """Keep the default `pytest tests/` lane under ~10 minutes: slow
    e2e/experiment tests run only with RUN_SLOW=1 or an explicit -m."""
    if os.environ.get("RUN_SLOW") or config.getoption("-m"):
        return
    skip = pytest.mark.skip(
        reason="slow lane: set RUN_SLOW=1 (or -m slow) to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def reference_data():
    """Root of the reference case-study files; skips the requesting test
    when they are not on this machine (they are not part of the repo)."""
    from ccgp_tpu.eval.datasets import data_root

    try:
        return data_root()
    except FileNotFoundError as e:
        pytest.skip(f"reference data absent: {e}")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the requesting test when JAX sees none.

    This suite forces the CPU backend, so on the card the same checks run
    as a phase of `chip_smoke.py`, which calls the functions these tests
    call."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("no GPU visible to JAX")
    return devs[0]
