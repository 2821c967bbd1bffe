"""Test configuration: run JAX on CPU with 8 virtual devices so the
multi-device sharding paths run without GPUs.

Tests marked `gpu` need the card (compiled Triton kernels have no CPU
backend); they decide inside the test whether a GPU exists and skip here.
On a GPU machine `python -m pytest tests -m gpu` leaves JAX on its default
platform and runs just them; `python chip_smoke.py` runs them the same
way in its own process and checks the same kernels at full size.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402


def pytest_configure(config):
    if config.option.markexpr.strip() != "gpu":
        jax.config.update("jax_platforms", "cpu")
    config.addinivalue_line(
        "markers",
        "slow: long-running golden renders (deselect with -m 'not slow')")
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU; skips where JAX finds none (run on the card with "
        "-m gpu)")
