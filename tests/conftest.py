"""Test env: JAX on the CPU with 8 fake devices, set BEFORE backends init.

SURVEY.md §4 item 3: `--xla_force_host_platform_device_count=8` runs real
shard_map collectives on CPU — the JAX analog of a fake distributed backend.
Device performance is measured by chip_smoke.py and bench.py on the card,
not by the unit suite.

Tests marked ``gpu`` need the card. They skip (inside the fixture below)
unless JAX's backend is the GPU, which needs an explicit
``JAX_PLATFORMS=cuda``: ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.

Env vars alone are not enough: pytest plugins may import jax before this
conftest, so the config is also set through jax.config (safe as long as no
backend has been initialized yet, which plugins don't do).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
# x64 so parity tests can run the device path in float64 against the float64
# oracle (SURVEY.md §4 item 1); production code uses explicit float32 dtypes.
jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX runs on the GPU (decided here,
    per test, never at import)."""
    if request.node.get_closest_marker("gpu") is not None and \
            jax.default_backend() != "gpu":
        pytest.skip("needs the GPU backend (JAX_PLATFORMS=cuda on a card)")
