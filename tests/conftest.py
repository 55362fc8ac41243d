"""Test harness configuration.

Tests run on CPU with a virtual 8-device mesh (the multi-chip pattern the
reference lacks entirely — SURVEY.md §4 "multi-node testing: N/A") and with
x64 enabled so parity tests against the float64 serial oracle are tight:

    JAX_PLATFORMS=cpu python -m pytest tests/ -q

Tests that need a GPU carry the `gpu` marker (registered below) and
request the `gpu_device` fixture, which skips them when no card is present.
The decision is made inside the fixture, never at import or collection, so
every xdist worker collects the same tests. `python chip_smoke.py` runs
what they check on the card.
"""

import os

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# persistent compilation cache (utils/cache.py): repeated test sessions and
# the CLI subprocess smoke tests skip recompiles
from gp_compressor_jax.utils.cache import setup_compilation_cache  # noqa: E402

setup_compilation_cache(min_compile_secs=1.0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (skips through the gpu_device fixture "
        "when none is present)")


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when this process has none (the suite pins
    JAX to the CPU, so a GPU test runs only in a process that does not)."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU; `python chip_smoke.py` runs this check "
                    "on the card")
    return devs[0]
