"""Test harness configuration.

Tests run hardware-independent, mirroring how the reference keeps its whole
suite runnable on any CI box: we force the CPU backend with a virtual 8-device
mesh so the multi-device sharding paths (shard_map over a Mesh) are exercised
without several accelerators.  The block kernels run in the Pallas
interpreter there.

Tests marked ``gpu`` need the card; they skip on the CPU.  Run them on a GPU
host with ``LZW_JAX_TEST_GPU=1 python -m pytest tests/ -m gpu``, which leaves
the platform to JAX.

Must set env vars before jax is imported anywhere.
"""

import os
import pathlib

ON_GPU = os.environ.get("LZW_JAX_TEST_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import pytest

ASSETS = pathlib.Path(__file__).resolve().parent.parent / "test-assets"


@pytest.fixture
def gpu():
    """The first GPU; skips the test where JAX has none."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {device.platform}")
    return device


@pytest.fixture(scope="session")
def lorem_ipsum() -> bytes:
    return (ASSETS / "lorem_ipsum.txt").read_bytes()


@pytest.fixture(scope="session")
def lorem_ipsum_encoded() -> bytes:
    """Golden ciphertext: variable LE cs=7 encode of lorem_ipsum.txt."""
    return (ASSETS / "lorem_ipsum_encoded.bin").read_bytes()


@pytest.fixture(scope="session")
def tokyo_pixels() -> bytes:
    """Indexed pixel data (values 0..128) of tokyo_128_colors.png.

    The reference benchmarks on the decoded index plane
    (`benches/compare_crates.rs:276-287`); we decode the PNG the same way.
    """
    from lzw_jax.utils.corpus import load_tokyo_pixels

    return load_tokyo_pixels(ASSETS / "tokyo_128_colors.png")


@pytest.fixture(scope="session")
def sunflower_bytes() -> bytes:
    return (ASSETS / "sunflower.bmp").read_bytes()
