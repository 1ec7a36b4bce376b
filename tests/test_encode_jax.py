"""Differential tests: jittable encoder vs the scalar oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

from lzw_jax.ops import bitpack, encode, reference as oracle
from lzw_jax.spec import CodeSizeStrategy, Endianness, LzwSpec

GIF2 = LzwSpec.gif(2)
GIF7 = LzwSpec.gif(7)
TIFF = LzwSpec.tiff()
FIXED_LE = LzwSpec.fixed(Endianness.LITTLE)
FIXED_BE = LzwSpec.fixed(Endianness.BIG)

ALL_SPECS = [GIF2, GIF7, TIFF, FIXED_LE, FIXED_BE,
             LzwSpec.variable(4, Endianness.BIG, CodeSizeStrategy.TIFF)]
SPEC_IDS = ["gif2", "gif7", "tiff", "fixed_le", "fixed_be", "var4_be_tiff"]


def encode_via_jax(data: bytes, spec: LzwSpec, block_size: int | None = None):
    B = block_size or max(1, len(data))
    block = np.zeros(B, dtype=np.uint8)
    block[: len(data)] = np.frombuffer(data, np.uint8)
    out = encode.encode_block(jnp.asarray(block), jnp.int32(len(data)), spec)
    assert int(out["error"]) == encode.ERR_NONE
    codes = np.asarray(out["codes"])
    widths = np.asarray(out["widths"])
    return list(zip(codes[widths > 0].tolist(), widths[widths > 0].tolist()))


@pytest.mark.parametrize("spec", ALL_SPECS, ids=SPEC_IDS)
@pytest.mark.parametrize("n", [0, 1, 2, 5, 64, 1000])
def test_random_matches_oracle(spec, n):
    rng = np.random.default_rng(1000 + n)
    hi = (1 << spec.code_size) if spec.variable else 256
    data = rng.integers(0, hi, size=n).astype(np.uint8).tobytes()
    assert encode_via_jax(data, spec) == oracle.encode_codes(data, spec)


@pytest.mark.parametrize("spec", ALL_SPECS, ids=SPEC_IDS)
def test_runs_match_oracle(spec):
    data = bytes([1] * 400 + [2] * 200 + [1, 2, 3] * 100)
    assert encode_via_jax(data, spec) == oracle.encode_codes(data, spec)


def test_padding_is_inert():
    data = bytes([0, 0, 1, 3])
    assert encode_via_jax(data, GIF2, block_size=64) == oracle.encode_codes(
        data, GIF2
    )


def test_golden_lorem_ipsum(lorem_ipsum, lorem_ipsum_encoded):
    pairs = encode_via_jax(lorem_ipsum, GIF7)
    codes = np.array([c for c, _ in pairs])
    widths = np.array([w for _, w in pairs])
    packed = bytes(bitpack.pack_codes_np(codes, widths, Endianness.LITTLE))
    assert packed == lorem_ipsum_encoded


def test_dictionary_reset_stream():
    # Random bytes at cs=8 overflow the table -> CLEAR-at-12-bits path.
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, size=30000).astype(np.uint8).tobytes()
    for spec in (LzwSpec.variable(8, Endianness.LITTLE),
                 LzwSpec.variable(8, Endianness.BIG, CodeSizeStrategy.TIFF)):
        assert encode_via_jax(data, spec) == oracle.encode_codes(data, spec)


def test_unexpected_code_reported():
    data = bytes([0, 1, 8, 3])
    block = jnp.asarray(np.frombuffer(data, np.uint8))
    out = encode.encode_block(block, jnp.int32(4), GIF2)
    assert int(out["error"]) == encode.ERR_UNEXPECTED_CODE
    assert int(out["error_code"]) == 8
    assert int(out["error_pos"]) == 2


def test_first_byte_not_checked():
    # Mirrors the reference: the first byte bypasses the range check.
    block = jnp.asarray(np.array([200], np.uint8))
    out = encode.encode_block(block, jnp.int32(1), GIF2)
    assert int(out["error"]) == encode.ERR_NONE


def test_vmap_over_blocks():
    import jax

    rng = np.random.default_rng(9)
    blocks = rng.integers(0, 128, size=(6, 256)).astype(np.uint8)
    lens = np.array([256, 100, 0, 1, 255, 17], np.int32)
    out = jax.vmap(lambda b, n: encode.encode_block(b, n, GIF7))(
        jnp.asarray(blocks), jnp.asarray(lens)
    )
    for i in range(6):
        widths = np.asarray(out["widths"][i])
        codes = np.asarray(out["codes"][i])
        got = list(zip(codes[widths > 0].tolist(), widths[widths > 0].tolist()))
        expected = oracle.encode_codes(
            blocks[i, : lens[i]].tobytes(), GIF7
        )
        assert got == expected, f"block {i}"
