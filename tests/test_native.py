"""Native C++ runtime: differential tests vs the oracle + threading."""

import numpy as np
import pytest

from lzw_jax.native.runtime import get_runtime, native_available
from lzw_jax.ops import reference as oracle
from lzw_jax.spec import (
    CodeSizeStrategy,
    Endianness,
    LzwSpec,
    MissingClearCodeError,
    TruncatedStreamError,
    UnexpectedCodeError,
)

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native toolchain unavailable"
)

GIF2 = LzwSpec.gif(2)
GIF7 = LzwSpec.gif(7)
TIFF = LzwSpec.tiff()
FIXED_LE = LzwSpec.fixed(Endianness.LITTLE)
FIXED_BE = LzwSpec.fixed(Endianness.BIG)
ALL_SPECS = [GIF2, GIF7, TIFF, FIXED_LE, FIXED_BE,
             LzwSpec.variable(4, Endianness.BIG, CodeSizeStrategy.TIFF)]
SPEC_IDS = ["gif2", "gif7", "tiff", "fixed_le", "fixed_be", "var4_be_tiff"]


@pytest.fixture(scope="module")
def rt():
    return get_runtime()


@pytest.mark.parametrize("spec", ALL_SPECS, ids=SPEC_IDS)
@pytest.mark.parametrize("n", [0, 1, 5, 64, 1000, 10000])
def test_encode_matches_oracle(rt, spec, n):
    rng = np.random.default_rng(2000 + n)
    hi = (1 << spec.code_size) if spec.variable else 256
    data = rng.integers(0, hi, size=n).astype(np.uint8).tobytes()
    assert rt.encode(data, spec) == oracle.encode_bytes(data, spec)


@pytest.mark.parametrize("spec", ALL_SPECS, ids=SPEC_IDS)
def test_decode_matches_oracle(rt, spec):
    rng = np.random.default_rng(77)
    hi = (1 << spec.code_size) if spec.variable else 256
    data = rng.integers(0, hi, size=5000).astype(np.uint8).tobytes()
    enc = oracle.encode_bytes(data, spec)
    assert rt.decode(enc, spec) == data


def test_golden(rt, lorem_ipsum, lorem_ipsum_encoded):
    assert rt.encode(lorem_ipsum, GIF7) == lorem_ipsum_encoded
    assert rt.decode(lorem_ipsum_encoded, GIF7) == lorem_ipsum


def test_dictionary_reset(rt):
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, size=60000).astype(np.uint8).tobytes()
    spec = LzwSpec.variable(8, Endianness.LITTLE)
    assert rt.encode(data, spec) == oracle.encode_bytes(data, spec)
    assert rt.decode(rt.encode(data, spec), spec) == data


class TestErrors:
    def test_unexpected_code_encode(self, rt):
        with pytest.raises(UnexpectedCodeError) as exc:
            rt.encode(bytes([0, 1, 8, 3]), GIF2)
        assert exc.value.code == 8

    def test_unexpected_code_decode(self, rt):
        data = bytes([0x1F, 0x40, 0x3A, 0, 0, 0, 0x44, 0, 0, 0x44, 0, 0x60,
                      0x54])
        with pytest.raises(UnexpectedCodeError) as exc:
            rt.decode(data, TIFF)
        assert exc.value.code == 258

    def test_truncated(self, rt):
        enc = oracle.encode_bytes(bytes([1] * 100), GIF2)
        with pytest.raises(TruncatedStreamError):
            rt.decode(enc[:-1], GIF2)

    def test_missing_clear(self, rt):
        codes = [(0, 9)]
        width = 9
        next_index = 258
        for _ in range(4096 - 258 + 2):
            codes.append((1, width))
            next_index += 1
            if next_index == (1 << width) and width < 12:
                width += 1
        enc = oracle.pack_codes(codes, Endianness.LITTLE)
        with pytest.raises(MissingClearCodeError):
            rt.decode(enc, LzwSpec.variable(8, Endianness.LITTLE))


class TestBlocks:
    def test_threaded_block_round_trip(self, rt, tokyo_pixels):
        data = tokyo_pixels[:200000]
        for spec in (GIF7, FIXED_LE):
            payloads = rt.encode_blocks(data, spec, block_size=8192,
                                        n_threads=4)
            assert len(payloads) == (len(data) + 8191) // 8192
            out = rt.decode_blocks(payloads, spec, block_size=8192,
                                   n_threads=4)
            assert out == data

    def test_blocks_match_single_streams(self, rt, lorem_ipsum):
        payloads = rt.encode_blocks(lorem_ipsum, GIF7, block_size=4096)
        for i, p in enumerate(payloads):
            chunk = lorem_ipsum[i * 4096 : (i + 1) * 4096]
            codes = oracle.encode_codes(chunk, GIF7)
            if not oracle.eoi_width_quirk(codes, GIF7):
                assert p == oracle.pack_codes(codes, GIF7.endianness)

    def test_fix_eoi_in_blocks(self, rt):
        # Quirky stream: block mode must still round-trip via the EOI fix.
        spec = LzwSpec.gif(2)
        rng = np.random.default_rng(0)
        for _ in range(300):
            data = rng.integers(0, 4, size=int(rng.integers(4, 40))).astype(
                np.uint8
            ).tobytes()
            if oracle.eoi_width_quirk(oracle.encode_codes(data, spec), spec):
                payloads = rt.encode_blocks(data, spec, block_size=64)
                assert rt.decode_blocks(payloads, spec, 64) == data
                return
        pytest.fail("no quirky stream found")
