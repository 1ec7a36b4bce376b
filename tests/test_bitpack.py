"""Bit-level known-answer tests, ported from the reference's `io.rs:330-572`,
plus differential tests of the vectorized packers against the scalar oracle."""

import numpy as np
import pytest

from lzw_jax.ops import bitpack, reference as oracle
from lzw_jax.spec import Endianness

LE, BE = Endianness.LITTLE, Endianness.BIG


def pack_np(pairs, endianness):
    codes = np.array([c for c, _ in pairs], dtype=np.int64)
    widths = np.array([w for _, w in pairs], dtype=np.int64)
    return bytes(bitpack.pack_codes_np(codes, widths, endianness))


class TestKnownAnswersNp:
    # io.rs:421-431 / :477-487
    def test_write_1(self):
        assert pack_np([(1, 1)], LE) == bytes([0x01])
        assert pack_np([(1, 1)], BE) == bytes([0x80])

    # io.rs:434-448 / :490-504
    def test_write_colors(self):
        pairs = [(4, 3), (1, 3), (6, 3), (6, 3), (2, 4)]
        assert pack_np(pairs, LE) == bytes([0x8C, 0x2D])
        assert pack_np(pairs, BE) == bytes([0x87, 0x62])

    # io.rs:451-461 / :507-517
    def test_write_12bits(self):
        assert pack_np([(0xFFF, 12)], LE) == bytes([0xFF, 0x0F])
        assert pack_np([(0xFFF, 12)], BE) == bytes([0xFF, 0xF0])

    # io.rs:464-474 / :520-531
    def test_write_16bits(self):
        assert pack_np([(0xFFFA, 16)], LE) == bytes([0xFA, 0xFF])
        assert pack_np([(0xFFFA, 16)], BE) == bytes([0xFF, 0xFA])

    # io.rs:334-341 / :378-384
    def test_read_1(self):
        assert bitpack.unpack_fixed_np(np.frombuffer(bytes([0x01]), np.uint8), 1, LE)[0] == 1
        assert bitpack.unpack_fixed_np(np.frombuffer(bytes([0x80]), np.uint8), 1, BE)[0] == 1

    # io.rs:360-375 / :403-418
    def test_read_12_16(self):
        def one(byts, width, endianness):
            return bitpack.unpack_fixed_np(
                np.frombuffer(bytes(byts), np.uint8), width, endianness
            )[0]

        assert one([0xFF, 0x0F], 12, LE) == 0xFFF
        assert one([0xFF, 0xF0], 12, BE) == 0xFFF
        assert one([0xFA, 0xFF], 16, LE) == 0xFFFA
        assert one([0xFF, 0xFA], 16, BE) == 0xFFFA

    # io.rs:534-571 round-trips through the 12-bit iterator
    @pytest.mark.parametrize("endianness", [LE, BE])
    def test_write_read_full(self, endianness):
        packed = pack_np([(0, 12), (1, 12), (0, 12), (2, 12)], endianness)
        codes = bitpack.unpack_fixed_np(
            np.frombuffer(packed, np.uint8), 12, endianness
        )
        assert list(codes) == [0, 1, 0, 2]

    def test_trailing_bits_discarded(self):
        # 7 bytes = 56 bits -> only 4 whole 12-bit codes (`io.rs:58-78`).
        data = np.zeros(7, dtype=np.uint8)
        assert len(bitpack.unpack_fixed_np(data, 12, LE)) == 4


class TestDifferentialVsOracle:
    @pytest.mark.parametrize("endianness", [LE, BE])
    @pytest.mark.parametrize("seed", range(5))
    def test_random_streams(self, endianness, seed):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(1, 400))
        widths = rng.integers(1, 17, size=n)
        codes = np.array([int(rng.integers(0, 1 << w)) for w in widths])
        expected = oracle.pack_codes(list(zip(codes, widths)), endianness)
        assert pack_np(list(zip(codes, widths)), endianness) == expected

    @pytest.mark.parametrize("endianness", [LE, BE])
    def test_holes_are_transparent(self, endianness):
        # Width-0 slots (masked lockstep emissions) must not disturb packing.
        pairs = [(4, 3), (99, 0), (1, 3), (0, 0), (6, 3), (6, 3), (7, 0), (2, 4)]
        dense = [(c, w) for c, w in pairs if w]
        assert pack_np(pairs, endianness) == pack_np(dense, endianness)


class TestJax:
    @pytest.mark.parametrize("endianness", [LE, BE])
    def test_pack_matches_np(self, endianness):
        import jax.numpy as jnp

        rng = np.random.default_rng(11)
        widths = rng.integers(0, 13, size=300)
        codes = np.array([int(rng.integers(0, 1 << max(w, 1))) for w in widths])
        expected = bitpack.pack_codes_np(codes, widths, endianness)
        buf, n = bitpack.pack_codes_jax(
            jnp.asarray(codes, jnp.int32),
            jnp.asarray(widths, jnp.int32),
            endianness,
            out_bytes=600,
        )
        assert int(n) == len(expected)
        assert bytes(np.asarray(buf)[: int(n)]) == bytes(expected)
        assert not np.asarray(buf)[int(n) :].any()

    @pytest.mark.parametrize("endianness", [LE, BE])
    def test_unpack_matches_np(self, endianness):
        import jax.numpy as jnp

        rng = np.random.default_rng(12)
        data = rng.integers(0, 256, size=100).astype(np.uint8)
        expected = bitpack.unpack_fixed_np(data, 12, endianness)
        got = bitpack.unpack_fixed_jax(
            jnp.asarray(data), 12, endianness, n_codes=len(expected)
        )
        assert list(np.asarray(got)) == list(expected)

    def test_pack_jittable(self):
        import jax
        import jax.numpy as jnp

        f = jax.jit(
            lambda c, w: bitpack.pack_codes_jax(c, w, LE, out_bytes=64),
        )
        buf, n = f(
            jnp.array([4, 1, 6, 6, 2], jnp.int32),
            jnp.array([3, 3, 3, 3, 4], jnp.int32),
        )
        assert int(n) == 2
        assert bytes(np.asarray(buf)[:2]) == bytes([0x8C, 0x2D])
