"""Differential tests: jittable two-pass decoder vs the scalar oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

from lzw_jax.ops import decode, reference as oracle
from lzw_jax.spec import CodeSizeStrategy, Endianness, LzwSpec

GIF2 = LzwSpec.gif(2)
GIF7 = LzwSpec.gif(7)
TIFF = LzwSpec.tiff()
FIXED_LE = LzwSpec.fixed(Endianness.LITTLE)
FIXED_BE = LzwSpec.fixed(Endianness.BIG)

ALL_SPECS = [GIF2, GIF7, TIFF, FIXED_LE, FIXED_BE,
             LzwSpec.variable(4, Endianness.BIG, CodeSizeStrategy.TIFF)]
SPEC_IDS = ["gif2", "gif7", "tiff", "fixed_le", "fixed_be", "var4_be_tiff"]


def decode_via_jax(data: bytes, spec: LzwSpec, out_bound: int):
    buf = np.zeros(max(1, len(data)), np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    res = decode.decode_block(
        jnp.asarray(buf), jnp.int32(len(data)), spec, out_bound
    )
    assert int(res["error"]) == decode.ERR_NONE, int(res["error"])
    n = int(res["total_len"])
    assert n <= out_bound
    return bytes(np.asarray(res["out"])[:n])


@pytest.mark.parametrize("spec", ALL_SPECS, ids=SPEC_IDS)
@pytest.mark.parametrize("n", [0, 1, 2, 5, 64, 1000])
def test_random_round_trip_matches_oracle(spec, n):
    rng = np.random.default_rng(500 + n)
    hi = (1 << spec.code_size) if spec.variable else 256
    data = rng.integers(0, hi, size=n).astype(np.uint8).tobytes()
    codes = oracle.encode_codes(data, spec)
    if oracle.eoi_width_quirk(codes, spec):
        pytest.skip("reference-undedecodable stream (EOI width quirk)")
    enc = oracle.pack_codes(codes, spec.endianness)
    assert decode_via_jax(enc, spec, out_bound=max(16, 2 * n)) == data


@pytest.mark.parametrize("spec", ALL_SPECS, ids=SPEC_IDS)
def test_runs_kwkwk(spec):
    data = bytes([1] * 400 + [2] * 200 + [1, 2, 3] * 100)
    enc = oracle.encode_bytes(data, spec)
    assert decode_via_jax(enc, spec, out_bound=2048) == data


def test_known_vectors():
    assert decode_via_jax(bytes([0x04, 0x32, 0x05]), GIF2, 16) == bytes(
        [0, 0, 1, 3]
    )
    assert decode_via_jax(
        bytes([0x80, 0x00, 0x00, 0x00, 0x10, 0x1C, 0x04]), TIFF, 16
    ) == bytes([0, 0, 1, 3])
    assert decode_via_jax(
        bytes([0x00, 0x00, 0x00, 0x01, 0x30, 0x00]), FIXED_LE, 16
    ) == bytes([0, 0, 1, 3])


def test_golden_lorem_ipsum(lorem_ipsum, lorem_ipsum_encoded):
    assert decode_via_jax(lorem_ipsum_encoded, GIF7, 32768) == lorem_ipsum


def test_dictionary_reset_stream():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, size=30000).astype(np.uint8).tobytes()
    for spec in (LzwSpec.variable(8, Endianness.LITTLE),
                 LzwSpec.variable(8, Endianness.BIG, CodeSizeStrategy.TIFF)):
        enc = oracle.encode_bytes(data, spec)
        assert decode_via_jax(enc, spec, out_bound=32768) == data


def test_empty_variable_stream():
    enc = oracle.encode_bytes(b"", GIF2)  # CLEAR + EOI only
    assert decode_via_jax(enc, GIF2, 16) == b""


def test_empty_fixed_stream():
    assert decode_via_jax(b"", FIXED_LE, 16) == b""


def test_trailing_partial_code_discarded_fixed():
    data = bytes([0x00, 0x00, 0x00, 0x01, 0x30, 0x00, 0x55])  # extra byte
    assert decode_via_jax(data, FIXED_LE, 16) == bytes([0, 0, 1, 3])


class TestErrors:
    def test_unexpected_code(self):
        data = bytes(
            [0x1F, 0x40, 0x3A, 0x00, 0x00, 0x00, 0x44, 0x00, 0x00, 0x44,
             0x00, 0x60, 0x54]
        )
        buf = jnp.asarray(np.frombuffer(data, np.uint8))
        res = decode.decode_block(buf, jnp.int32(len(data)), TIFF, 64)
        assert int(res["error"]) == decode.ERR_UNEXPECTED_CODE
        assert int(res["error_code"]) == 258

    def test_truncated_variable(self):
        enc = oracle.encode_bytes(bytes([1] * 100), GIF2)
        buf = jnp.asarray(np.frombuffer(enc[:-1], np.uint8))
        res = decode.decode_block(buf, jnp.int32(len(enc) - 1), GIF2, 256)
        assert int(res["error"]) == decode.ERR_TRUNCATED

    def test_missing_clear_code(self):
        # Fixed-12 wire bytes replayed as a GIF cs=8 stream never contain a
        # CLEAR; enough codes overflow the table.  Build synthetically: codes
        # 0..+ that keep inserting without CLEAR at width schedule.
        codes = []
        width = 9
        next_index = 258
        # first code
        codes.append((0, width))
        for _ in range(4096 - 258 + 2):
            codes.append((1, width))
            next_index += 1
            if next_index == (1 << width) and width < 12:
                width += 1
        enc = oracle.pack_codes(codes, Endianness.LITTLE)
        buf = jnp.asarray(np.frombuffer(enc, np.uint8))
        spec = LzwSpec.variable(8, Endianness.LITTLE)
        res = decode.decode_block(buf, jnp.int32(len(enc)), spec, 8192)
        assert int(res["error"]) == decode.ERR_MISSING_CLEAR

    def test_missing_clear_matches_oracle(self):
        # The same synthetic stream must raise MissingClearCodeError in the
        # oracle, pinning both implementations to `decoder.rs:281-283`.
        from lzw_jax.spec import MissingClearCodeError

        codes = [(0, 9)]
        width = 9
        next_index = 258
        for _ in range(4096 - 258 + 2):
            codes.append((1, width))
            next_index += 1
            if next_index == (1 << width) and width < 12:
                width += 1
        enc = oracle.pack_codes(codes, Endianness.LITTLE)
        spec = LzwSpec.variable(8, Endianness.LITTLE)
        with pytest.raises(MissingClearCodeError):
            oracle.decode_bytes(enc, spec)


def test_two_phase_api(lorem_ipsum, lorem_ipsum_encoded):
    # decode_pass1 alone gives the exact decoded length for host allocation.
    buf = jnp.asarray(np.frombuffer(lorem_ipsum_encoded, np.uint8))
    p1 = decode.decode_pass1(buf, jnp.int32(len(lorem_ipsum_encoded)), GIF7)
    assert int(p1["error"]) == decode.ERR_NONE
    assert int(p1["total_len"]) == len(lorem_ipsum)
    out, err_step, _ = decode.decode_pass2(
        p1["gprefix"], p1["gsuffix"], p1["glocal"], p1["out_g"],
        p1["out_len"], p1["out_off"], p1["out_lit"],
        out_bound=len(lorem_ipsum), alphabet=GIF7.alphabet_size,
    )
    assert int(err_step) == 2**31 - 1
    assert bytes(np.asarray(out)) == lorem_ipsum
