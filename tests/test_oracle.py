"""Known-answer and property tests for the scalar oracle.

Every byte vector here is lifted from the reference's own test suite so the
oracle is pinned to the exact wire formats:

* encoder vectors: `lzw/src/encoder.rs:661-836` + doctests (`:376-391`,
  `:463-478`, `:548-564`)
* decoder vectors: `lzw/src/decoder.rs:645-770`
* golden file: `test-assets/lorem_ipsum_encoded.bin` (`encoder.rs:739-755`)
"""

import pytest

from lzw_jax.ops import reference as oracle
from lzw_jax.spec import (
    CodeSizeError,
    CodeSizeStrategy,
    Endianness,
    LzwSpec,
    TruncatedStreamError,
    UnexpectedCodeError,
)

FOUR_COLOR = bytes(
    [1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2,
     1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 1, 1, 1, 0, 0, 0, 0, 2, 2, 2]
)
FOUR_COLOR_VARIABLE_LE = bytes(
    [0x8C, 0x2D, 0x99, 0x87, 0x2A, 0x1C, 0xDC, 0x33, 0xA0, 0x02, 0x55, 0x00]
)
FOUR_COLOR_FIXED_LE = bytes(
    [0x01, 0x00, 0x10, 0x00, 0x21, 0x00, 0x03, 0x31, 0x10, 0x01, 0x21, 0x10,
     0x04, 0x21, 0x00, 0x06, 0x11, 0x00, 0x08, 0x91, 0x10, 0x00, 0x01, 0x00,
     0x0F, 0x01, 0x00, 0x04, 0x01]
)

GIF2 = LzwSpec.gif(2)
GIF7 = LzwSpec.gif(7)
TIFF = LzwSpec.tiff()
FIXED_LE = LzwSpec.fixed(Endianness.LITTLE)
FIXED_BE = LzwSpec.fixed(Endianness.BIG)


class TestEncodeKnownAnswers:
    def test_four_color_variable(self):
        assert oracle.encode_bytes(FOUR_COLOR, GIF2) == FOUR_COLOR_VARIABLE_LE

    def test_few_bytes_gif(self):
        assert oracle.encode_bytes(bytes([0, 0, 1, 3]), GIF2) == bytes(
            [0x04, 0x32, 0x05]
        )

    def test_few_bytes_tiff(self):
        assert oracle.encode_bytes(bytes([0, 0, 1, 3]), TIFF) == bytes(
            [0x80, 0x00, 0x00, 0x00, 0x10, 0x1C, 0x04]
        )

    def test_few_bytes_fixed(self):
        assert oracle.encode_bytes(bytes([0, 0, 1, 3]), FIXED_LE) == bytes(
            [0x00, 0x00, 0x00, 0x01, 0x30, 0x00]
        )

    def test_four_color_fixed(self):
        assert oracle.encode_bytes(FOUR_COLOR, FIXED_LE) == FOUR_COLOR_FIXED_LE

    def test_golden_lorem_ipsum(self, lorem_ipsum, lorem_ipsum_encoded):
        assert oracle.encode_bytes(lorem_ipsum, GIF7) == lorem_ipsum_encoded

    def test_deterministic(self):
        a = oracle.encode_bytes(FOUR_COLOR, GIF2)
        b = oracle.encode_bytes(FOUR_COLOR, GIF2)
        assert a == b

    def test_empty_variable(self):
        # CLEAR then EOI at width 3: 0b100, 0b101 -> 0x2C (`encoder.rs:300-309`).
        assert oracle.encode_bytes(b"", GIF2) == bytes([0x2C])

    def test_empty_fixed(self):
        assert oracle.encode_bytes(b"", FIXED_LE) == b""


class TestEncodeErrors:
    def test_unsupported_code_size(self):
        with pytest.raises(CodeSizeError) as exc:
            oracle.encode_bytes(bytes([0]), LzwSpec.gif(10))
        assert "between 2 and 8, was 10" in str(exc.value)

    def test_wrong_data_for_code_size(self):
        with pytest.raises(UnexpectedCodeError) as exc:
            oracle.encode_bytes(
                bytes([0, 1, 8, 3]),
                LzwSpec.variable(2, Endianness.BIG),
            )
        assert exc.value.code == 8
        assert "data should be < 4" in str(exc.value)

    def test_first_byte_not_checked(self):
        # The reference never validates the first byte (`encoder.rs:311`).
        oracle.encode_bytes(bytes([200]), GIF2)


class TestDecodeKnownAnswers:
    def test_four_color_variable(self):
        assert oracle.decode_bytes(FOUR_COLOR_VARIABLE_LE, GIF2) == FOUR_COLOR

    def test_few_bytes_gif(self):
        assert oracle.decode_bytes(bytes([0x04, 0x32, 0x05]), GIF2) == bytes(
            [0, 0, 1, 3]
        )

    def test_few_bytes_tiff(self):
        data = bytes([0x80, 0x00, 0x00, 0x00, 0x10, 0x1C, 0x04])
        assert oracle.decode_bytes(data, TIFF) == bytes([0, 0, 1, 3])

    def test_few_bytes_fixed(self):
        data = bytes([0x00, 0x00, 0x00, 0x01, 0x30, 0x00])
        assert oracle.decode_bytes(data, FIXED_LE) == bytes([0, 0, 1, 3])

    def test_four_color_fixed(self):
        assert oracle.decode_bytes(FOUR_COLOR_FIXED_LE, FIXED_LE) == FOUR_COLOR

    def test_golden_lorem_ipsum(self, lorem_ipsum, lorem_ipsum_encoded):
        assert oracle.decode_bytes(lorem_ipsum_encoded, GIF7) == lorem_ipsum


class TestDecodeErrors:
    def test_unsupported_code_size(self):
        with pytest.raises(CodeSizeError):
            oracle.decode_bytes(bytes([0]), LzwSpec.variable(10, Endianness.LITTLE))

    def test_bad_data_tiff(self):
        # Crafted corrupt stream -> UnexpectedCode(258) (`decoder.rs:758-769`).
        data = bytes(
            [0x1F, 0x40, 0x3A, 0x00, 0x00, 0x00, 0x44, 0x00, 0x00, 0x44, 0x00,
             0x60, 0x54]
        )
        with pytest.raises(UnexpectedCodeError) as exc:
            oracle.decode_bytes(data, TIFF)
        assert exc.value.code == 258

    def test_truncated_variable_stream(self):
        # Variable decode expects EOI before EOF (`io.rs:45` read_exact).
        good = oracle.encode_bytes(FOUR_COLOR, GIF2)
        with pytest.raises(TruncatedStreamError):
            oracle.decode_bytes(good[:-1], GIF2)


class TestRoundTrip:
    @pytest.mark.parametrize(
        "spec",
        [GIF2, GIF7, TIFF, FIXED_LE, FIXED_BE,
         LzwSpec.variable(5, Endianness.BIG, CodeSizeStrategy.TIFF),
         LzwSpec.variable(3, Endianness.LITTLE, CodeSizeStrategy.TIFF)],
        ids=["gif2", "gif7", "tiff", "fixed_le", "fixed_be", "var5_be_tiff",
             "var3_le_tiff"],
    )
    @pytest.mark.parametrize("n", [0, 1, 2, 7, 255, 4096])
    def test_random_round_trip(self, spec, n):
        import random

        rng = random.Random(42 + n)
        hi = (1 << spec.code_size) - 1 if spec.variable else 255
        data = bytes(rng.randint(0, hi) for _ in range(n))
        codes = oracle.encode_codes(data, spec)
        enc = oracle.pack_codes(codes, spec.endianness)
        if oracle.eoi_width_quirk(codes, spec):
            # Reference quirk (see eoi_width_quirk docstring): the stream is
            # not decodable by the reference's own decoder; we only require
            # that our mirror fails the same controlled way.
            try:
                oracle.decode_bytes(enc, spec)
            except oracle.TruncatedStreamError:
                pass
        else:
            assert oracle.decode_bytes(enc, spec) == data

    def test_runs_round_trip(self):
        # Long runs exercise KwKwK heavily.
        data = bytes([1] * 500 + [2] * 300 + [1, 2] * 200)
        for spec in (GIF2, FIXED_LE, TIFF):
            assert (
                oracle.decode_bytes(oracle.encode_bytes(data, spec), spec) == data
            )

    def test_tokyo_round_trip_variable(self, tokyo_pixels):
        data = tokyo_pixels[:50000]
        enc = oracle.encode_bytes(data, GIF7)
        assert oracle.decode_bytes(enc, GIF7) == data

    def test_eoi_width_quirk_detected(self):
        # [1,5,6,1,5,0,0] at cs=3 TIFF: the decoder-side insert for the final
        # data code lands exactly on the early-change threshold (15), so the
        # reference decoder expects EOI at 5 bits while the encoder wrote it
        # at 4.  We reproduce the reference behaviour (stream ends mid-code).
        spec = LzwSpec.variable(3, Endianness.LITTLE, CodeSizeStrategy.TIFF)
        data = bytes([1, 5, 6, 1, 5, 0, 0])
        codes = oracle.encode_codes(data, spec)
        assert oracle.eoi_width_quirk(codes, spec)
        with pytest.raises(TruncatedStreamError):
            oracle.decode_bytes(oracle.pack_codes(codes, spec.endianness), spec)

    def test_dictionary_reset_round_trip(self):
        # Enough distinct digrams to overflow the 4096-entry table and force
        # the width-12 CLEAR + reset path (`encoder.rs:330-333`).
        import random

        rng = random.Random(7)
        data = bytes(rng.randint(0, 255) for _ in range(30000))
        spec = LzwSpec.variable(8, Endianness.LITTLE)
        assert oracle.decode_bytes(oracle.encode_bytes(data, spec), spec) == data
        spec = LzwSpec.variable(8, Endianness.BIG, CodeSizeStrategy.TIFF)
        assert oracle.decode_bytes(oracle.encode_bytes(data, spec), spec) == data
