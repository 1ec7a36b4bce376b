"""Facade-level contract tests, mirroring the reference's doctest examples."""

import io

import numpy as np
import pytest

from lzw_jax.api import FixedCodec, GifCodec, LzwCodec, TiffCodec, VariableCodec
from lzw_jax.spec import (
    CodeSizeError,
    CodeSizeStrategy,
    Endianness,
    LzwSpec,
    MissingClearCodeError,
    TruncatedStreamError,
    UnexpectedCodeError,
)


@pytest.fixture(params=["jax", "oracle"])
def backend(request):
    return request.param


class TestDoctestContracts:
    def test_gif(self, backend):
        codec = GifCodec(2, backend=backend)
        assert codec.encode(bytes([0, 0, 1, 3])) == bytes([0x04, 0x32, 0x05])
        assert codec.decode(bytes([0x04, 0x32, 0x05])) == bytes([0, 0, 1, 3])

    def test_tiff(self, backend):
        codec = TiffCodec(backend=backend)
        wire = bytes([0x80, 0x00, 0x00, 0x00, 0x10, 0x1C, 0x04])
        assert codec.encode(bytes([0, 0, 1, 3])) == wire
        assert codec.decode(wire) == bytes([0, 0, 1, 3])

    def test_fixed(self, backend):
        codec = FixedCodec(Endianness.LITTLE, backend=backend)
        wire = bytes([0x00, 0x00, 0x00, 0x01, 0x30, 0x00])
        assert codec.encode(bytes([0, 0, 1, 3])) == wire
        assert codec.decode(wire) == bytes([0, 0, 1, 3])

    def test_variable(self, backend):
        codec = VariableCodec(2, Endianness.LITTLE, backend=backend)
        assert codec.encode(bytes([0, 0, 1, 3])) == bytes([0x04, 0x32, 0x05])


class TestGolden:
    def test_round_trip_golden(self, backend, lorem_ipsum, lorem_ipsum_encoded):
        codec = GifCodec(7, backend=backend)
        assert codec.encode(lorem_ipsum) == lorem_ipsum_encoded
        assert codec.decode(lorem_ipsum_encoded) == lorem_ipsum

    def test_backends_agree_on_corpus(self, tokyo_pixels):
        data = tokyo_pixels[:30000]
        for make in (lambda b: GifCodec(7, backend=b),
                     lambda b: TiffCodec(backend=b),
                     lambda b: FixedCodec(Endianness.BIG, backend=b)):
            assert make("jax").encode(data) == make("oracle").encode(data)


class TestErrors:
    def test_code_size_validated_at_construction(self):
        with pytest.raises(CodeSizeError):
            GifCodec(10)
        with pytest.raises(CodeSizeError):
            GifCodec(1)

    def test_encode_unexpected_code(self, backend):
        codec = VariableCodec(2, Endianness.BIG, backend=backend)
        with pytest.raises(UnexpectedCodeError) as exc:
            codec.encode(bytes([0, 1, 8, 3]))
        assert exc.value.code == 8

    def test_decode_unexpected_code(self, backend):
        data = bytes([0x1F, 0x40, 0x3A, 0, 0, 0, 0x44, 0, 0, 0x44, 0, 0x60, 0x54])
        with pytest.raises(UnexpectedCodeError) as exc:
            TiffCodec(backend=backend).decode(data)
        assert exc.value.code == 258

    def test_decode_truncated(self, backend):
        codec = GifCodec(2, backend=backend)
        enc = codec.encode(bytes([1] * 64))
        with pytest.raises(TruncatedStreamError):
            codec.decode(enc[:-1])

    def test_decode_missing_clear(self, backend):
        from lzw_jax.ops import reference as oracle

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
            VariableCodec(8, Endianness.LITTLE, backend=backend).decode(enc)


class TestStreamApi:
    def test_stream_round_trip(self, backend):
        codec = GifCodec(7, backend=backend)
        src = io.BytesIO(b"the quick brown fox jumps over the lazy dog " * 20)
        comp = io.BytesIO()
        codec.encode_stream(src, comp)
        comp.seek(0)
        out = io.BytesIO()
        codec.decode_stream(comp, out)
        assert out.getvalue() == src.getvalue()

    def test_ndarray_input(self):
        codec = FixedCodec()
        arr = np.arange(256, dtype=np.uint8)
        assert codec.decode(codec.encode(arr)) == arr.tobytes()


class TestBucketing:
    def test_sizes_straddling_buckets(self):
        codec = GifCodec(7)
        for n in (0, 1, 255, 256, 257, 511, 513):
            data = bytes(i % 128 for i in range(n))
            assert codec.decode(codec.encode(data)) == data


class TestBackendDispatch:
    def test_auto_matches_jax(self, lorem_ipsum, lorem_ipsum_encoded):
        auto = GifCodec(7)  # auto -> native when the toolchain is present
        assert auto.encode(lorem_ipsum) == lorem_ipsum_encoded
        assert auto.decode(lorem_ipsum_encoded) == lorem_ipsum

    def test_native_backend_explicit(self):
        from lzw_jax.native.runtime import native_available

        if not native_available():
            pytest.skip("native runtime unavailable")
        codec = TiffCodec(backend="native")
        data = b"native backend dispatch" * 10
        assert codec.decode(codec.encode(data)) == data

    def test_unknown_backend_rejected(self):
        with pytest.raises(ValueError):
            GifCodec(7, backend="cuda")
