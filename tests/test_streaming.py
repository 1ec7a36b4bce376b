"""Streaming API tests: bounded-memory encode/decode.

The reference is fully streaming — encode pulls one byte at a time from
``Read`` (`encoder.rs:299,313`) and decode emits words as they materialise
with O(1) memory (`decoder.rs:270`).  Two layers replicate that here:

* raw single-stream chunked encode/decode over the native stream codec
  (:meth:`LzwCodec.encode_stream` / :meth:`decode_stream`), byte-identical
  to the batch API and the golden file at every chunk size;
* the LZWS streaming container profile on :class:`BlockParallelCodec`,
  which processes batches of blocks without holding the whole stream.
"""

import io

import numpy as np
import pytest

from lzw_jax.api import FixedCodec, GifCodec, TiffCodec
from lzw_jax.parallel.block import BlockParallelCodec
from lzw_jax.spec import (
    Endianness,
    LzwSpec,
    TruncatedStreamError,
    UnexpectedCodeError,
)


@pytest.mark.parametrize("chunk", [1, 7, 64, 1000, 1 << 20])
def test_stream_encode_matches_golden(lorem_ipsum, lorem_ipsum_encoded, chunk):
    codec = GifCodec(7, backend="native")
    dst = io.BytesIO()
    n = codec.encode_stream(io.BytesIO(lorem_ipsum), dst, chunk_size=chunk)
    assert dst.getvalue() == lorem_ipsum_encoded
    assert n == len(lorem_ipsum_encoded)


@pytest.mark.parametrize("chunk", [1, 13, 512, 1 << 20])
def test_stream_decode_matches_golden(lorem_ipsum, lorem_ipsum_encoded, chunk):
    codec = GifCodec(7, backend="native")
    dst = io.BytesIO()
    n = codec.decode_stream(io.BytesIO(lorem_ipsum_encoded), dst,
                            chunk_size=chunk)
    assert dst.getvalue() == lorem_ipsum
    assert n == len(lorem_ipsum)


@pytest.mark.parametrize("make_codec", [
    lambda: GifCodec(7, backend="native"),
    lambda: TiffCodec(backend="native"),
    lambda: FixedCodec(Endianness.LITTLE, backend="native"),
    lambda: FixedCodec(Endianness.BIG, backend="native"),
])
def test_stream_matches_batch_all_flavors(make_codec, lorem_ipsum):
    data = lorem_ipsum * 2
    codec = make_codec()
    enc = io.BytesIO()
    codec.encode_stream(io.BytesIO(data), enc, chunk_size=333)
    assert enc.getvalue() == codec.encode(data)
    dec = io.BytesIO()
    codec.decode_stream(io.BytesIO(enc.getvalue()), dec, chunk_size=77)
    assert dec.getvalue() == data


def test_stream_empty_input():
    codec = GifCodec(7, backend="native")
    enc = io.BytesIO()
    codec.encode_stream(io.BytesIO(b""), enc)
    assert enc.getvalue() == codec.encode(b"")
    dec = io.BytesIO()
    codec.decode_stream(io.BytesIO(enc.getvalue()), dec)
    assert dec.getvalue() == b""


def test_stream_truncated_raises():
    codec = GifCodec(7, backend="native")
    full = codec.encode(b"hello world" * 40)
    with pytest.raises(TruncatedStreamError):
        codec.decode_stream(io.BytesIO(full[: len(full) // 2]), io.BytesIO())


def test_stream_corrupt_raises_unexpected_code():
    codec = TiffCodec(backend="native")
    # The reference's crafted corrupt TIFF stream (`decoder.rs:758-769`).
    bad = bytes([0x1F, 0x40, 0x3A, 0x00, 0x00, 0x00, 0x44, 0x00, 0x00,
                 0x44, 0x00, 0x60, 0x54])
    with pytest.raises(UnexpectedCodeError) as ei:
        codec.decode_stream(io.BytesIO(bad), io.BytesIO())
    assert ei.value.code == 258


def test_decoder_stream_bounded_output():
    """Tiny out_cap forces the save/restore re-feed path repeatedly."""
    from lzw_jax.native.runtime import get_runtime

    data = (b"abcd" * 3000)[:9999]  # highly compressible -> big expansion
    spec = LzwSpec.gif(7)
    comp = GifCodec(7, backend="native").encode(data)
    dec = get_runtime().decoder_stream(spec)
    out = bytearray()
    for piece in dec.feed(comp, out_cap=1):  # clamped to the 8 KiB minimum
        out.extend(piece)
    dec.finish()
    assert bytes(out) == data


def test_bounded_memory_large_stream(tmp_path):
    """Encode a stream ~50x the chunk size without materialising it."""
    codec = FixedCodec(Endianness.LITTLE, backend="native")
    rng = np.random.default_rng(0)
    base = rng.integers(0, 64, size=1 << 16).astype(np.uint8).tobytes()
    n_reps = 50

    class RepeatReader(io.RawIOBase):
        def __init__(self):
            self.left = n_reps
            self.buf = b""

        def read(self, n=-1):
            while len(self.buf) < n and self.left:
                self.buf += base
                self.left -= 1
            out, self.buf = self.buf[:n], self.buf[n:]
            return out

    enc_path = tmp_path / "big.lzw"
    with open(enc_path, "wb") as dst:
        codec.encode_stream(RepeatReader(), dst, chunk_size=1 << 16)
    # Equal to the batch encode of the same logical stream.
    assert enc_path.read_bytes() == codec.encode(base * n_reps)


# --------------------------------------------------------------------------- #
# LZWS streaming container                                                     #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("spec", [
    LzwSpec.fixed(Endianness.LITTLE),
    LzwSpec.gif(7),
    LzwSpec.tiff(),
])
def test_container_stream_round_trip(spec, lorem_ipsum):
    data = lorem_ipsum * 3 + b"tail"
    codec = BlockParallelCodec(spec, block_size=4096)
    enc = io.BytesIO()
    n = codec.encode_stream(io.BytesIO(data), enc, batch_blocks=3)
    assert n == len(data)
    dec = io.BytesIO()
    m = codec.decode_stream(io.BytesIO(enc.getvalue()), dec, batch_blocks=2)
    assert m == len(data)
    assert dec.getvalue() == data


def test_container_stream_empty():
    codec = BlockParallelCodec(LzwSpec.gif(7), block_size=4096)
    enc = io.BytesIO()
    assert codec.encode_stream(io.BytesIO(b""), enc) == 0
    dec = io.BytesIO()
    assert codec.decode_stream(io.BytesIO(enc.getvalue()), dec) == 0
    assert dec.getvalue() == b""


def test_container_stream_wire_equivalent_spec(lorem_ipsum):
    """A GifCodec-spec'd stream decodes under an equivalent variable spec."""
    enc_codec = BlockParallelCodec(LzwSpec.gif(7), block_size=4096)
    enc = io.BytesIO()
    enc_codec.encode_stream(io.BytesIO(lorem_ipsum), enc)
    dec_codec = BlockParallelCodec(
        LzwSpec.variable(7, Endianness.LITTLE), block_size=4096
    )
    dec = io.BytesIO()
    dec_codec.decode_stream(io.BytesIO(enc.getvalue()), dec)
    assert dec.getvalue() == lorem_ipsum


def test_container_wire_equivalent_batch(lorem_ipsum):
    """Same for the batch container."""
    fixed_a = BlockParallelCodec(LzwSpec.fixed(Endianness.LITTLE),
                                 block_size=4096)
    container = fixed_a.encode(lorem_ipsum)
    # Construct an equal wire format through the raw constructor with a
    # different (irrelevant for fixed) strategy field.
    from lzw_jax.spec import CodeSizeStrategy

    odd_spec = LzwSpec(8, Endianness.LITTLE, CodeSizeStrategy.TIFF, False)
    fixed_b = BlockParallelCodec(odd_spec, block_size=4096)
    assert fixed_b.decode(container) == lorem_ipsum
