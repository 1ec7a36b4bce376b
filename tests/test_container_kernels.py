"""The block container on its kernel path, kernels in the Pallas interpreter.

The GPU runs ``BlockParallelCodec`` through the block kernels; here the same
codec runs them in interpret mode on the 8-device CPU mesh, and must produce
the same containers as the lax path and decode what the oracle decodes.
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from lzw_jax.ops import reference as oracle
from lzw_jax.parallel import BlockParallelCodec, framing
from lzw_jax.spec import (
    Endianness, LzwSpec, MissingClearCodeError, UnexpectedCodeError,
)
from lzw_jax.utils.testdata import spliced_nonstrict_stream

GIF7 = LzwSpec.gif(7)
TIFF = LzwSpec.tiff()
FIXED_LE = LzwSpec.fixed(Endianness.LITTLE)
FLAVORS = [GIF7, TIFF, FIXED_LE, LzwSpec.fixed(Endianness.BIG)]
IDS = ["gif7", "tiff", "fixed_le", "fixed_be"]


def kernel_codec(spec, block_size, **kw):
    return BlockParallelCodec(spec, block_size=block_size, use_pallas=True,
                              interpret=True, **kw)


@pytest.mark.parametrize("spec", FLAVORS, ids=IDS)
def test_same_container_as_lax_path(spec, tokyo_pixels):
    data = tokyo_pixels[:9000]
    kern = kernel_codec(spec, 2048)
    lax = BlockParallelCodec(spec, block_size=2048, use_pallas=False)
    container = kern.encode(data)
    assert container == lax.encode(data)
    assert kern.decode(container) == data


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 8 * 1024 + 5])
def test_short_final_blocks(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 128, n).astype(np.uint8).tobytes()
    codec = kernel_codec(GIF7, 1024)
    container = codec.encode(data)
    _, payloads = framing.parse_frame(container)
    for i, p in enumerate(payloads):
        assert oracle.decode_bytes(bytes(p), GIF7) == data[i * 1024:][:1024]
    assert codec.decode(container) == data


def test_empty_input():
    codec = kernel_codec(FIXED_LE, 512)
    assert codec.decode(codec.encode(b"")) == b""


def test_non_power_of_two_block_size():
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, 5000).astype(np.uint8).tobytes()
    codec = kernel_codec(TIFF, 1000)
    assert codec.decode(codec.encode(data)) == data


def test_sharded_over_two_devices():
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    rng = np.random.default_rng(5)
    data = rng.integers(0, 128, 7 * 512 + 3).astype(np.uint8).tobytes()
    codec = kernel_codec(GIF7, 512, mesh=mesh)
    rows = codec.shard_rows(np.zeros((4, 8), np.uint8))
    assert {s.device for s in rows.addressable_shards} == set(mesh.devices)
    container = codec.encode(data)
    one = Mesh(np.array(jax.devices()[:1]), ("data",))
    assert kernel_codec(GIF7, 512, mesh=one).encode(data) == container
    assert codec.decode(container) == data


def test_decode_range(lorem_ipsum):
    codec = kernel_codec(GIF7, 4096)
    container = codec.encode(lorem_ipsum)
    for lo, hi in [(0, 1), (2, 5), (5, 6), (3, 3)]:
        assert codec.decode_range(container, lo, hi) == \
            lorem_ipsum[lo * 4096 : hi * 4096]


@pytest.mark.parametrize("spec", [GIF7, TIFF], ids=["gif7", "tiff"])
def test_foreign_early_clear_container(spec):
    # Streams from an encoder that CLEARs early decode on the same path as
    # self-produced ones.
    rng = np.random.default_rng(6)
    bs = 1 << 12
    hi = 1 << spec.code_size
    data = rng.integers(0, hi, bs * 2 + 777).astype(np.uint8).tobytes()
    payloads = [spliced_nonstrict_stream(data[i : i + bs], spec, piece=1100)
                for i in range(0, len(data), bs)]
    container = framing.pack_frame(spec, bs, len(data), payloads)
    assert kernel_codec(spec, bs).decode(container) == data


def test_corrupt_payload_raises_its_code(lorem_ipsum):
    codec = kernel_codec(GIF7, 4096)
    header, payloads = framing.parse_frame(codec.encode(lorem_ipsum))
    w = GIF7.initial_width
    bad = oracle.pack_codes(
        [(GIF7.clear_code, w), (1, w), (200, w), (GIF7.end_code, w)],
        GIF7.endianness)
    payloads = [bytes(p) for p in payloads]
    payloads[3] = bad
    container = framing.pack_frame(GIF7, 4096, header.orig_size, payloads)
    with pytest.raises(UnexpectedCodeError) as exc:
        codec.decode(container)
    assert exc.value.code == 200


def test_missing_clear_raises():
    # A full table followed by a data code where CLEAR must sit.
    rng = np.random.default_rng(8)
    src = rng.integers(0, 128, 16000).astype(np.uint8).tobytes()
    cw = oracle.encode_codes(src, GIF7)
    body = [(c, w) for c, w in cw if c not in (GIF7.clear_code,
                                              GIF7.end_code)]
    full = 4096 - GIF7.first_free_code + 1  # data codes in one epoch
    codes = [cw[0]] + body[:full] + [(300, 12), (GIF7.end_code, 12)]
    stream = oracle.pack_codes(codes, GIF7.endianness)
    container = framing.pack_frame(GIF7, 1 << 14, 1 << 14, [stream])
    with pytest.raises(MissingClearCodeError):
        kernel_codec(GIF7, 1 << 14).decode(container)


def test_encode_error_propagates():
    codec = kernel_codec(LzwSpec.gif(2), 16)
    with pytest.raises(UnexpectedCodeError) as exc:
        codec.encode(bytes([0, 1, 2, 3]) * 5 + bytes([0, 1, 200, 1]))
    assert exc.value.code == 200


def test_decoded_size_mismatch_is_a_framing_error(lorem_ipsum):
    codec = kernel_codec(GIF7, 4096)
    header, payloads = framing.parse_frame(codec.encode(lorem_ipsum))
    lying = framing.pack_frame(GIF7, 4096, header.orig_size - 1,
                               [bytes(p) for p in payloads])
    with pytest.raises(framing.FramingError):
        codec.decode(lying)


def test_verify_is_on_with_kernels():
    assert kernel_codec(GIF7, 512).verify
    assert not kernel_codec(GIF7, 512, verify=False).verify
