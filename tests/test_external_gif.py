"""External differential anchor: Pillow's GIF codec vs this framework.

The reference cross-checks against two independent crates
(`compare_crates.rs:30-77`).  All other differential testing here is
intra-project (oracle / XLA / Pallas / native are four readings by the same
author); Pillow's LZW implementation is a genuinely independent one, so a
shared misreading of the GIF wire format fails these tests even when all
four in-repo backends agree.

Both directions are covered:

* encode here -> wrap in a minimal GIF container -> Pillow decodes;
* Pillow encodes a paletted image -> extract the LZW stream -> decode here.
"""

import io
import struct

import numpy as np
import pytest

from PIL import Image

from lzw_jax.api import GifCodec
from lzw_jax.utils.gifwrap import wrap_gif, unwrap_gif as _unwrap_gif

BACKENDS = ["oracle", "jax", "native"]


# --------------------------------------------------------------------------- #
# Minimal GIF container plumbing                                              #
# --------------------------------------------------------------------------- #


def unwrap_gif(gif: bytes):
    """Package helper + Pillow's own decode of the same file (the external
    reading the differential tests compare against)."""
    stream, code_size, (w, h) = _unwrap_gif(gif)
    pixels = np.asarray(Image.open(io.BytesIO(gif)).convert("P"))
    return stream, code_size, pixels.reshape(h, w)


# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("backend", BACKENDS)
def test_pillow_decodes_our_streams(backend, tokyo_pixels):
    w, h = 128, 64
    pixels = np.frombuffer(tokyo_pixels[: w * h], np.uint8)
    codec = GifCodec(7, backend=backend)
    stream = codec.encode(pixels.tobytes())
    gif = wrap_gif(stream, w, h, 7)
    decoded = np.asarray(Image.open(io.BytesIO(gif)))
    np.testing.assert_array_equal(decoded.reshape(-1), pixels)


@pytest.mark.parametrize("code_size", [2, 3, 5, 8])
def test_pillow_decodes_random_inputs(code_size):
    rng = np.random.default_rng(code_size)
    w, h = 64, 32
    pixels = rng.integers(0, 1 << code_size, size=w * h).astype(np.uint8)
    stream = GifCodec(code_size, backend="native").encode(pixels.tobytes())
    gif = wrap_gif(stream, w, h, code_size)
    decoded = np.asarray(Image.open(io.BytesIO(gif)))
    np.testing.assert_array_equal(decoded.reshape(-1), pixels)


def test_pillow_decodes_long_stream_with_resets():
    """> 4096 dictionary entries forces the table-full CLEAR path
    (`encoder.rs:330-333`) through an external decoder."""
    rng = np.random.default_rng(42)
    w, h = 256, 128  # 32 KiB of noisy pixels -> several CLEAR resets
    pixels = rng.integers(0, 256, size=w * h).astype(np.uint8)
    stream = GifCodec(8, backend="native").encode(pixels.tobytes())
    gif = wrap_gif(stream, w, h, 8)
    decoded = np.asarray(Image.open(io.BytesIO(gif)))
    np.testing.assert_array_equal(decoded.reshape(-1), pixels)


# --------------------------------------------------------------------------- #
# Direction 2: Pillow encodes, we decode                                      #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("backend", BACKENDS)
def test_we_decode_pillow_streams(backend, tokyo_pixels):
    w, h = 128, 96
    pixels = np.frombuffer(tokyo_pixels[: w * h], np.uint8).reshape(h, w)
    img = Image.fromarray(pixels, mode="P")
    img.putpalette([(i * 2) % 256 for i in range(256) for _ in range(3)])
    buf = io.BytesIO()
    img.save(buf, format="GIF", optimize=False, interlace=False)
    stream, code_size, pillow_pixels = unwrap_gif(buf.getvalue())
    ours = GifCodec(code_size, backend=backend).decode(stream)
    got = np.frombuffer(ours, np.uint8).reshape(h, w)
    np.testing.assert_array_equal(got, pillow_pixels)


def test_we_decode_pillow_random():
    rng = np.random.default_rng(3)
    w, h = 64, 64
    pixels = rng.integers(0, 256, size=(h, w)).astype(np.uint8)
    img = Image.fromarray(pixels, mode="P")
    img.putpalette([i for i in range(256) for _ in range(3)])
    buf = io.BytesIO()
    img.save(buf, format="GIF", optimize=False, interlace=False)
    stream, code_size, pillow_pixels = unwrap_gif(buf.getvalue())
    ours = GifCodec(code_size, backend="native").decode(stream)
    np.testing.assert_array_equal(
        np.frombuffer(ours, np.uint8).reshape(h, w), pillow_pixels
    )
