"""The corpus loader's PNG reader, checked against Pillow where installed."""

import struct
import zlib

import numpy as np
import pytest

from lzw_jax.utils.corpus import load_corpus, load_tokyo_pixels

from conftest import ASSETS


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filter_row(kind: int, cur: list[int], prev: list[int]) -> list[int]:
    out = []
    for x, v in enumerate(cur):
        left = cur[x - 1] if x else 0
        up = prev[x]
        upleft = prev[x - 1] if x else 0
        pred = [0, left, up, (left + up) >> 1, _paeth(left, up, upleft)][kind]
        out.append((v - pred) & 0xFF)
    return out


def _write_png(path, pixels: np.ndarray, filters, color=3, depth=8):
    h, w = pixels.shape
    raw = bytearray()
    prev = [0] * w
    for y in range(h):
        cur = pixels[y].tolist()
        kind = filters[y % len(filters)]
        raw.append(kind)
        raw += bytes(_filter_row(kind, cur, prev))
        prev = cur
    palette = bytes(range(256)) * 3
    blob = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                          0, 0, 0))
            + _chunk(b"PLTE", palette[:768])
            + _chunk(b"IDAT", zlib.compress(bytes(raw)))
            + _chunk(b"IEND", b""))
    path.write_bytes(blob)


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_filters_undone(tmp_path, filters):
    rng = np.random.default_rng(len(filters) * 10 + filters[0])
    pixels = rng.integers(0, 256, size=(13, 37)).astype(np.uint8)
    pixels[5:9] = 200  # flat rows too
    path = tmp_path / "img.png"
    _write_png(path, pixels, filters)
    assert load_tokyo_pixels(path) == pixels.tobytes()
    Image = pytest.importorskip("PIL.Image")
    with Image.open(path) as img:
        assert img.tobytes() == pixels.tobytes()


def test_tokyo_matches_pillow():
    Image = pytest.importorskip("PIL.Image")
    path = ASSETS / "tokyo_128_colors.png"
    with Image.open(path) as img:
        want = img.tobytes()
    got = load_tokyo_pixels(path)
    assert got == want
    assert len(got) == 1024 * 684 and max(got) < 128


def test_load_corpus_keys():
    corpus = load_corpus(ASSETS)
    assert set(corpus) == {"lorem_ipsum", "tokyo"}
    assert corpus["lorem_ipsum"].startswith(b"Lorem")


def test_rejects_non_palette_png(tmp_path):
    path = tmp_path / "gray.png"
    _write_png(path, np.zeros((2, 2), np.uint8), [0], color=0)
    with pytest.raises(ValueError, match="palette"):
        load_tokyo_pixels(path)


def test_rejects_non_png(tmp_path):
    path = tmp_path / "x.png"
    path.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        load_tokyo_pixels(path)
