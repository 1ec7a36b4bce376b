"""Benchmark corpus loading.

The reference benches on two corpora (`lzw/benches/compare_crates.rs:4-16`):
the lorem_ipsum text and the indexed pixel plane of tokyo_128_colors.png
(values 0..128, hence code size 7), decoded via the `png` crate at
`compare_crates.rs:276-287`.  We produce the identical byte stream from the
palette indices with a small PNG reader (zlib + numpy), so loading a corpus
needs no imaging library.
"""

from __future__ import annotations

import pathlib
import struct
import zlib

import numpy as np

__all__ = ["load_tokyo_pixels", "load_corpus"]

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, width: int, height: int) -> np.ndarray:
    """Undo the per-row PNG filters of a one-byte-per-pixel image."""
    rows = np.frombuffer(raw, np.uint8).reshape(height, width + 1)
    out = np.zeros((height, width), np.uint8)
    prev = np.zeros(width, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: running sum mod 256
            cur = (np.cumsum(line, dtype=np.uint64) & 0xFF).astype(np.uint8)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):  # Average, Paeth: each byte needs its left
            cur_l = [0] * width
            up = prev.tolist()
            src = line.tolist()
            left = upleft = 0
            for x in range(width):
                if kind == 3:
                    pred = (left + up[x]) >> 1
                else:
                    pred = _paeth(left, up[x], upleft)
                left = (src[x] + pred) & 0xFF
                cur_l[x] = left
                upleft = up[x]
            cur = np.array(cur_l, np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {kind} in row {y}")
        out[y] = cur
        prev = cur
    return out


def load_tokyo_pixels(path: str | pathlib.Path) -> bytes:
    """The palette-index bytes of an 8-bit, non-interlaced indexed PNG."""
    blob = pathlib.Path(path).read_bytes()
    if blob[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos : pos + 4])
        kind = blob[pos + 4 : pos + 8]
        body = blob[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if color != 3 or depth != 8 or interlace != 0:
        raise ValueError(
            f"{path}: expected an 8-bit non-interlaced palette PNG, got "
            f"color type {color}, depth {depth}, interlace {interlace}"
        )
    raw = zlib.decompress(b"".join(idat))
    return _unfilter(raw, width, height).tobytes()


def load_corpus(assets_dir: str | pathlib.Path) -> dict[str, bytes]:
    """Load the benchmark corpora keyed by the reference's bench names."""
    assets = pathlib.Path(assets_dir)
    return {
        "lorem_ipsum": (assets / "lorem_ipsum.txt").read_bytes(),
        "tokyo": load_tokyo_pixels(assets / "tokyo_128_colors.png"),
    }
