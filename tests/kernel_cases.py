"""Inputs and outcome helpers shared by the block-kernel tests."""

from __future__ import annotations

import numpy as np

from lzw_jax.ops import decode as _decode
from lzw_jax.ops import reference as oracle
from lzw_jax.spec import (
    CodeSizeStrategy,
    Endianness,
    LzwSpec,
    MissingClearCodeError,
    TruncatedStreamError,
    UnexpectedCodeError,
)

SPECS = {
    "gif2": LzwSpec.gif(2),
    "gif3": LzwSpec.gif(3),
    "gif7": LzwSpec.gif(7),
    "gif8": LzwSpec.gif(8),
    "tiff": LzwSpec.tiff(),
    "fixed_le": LzwSpec.fixed(Endianness.LITTLE),
    "fixed_be": LzwSpec.fixed(Endianness.BIG),
    "var6_be_tiff": LzwSpec.variable(6, Endianness.BIG, CodeSizeStrategy.TIFF),
}

_KINDS = {
    _decode.ERR_UNEXPECTED_CODE: "unexpected",
    _decode.ERR_MISSING_CLEAR: "missing_clear",
    _decode.ERR_TRUNCATED: "truncated",
}


def alphabet(spec: LzwSpec) -> int:
    return 1 << spec.code_size


def sample(kind: str, n: int, spec: LzwSpec, rng) -> bytes:
    """Test inputs by shape: the dictionary paths each one stresses."""
    hi = alphabet(spec)
    if kind == "random":
        data = rng.integers(0, hi, size=n)
    elif kind == "runs":
        data = np.repeat(rng.integers(0, hi, size=max(n // 9, 1)), 9)[:n]
    elif kind == "kwkwk":  # tiny alphabet: the code == next-index case
        data = rng.integers(0, min(2, hi), size=n)
    elif kind == "periodic":
        period = int(rng.integers(1, 8))
        data = np.tile(rng.integers(0, hi, size=period), n // period + 1)[:n]
    elif kind == "constant":
        data = np.full(n, hi - 1)
    else:
        raise ValueError(kind)
    return data.astype(np.uint8).tobytes()


def matrix(rows: list[bytes], width: int | None = None):
    """Zero-padded u8[N, width] matrix and i32[N] lengths."""
    width = width or max(1, max(len(r) for r in rows))
    mat = np.zeros((len(rows), width), np.uint8)
    lens = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        mat[i, : len(r)] = np.frombuffer(r, np.uint8)
        lens[i] = len(r)
    return mat, lens


def oracle_outcome(stream: bytes, spec: LzwSpec):
    """('ok', bytes) or (error kind, offending code) from the oracle."""
    try:
        return ("ok", oracle.decode_bytes(stream, spec))
    except UnexpectedCodeError as e:
        return ("unexpected", e.code)
    except MissingClearCodeError:
        return ("missing_clear", None)
    except TruncatedStreamError:
        return ("truncated", None)


def kernel_outcome(out, total, err, err_code, bound: int):
    """The same pair from one row of a decode kernel's results."""
    if err:
        kind = _KINDS[int(err)]
        return (kind, int(err_code) if kind == "unexpected" else None)
    if total > bound:
        return ("overflow", int(total))
    return ("ok", bytes(np.asarray(out)[: int(total)]))


def corruptions(stream: bytes, rng) -> list[bytes]:
    """Byte flips, a truncation, a splice and noise, as the error fuzz."""
    out = []
    if len(stream) < 4:
        return out
    for _ in range(3):
        b = bytearray(stream)
        i = int(rng.integers(0, len(b)))
        b[i] ^= int(rng.integers(1, 256))
        out.append(bytes(b))
    out.append(stream[: int(rng.integers(1, len(stream)))])
    i = int(rng.integers(1, len(stream)))
    j = int(rng.integers(1, len(stream)))
    out.append(stream[:i] + stream[j:])
    out.append(rng.integers(0, 256, size=int(rng.integers(4, 60)))
               .astype(np.uint8).tobytes())
    return out
