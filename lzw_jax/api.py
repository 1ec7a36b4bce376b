"""Public codec facades.

Mirrors the reference's four facade types and their byte-level contracts:

* :class:`GifCodec`      — `encoder.rs:349-440` / `decoder.rs:293-383`
* :class:`TiffCodec`     — `encoder.rs:442-524` / `decoder.rs:385-465`
* :class:`FixedCodec`    — `encoder.rs:526-659` / `decoder.rs:467-643`
* :class:`VariableCodec` — `encoder.rs:151-347` / `decoder.rs:52-291`

Each facade produces/consumes the *raw single-stream* wire format —
byte-identical to the reference.  For block-parallel, multi-chip operation see
:mod:`lzw_jax.parallel` (a framing container, new to this framework).

Design notes:

* Inputs are padded to power-of-two buckets so each distinct wire format
  compiles a handful of programs total, then serves any input size.
* ``backend="auto"`` (default) picks per environment: the native C++ runtime
  when available (fastest for single streams — the XLA codecs are built for
  CPU portability and the block kernels for the *block* container, not raw
  single streams), else the jittable XLA codecs.  ``backend="jax"`` and
  ``backend="oracle"`` force those paths; all backends are byte-identical.
"""

from __future__ import annotations

from typing import BinaryIO

import numpy as np

from lzw_jax.ops import bitpack, decode as _decode, encode as _encode
from lzw_jax.ops import reference as _oracle
from lzw_jax.spec import (
    CodeSizeStrategy,
    Endianness,
    LzwSpec,
    MissingClearCodeError,
    TruncatedStreamError,
    UnexpectedCodeError,
)

__all__ = ["LzwCodec", "GifCodec", "TiffCodec", "FixedCodec", "VariableCodec"]


def _bucket(n: int, lo: int = 256) -> int:
    """Smallest power-of-two >= n (>= lo) — bounds jit recompiles."""
    b = lo
    while b < n:
        b <<= 1
    return b


class LzwCodec:
    """Encode/decode one LZW wire format described by an :class:`LzwSpec`."""

    def __init__(self, spec: LzwSpec, backend: str = "auto"):
        if backend not in ("auto", "jax", "oracle", "native"):
            raise ValueError(f"unknown backend {backend!r}")
        spec.validate()
        self.spec = spec
        if backend == "auto":
            from lzw_jax.native.runtime import native_available

            backend = "native" if native_available() else "jax"
        if backend == "native":
            from lzw_jax.native.runtime import get_runtime

            self._native = get_runtime()
        self.backend = backend

    # ---- bytes API -----------------------------------------------------------

    def encode(self, data: bytes | bytearray | memoryview | np.ndarray) -> bytes:
        """Compress ``data`` to the raw reference-compatible stream."""
        data = _as_bytes(data)
        if self.backend == "oracle":
            return _oracle.encode_bytes(data, self.spec)
        if self.backend == "native":
            return self._native.encode(data, self.spec)
        return self._encode_jax(data)

    def decode(self, data: bytes | bytearray | memoryview | np.ndarray) -> bytes:
        """Decompress a raw stream produced by :meth:`encode` (or salzweg)."""
        data = _as_bytes(data)
        if self.backend == "oracle":
            return _oracle.decode_bytes(data, self.spec)
        if self.backend == "native":
            return self._native.decode(data, self.spec)
        return self._decode_jax(data)

    # ---- stream API (reference's Read -> Write shape) ------------------------

    def encode_stream(self, src: BinaryIO, dst: BinaryIO,
                      chunk_size: int = 1 << 20) -> int:
        """Compress all of ``src`` into ``dst``; returns bytes written.

        With the native backend this is truly streaming — O(chunk) memory for
        any stream length, matching the reference's one-byte-at-a-time pull
        from ``Read`` (`encoder.rs:299,313`).  The JAX/oracle backends buffer
        (they are batch codecs by design).
        """
        if self.backend == "native":
            enc = self._native.encoder_stream(self.spec)
            written = 0
            while True:
                chunk = src.read(chunk_size)
                if not chunk:
                    break
                out = enc.feed(chunk)
                dst.write(out)
                written += len(out)
            out = enc.finish()
            dst.write(out)
            return written + len(out)
        out = self.encode(src.read())
        dst.write(out)
        return len(out)

    def decode_stream(self, src: BinaryIO, dst: BinaryIO,
                      chunk_size: int = 1 << 20) -> int:
        """Decompress all of ``src`` into ``dst``; returns bytes written.

        Native backend: incremental, emitting words as they decode with
        bounded memory (`decoder.rs:270`).  Other backends buffer.
        """
        if self.backend == "native":
            dec = self._native.decoder_stream(self.spec)
            written = 0
            while True:
                chunk = src.read(chunk_size)
                if not chunk:
                    break
                for out in dec.feed(chunk):
                    dst.write(out)
                    written += len(out)
            dec.finish()
            return written
        out = self.decode(src.read())
        dst.write(out)
        return len(out)

    # ---- jax paths -----------------------------------------------------------

    def _encode_jax(self, data: bytes) -> bytes:
        import jax.numpy as jnp

        B = _bucket(max(1, len(data)))
        block = np.zeros(B, np.uint8)
        block[: len(data)] = np.frombuffer(data, np.uint8)
        res = _encode.encode_block(jnp.asarray(block), jnp.int32(len(data)), self.spec)
        err = int(res["error"])
        if err == _encode.ERR_UNEXPECTED_CODE:
            raise UnexpectedCodeError(int(res["error_code"]), self.spec.code_size)
        buf, n = bitpack.pack_codes_jax(
            res["codes"], res["widths"], self.spec.endianness,
            out_bytes=_encode.packed_bound(B, self.spec),
        )
        return bytes(np.asarray(buf)[: int(n)])

    def _decode_jax(self, data: bytes) -> bytes:
        import jax.numpy as jnp

        M = _bucket(max(1, len(data)))
        buf = np.zeros(M, np.uint8)
        buf[: len(data)] = np.frombuffer(data, np.uint8)
        dev = jnp.asarray(buf)
        p1 = _decode.decode_pass1(dev, jnp.int32(len(data)), self.spec)
        err = int(p1["error"])
        total = int(p1["total_len"])
        # On a pass-1 error the output is discarded, but pass 2 must still
        # scan the parsed prefix for an EARLIER chain-corruption error (the
        # reference reports whichever the sequential decoder hits first,
        # `decoder.rs:257-260`).  Its underflow detection is independent of
        # the output bound, so use a 1-byte bound instead of materializing
        # ``total`` garbage bytes from a truncated/corrupt table.
        out_bound = 1 if err != _decode.ERR_NONE else _bucket(max(1, total))
        out, err_word_step, err_code2 = _decode.decode_pass2(
            p1["gprefix"], p1["gsuffix"], p1["glocal"], p1["out_g"],
            p1["out_len"], p1["out_off"], p1["out_lit"], out_bound,
            self.spec.alphabet_size,
        )
        self._raise_decode_error(
            err, int(p1["error_code"]), int(p1["n_words"]),
            int(err_word_step), int(err_code2),
        )
        return bytes(np.asarray(out)[:total])

    @staticmethod
    def _raise_decode_error(
        err: int, err_code: int, n_words: int, err_word_step: int, err_code2: int
    ) -> None:
        big = 2**31 - 1
        p1_step = (n_words - 1) if err != _decode.ERR_NONE else big
        if err_word_step < p1_step:
            raise UnexpectedCodeError(err_code2)
        if err == _decode.ERR_UNEXPECTED_CODE:
            raise UnexpectedCodeError(err_code)
        if err == _decode.ERR_MISSING_CLEAR:
            raise MissingClearCodeError()
        if err == _decode.ERR_TRUNCATED:
            raise TruncatedStreamError()


class GifCodec(LzwCodec):
    """GIF-style LZW: caller code size 2..=8, LSB-first, default strategy."""

    def __init__(self, code_size: int, backend: str = "auto"):
        super().__init__(LzwSpec.gif(code_size), backend)


class TiffCodec(LzwCodec):
    """TIFF-style LZW: code size 8, MSB-first, early-change widths."""

    def __init__(self, backend: str = "auto"):
        super().__init__(LzwSpec.tiff(), backend)


class FixedCodec(LzwCodec):
    """Original fixed 12-bit LZW: byte alphabet, no control codes."""

    def __init__(self, endianness: Endianness = Endianness.LITTLE,
                 backend: str = "auto"):
        super().__init__(LzwSpec.fixed(endianness), backend)


class VariableCodec(LzwCodec):
    """Generic variable-width LZW with explicit parameters."""

    def __init__(
        self,
        code_size: int,
        endianness: Endianness,
        strategy: CodeSizeStrategy = CodeSizeStrategy.DEFAULT,
        backend: str = "auto",
    ):
        super().__init__(LzwSpec.variable(code_size, endianness, strategy), backend)


def _as_bytes(data) -> bytes:
    if isinstance(data, np.ndarray):
        if data.dtype != np.uint8:
            raise TypeError(f"expected uint8 array, got {data.dtype}")
        return data.tobytes()
    return bytes(data)
