"""ctypes bindings and build driver for the native host runtime.

Builds ``lzw_native.cpp`` with the system toolchain on first use (cached in
``native/build/``), then exposes a typed Python API mirroring the device
codecs.  No pybind11: the library is a plain C ABI loaded via ctypes.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

from lzw_jax.spec import (
    CodeSizeError,
    Endianness,
    LzwSpec,
    MissingClearCodeError,
    TruncatedStreamError,
    UnexpectedCodeError,
)

__all__ = ["NativeRuntime", "get_runtime", "native_available"]

_SRC = pathlib.Path(__file__).resolve().parent / "lzw_native.cpp"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
_LIB = _BUILD_DIR / "liblzw_native.so"

_OK = 0
_ERR_BUF = -1
_ERR_CODE_SIZE = -2
_ERR_UNEXPECTED_ENC = -3
_ERR_UNEXPECTED_DEC = -4
_ERR_MISSING_CLEAR = -5
_ERR_TRUNCATED = -6

_lock = threading.Lock()
_runtime: "NativeRuntime | None" = None
_build_error: Exception | None = None


def _build() -> pathlib.Path:
    """Compile the shared library if missing or stale."""
    _BUILD_DIR.mkdir(exist_ok=True)
    if _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return _LIB
    cmd = [
        os.environ.get("CXX", "g++"),
        "-O3", "-march=native", "-std=c++17", "-fPIC", "-shared", "-pthread",
        str(_SRC), "-o", str(_LIB),
    ]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return _LIB


class NativeRuntime:
    """Host-side codec over the native library."""

    def __init__(self, lib_path: pathlib.Path | None = None):
        path = lib_path or _build()
        lib = ctypes.CDLL(str(path))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        szp = ctypes.POINTER(ctypes.c_size_t)
        ip = ctypes.POINTER(ctypes.c_int)

        lib.lzw_encode.restype = ctypes.c_int
        lib.lzw_encode.argtypes = [
            u8p, ctypes.c_size_t, u8p, ctypes.c_size_t, szp,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ip,
        ]
        lib.lzw_decode.restype = ctypes.c_int
        lib.lzw_decode.argtypes = [
            u8p, ctypes.c_size_t, u8p, ctypes.c_size_t, szp,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ip,
        ]
        lib.lzw_encode_blocks.restype = ctypes.c_int
        lib.lzw_encode_blocks.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_size_t, u8p, ctypes.c_size_t,
            u32p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ip,
        ]
        lib.lzw_decode_blocks.restype = ctypes.c_int
        lib.lzw_decode_blocks.argtypes = [
            u8p, u32p, u32p, ctypes.c_size_t, u8p, ctypes.c_size_t, u32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ip,
        ]
        # Incremental streaming codec (O(1)-memory Read->Write shape,
        # `encoder.rs:299` / `decoder.rs:270`).
        lib.lzw_enc_stream_new.restype = ctypes.c_void_p
        lib.lzw_enc_stream_new.argtypes = [ctypes.c_int] * 5
        lib.lzw_enc_stream_feed.restype = ctypes.c_int
        lib.lzw_enc_stream_feed.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_size_t, u8p, ctypes.c_size_t,
            szp, ip,
        ]
        lib.lzw_enc_stream_finish.restype = ctypes.c_int
        lib.lzw_enc_stream_finish.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_size_t, szp,
        ]
        lib.lzw_enc_stream_free.restype = None
        lib.lzw_enc_stream_free.argtypes = [ctypes.c_void_p]
        lib.lzw_dec_stream_new.restype = ctypes.c_void_p
        lib.lzw_dec_stream_new.argtypes = [ctypes.c_int] * 4
        lib.lzw_dec_stream_feed.restype = ctypes.c_int
        lib.lzw_dec_stream_feed.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_size_t, u8p, ctypes.c_size_t,
            szp, szp, ip,
        ]
        lib.lzw_dec_stream_finish.restype = ctypes.c_int
        lib.lzw_dec_stream_finish.argtypes = [ctypes.c_void_p]
        lib.lzw_dec_stream_free.restype = None
        lib.lzw_dec_stream_free.argtypes = [ctypes.c_void_p]
        self._lib = lib

    # ---- helpers -------------------------------------------------------------

    @staticmethod
    def _spec_args(spec: LzwSpec):
        return (
            spec.code_size,
            0 if spec.endianness is Endianness.LITTLE else 1,
            spec.strategy.increment,
            1 if spec.variable else 0,
        )

    @staticmethod
    def _raise(rc: int, err_code: int, spec: LzwSpec, encoding: bool):
        if rc == _ERR_CODE_SIZE:
            raise CodeSizeError(spec.code_size)
        if rc == _ERR_UNEXPECTED_ENC:
            raise UnexpectedCodeError(err_code, spec.code_size)
        if rc == _ERR_UNEXPECTED_DEC:
            raise UnexpectedCodeError(err_code)
        if rc == _ERR_MISSING_CLEAR:
            raise MissingClearCodeError()
        if rc == _ERR_TRUNCATED:
            raise TruncatedStreamError()
        if rc == _ERR_BUF:
            raise AssertionError("native output buffer undersized (bug)")
        raise AssertionError(f"unknown native rc {rc}")

    @staticmethod
    def _as_u8p(arr: np.ndarray):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    # ---- single-stream API ---------------------------------------------------

    def encode(self, data: bytes, spec: LzwSpec, fix_eoi: bool = False) -> bytes:
        spec.validate()
        src = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
        cap = 2 * len(data) + (len(data) // 2048 + 8) * 2 + 16
        out = np.zeros(cap, np.uint8)
        out_len = ctypes.c_size_t(0)
        err = ctypes.c_int(0)
        rc = self._lib.lzw_encode(
            self._as_u8p(src), len(data), self._as_u8p(out), cap,
            ctypes.byref(out_len), *self._spec_args(spec),
            1 if fix_eoi else 0, ctypes.byref(err),
        )
        if rc != _OK:
            self._raise(rc, err.value, spec, encoding=True)
        return out[: out_len.value].tobytes()

    def decode(self, data: bytes, spec: LzwSpec) -> bytes:
        spec.validate()
        src = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
        cap = max(64, 16 * len(data))
        while True:
            out = np.zeros(cap, np.uint8)
            out_len = ctypes.c_size_t(0)
            err = ctypes.c_int(0)
            rc = self._lib.lzw_decode(
                self._as_u8p(src), len(data), self._as_u8p(out), cap,
                ctypes.byref(out_len), *self._spec_args(spec),
                ctypes.byref(err),
            )
            if rc == _ERR_BUF:
                cap *= 4
                continue
            if rc != _OK:
                self._raise(rc, err.value, spec, encoding=False)
            return out[: out_len.value].tobytes()

    # ---- block API -----------------------------------------------------------

    def encode_blocks(
        self, data: bytes, spec: LzwSpec, block_size: int,
        n_threads: int | None = None,
    ) -> list[bytes]:
        """Threaded block-parallel encode; payloads in submission order."""
        spec.validate()
        n_blocks = (len(data) + block_size - 1) // block_size
        if n_blocks == 0:
            return []
        from lzw_jax.ops.encode import packed_bound

        stride = packed_bound(block_size, spec)
        src = np.frombuffer(data, np.uint8)
        out = np.zeros(n_blocks * stride, np.uint8)
        lengths = np.zeros(n_blocks, np.uint32)
        err = ctypes.c_int(0)
        threads = n_threads or min(os.cpu_count() or 1, 32)
        rc = self._lib.lzw_encode_blocks(
            self._as_u8p(src), len(data), block_size, self._as_u8p(out),
            stride, lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            n_blocks, *self._spec_args(spec), threads, ctypes.byref(err),
        )
        if rc != _OK:
            self._raise(rc, err.value, spec, encoding=True)
        return [
            out[b * stride : b * stride + lengths[b]].tobytes()
            for b in range(n_blocks)
        ]

    def decode_blocks(
        self, payloads: list[bytes], spec: LzwSpec, block_size: int,
        n_threads: int | None = None,
    ) -> bytes:
        """Threaded block-parallel decode of container payloads."""
        spec.validate()
        n_blocks = len(payloads)
        if n_blocks == 0:
            return b""
        comp = np.frombuffer(b"".join(payloads), np.uint8)
        if comp.size == 0:
            comp = np.zeros(1, np.uint8)
        lens = np.array([len(p) for p in payloads], np.uint32)
        offs = np.zeros(n_blocks, np.uint32)
        np.cumsum(lens[:-1], out=offs[1:])
        out = np.zeros(n_blocks * block_size, np.uint8)
        out_lens = np.zeros(n_blocks, np.uint32)
        err = ctypes.c_int(0)
        threads = n_threads or min(os.cpu_count() or 1, 32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        rc = self._lib.lzw_decode_blocks(
            self._as_u8p(comp), offs.ctypes.data_as(u32p),
            lens.ctypes.data_as(u32p), n_blocks, self._as_u8p(out),
            block_size, out_lens.ctypes.data_as(u32p),
            *self._spec_args(spec), threads, ctypes.byref(err),
        )
        if rc != _OK:
            self._raise(rc, err.value, spec, encoding=False)
        return b"".join(
            out[b * block_size : b * block_size + out_lens[b]].tobytes()
            for b in range(n_blocks)
        )

    # ---- streaming API ---------------------------------------------------------

    def encoder_stream(self, spec: LzwSpec, fix_eoi: bool = False):
        """Incremental encoder handle; see :class:`_EncoderStream`."""
        spec.validate()
        return _EncoderStream(self._lib, spec, fix_eoi)

    def decoder_stream(self, spec: LzwSpec):
        """Incremental decoder handle; see :class:`_DecoderStream`."""
        spec.validate()
        return _DecoderStream(self._lib, spec)


class _EncoderStream:
    """Stateful chunk-at-a-time encoder over the native stream codec.

    The analog of the reference's Read->Write streaming encode
    (`encoder.rs:299,313`): memory use is O(chunk), not O(stream).
    """

    def __init__(self, lib, spec: LzwSpec, fix_eoi: bool):
        self._lib = lib
        self.spec = spec
        cs, be, inc, var = NativeRuntime._spec_args(spec)
        self._h = lib.lzw_enc_stream_new(cs, be, inc, var, 1 if fix_eoi else 0)
        if not self._h:
            raise CodeSizeError(spec.code_size)

    def feed(self, chunk: bytes) -> bytes:
        if self._h is None:
            raise ValueError("encoder stream already finished")
        src = np.frombuffer(chunk, np.uint8) if chunk else np.zeros(1, np.uint8)
        cap = 2 * len(chunk) + 64
        out = np.zeros(cap, np.uint8)
        out_len = ctypes.c_size_t(0)
        err = ctypes.c_int(0)
        rc = self._lib.lzw_enc_stream_feed(
            self._h, NativeRuntime._as_u8p(src), len(chunk),
            NativeRuntime._as_u8p(out), cap, ctypes.byref(out_len),
            ctypes.byref(err),
        )
        if rc != _OK:
            NativeRuntime._raise(rc, err.value, self.spec, encoding=True)
        return out[: out_len.value].tobytes()

    def finish(self) -> bytes:
        if self._h is None:
            raise ValueError("encoder stream already finished")
        out = np.zeros(16, np.uint8)
        out_len = ctypes.c_size_t(0)
        rc = self._lib.lzw_enc_stream_finish(
            self._h, NativeRuntime._as_u8p(out), 16, ctypes.byref(out_len)
        )
        self.close()
        if rc != _OK:
            NativeRuntime._raise(rc, 0, self.spec, encoding=True)
        return out[: out_len.value].tobytes()

    def close(self):
        if self._h is not None:
            self._lib.lzw_enc_stream_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        self.close()


class _DecoderStream:
    """Stateful chunk-at-a-time decoder (`decoder.rs:270` streaming shape)."""

    def __init__(self, lib, spec: LzwSpec):
        self._lib = lib
        self.spec = spec
        cs, be, inc, var = NativeRuntime._spec_args(spec)
        self._h = lib.lzw_dec_stream_new(cs, be, inc, var)
        if not self._h:
            raise CodeSizeError(spec.code_size)
        self._pending = b""

    def feed(self, chunk: bytes, out_cap: int = 1 << 20):
        """Decode one compressed chunk; yields decoded byte chunks.

        Bounded memory: at most ``out_cap`` decoded bytes are materialised at
        a time; unconsumed input is re-fed automatically.
        """
        if self._h is None:
            raise ValueError("decoder stream already finished")
        data = self._pending + bytes(chunk)
        self._pending = b""
        # A single word is at most MAX_WORD_LEN (4091) bytes; capping below
        # that could make zero progress on a full buffer.
        out_cap = max(out_cap, 8192)
        out = np.zeros(out_cap, np.uint8)
        while data:
            src = np.frombuffer(data, np.uint8)
            out_len = ctypes.c_size_t(0)
            consumed = ctypes.c_size_t(0)
            err = ctypes.c_int(0)
            rc = self._lib.lzw_dec_stream_feed(
                self._h, NativeRuntime._as_u8p(src), len(data),
                NativeRuntime._as_u8p(out), out_cap, ctypes.byref(out_len),
                ctypes.byref(consumed), ctypes.byref(err),
            )
            if rc != _OK:
                NativeRuntime._raise(rc, err.value, self.spec, encoding=False)
            if out_len.value:
                yield out[: out_len.value].tobytes()
            if consumed.value >= len(data):
                return
            if out_len.value == 0:
                # No progress and input unconsumed: a mid-code tail — keep
                # the remainder for the next feed.
                self._pending = data[consumed.value :]
                return
            data = data[consumed.value :]

    def finish(self) -> None:
        if self._h is None:
            raise ValueError("decoder stream already finished")
        rc = self._lib.lzw_dec_stream_finish(self._h)
        self.close()
        if rc != _OK:
            NativeRuntime._raise(rc, 0, self.spec, encoding=False)

    def close(self):
        if self._h is not None:
            self._lib.lzw_dec_stream_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        self.close()


def native_available() -> bool:
    try:
        return get_runtime() is not None
    except Exception:
        return False


def get_runtime() -> NativeRuntime:
    """Build-once, process-wide native runtime."""
    global _runtime, _build_error
    with _lock:
        if _runtime is not None:
            return _runtime
        if _build_error is not None:
            raise _build_error
        try:
            _runtime = NativeRuntime()
        except Exception as e:  # toolchain missing etc.
            _build_error = e
            raise
        return _runtime
