"""Block-parallel LZW over a device mesh.

The reference is single-threaded by construction (`SURVEY.md` §2.4): LZW's
dictionary state chains every byte to every previous byte.  This module breaks
the chain at block boundaries — semantically identical to the reference's own
dictionary resets (`encoder.rs:330-333`) — and shards blocks data-parallel
over a `jax.sharding.Mesh` with `shard_map`, gathering compressed payloads in
submission order into the LZWT container (`lzw_jax.parallel.framing`).

All device work is batched and statically shaped: blocks are padded to the
block size, the batch is padded to a multiple of the mesh size, and compressed
payloads live in a [N, packed_bound] matrix with a length vector — the
standard XLA answer to ragged outputs.

Each shard runs one of two device paths, chosen by :func:`device_path`: the
block kernels (`lzw_jax.kernels`, one launch per batch, on the GPU) or the
portable lax codec (`lzw_jax.ops`, everywhere else).
"""

from __future__ import annotations

import functools
import math

import numpy as np

import jax
from jax import shard_map as _shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lzw_jax.kernels import decode_triton, encode_triton
from lzw_jax.ops import bitpack, decode as _decode, encode as _encode
from lzw_jax.parallel import framing
from lzw_jax.spec import (
    LzwSpec,
    MissingClearCodeError,
    TruncatedStreamError,
    UnexpectedCodeError,
)

__all__ = ["BlockParallelCodec", "default_mesh", "device_path", "local_mesh"]

DEFAULT_BLOCK_SIZE = 1 << 16
# The fixed flavor freezes its dictionary after 4096 entries
# (`encoder.rs:645-647`), so long streams drag a stale dictionary; small
# blocks re-learn and usually compress BETTER (-24% on the image corpus at
# 4 KiB vs the reference single stream).
DEFAULT_FIXED_BLOCK_SIZE = 1 << 12

KERNEL = "kernel"
LAX = "lax"


def device_path(platform: str) -> str:
    """The device path of the container on ``platform``.

    ``KERNEL`` is the Pallas block kernels (`kernels/encode_triton.py`,
    `kernels/decode_triton.py`), which compile for the GPU only; ``LAX`` is
    the portable codec.  The kernels won at both block sizes measured on the
    card (4 KiB and 64 KiB, PERF.md), so the choice keys on the platform
    alone.
    """
    return KERNEL if platform == "gpu" else LAX


def default_mesh(axis: str = "data") -> Mesh:
    """All local devices on one data-parallel axis."""
    return Mesh(np.array(jax.devices()), (axis,))


def local_mesh(axis: str = "data") -> Mesh:
    """This process's addressable devices only (multi-process safe)."""
    return Mesh(np.array(jax.local_devices()), (axis,))


def _read_exact(src, n: int) -> bytes:
    """Read exactly n bytes unless EOF (short reads happen on pipes/sockets)."""
    parts = []
    got = 0
    while got < n:
        chunk = src.read(n - got)
        if not chunk:
            break
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts)


class BlockParallelCodec:
    """Container-format codec sharding independent blocks over a mesh.

    Compressed-size budget: each block restarts the dictionary, so block-mode
    output is bounded by the reference's single-stream output plus one
    restart's worth of ramp-up per block plus the container framing — the
    budget called out in `SURVEY.md` §2.4.

    ``use_pallas`` overrides :func:`device_path` (None: choose by platform).
    The kernels compile only for the GPU; elsewhere they run only when
    ``interpret=True`` asks for the Pallas interpreter, as the tests do.
    """

    def __init__(
        self,
        spec: LzwSpec,
        block_size: int | None = None,
        mesh: Mesh | None = None,
        axis: str = "data",
        use_pallas: bool | None = None,
        verify: bool | None = None,
        interpret: bool = False,
    ):
        spec.validate()
        if block_size is None:
            block_size = (
                DEFAULT_BLOCK_SIZE if spec.variable else DEFAULT_FIXED_BLOCK_SIZE
            )
        if block_size <= 0:
            raise ValueError("block_size must be positive")
        self.spec = spec
        self.block_size = block_size
        self.axis = axis
        self.mesh = mesh if mesh is not None else default_mesh(axis)
        self._packed_bound = _encode.packed_bound(block_size, spec)
        platform = self.mesh.devices.flat[0].platform
        if use_pallas is None:
            use_pallas = device_path(platform) == KERNEL
        if use_pallas and platform != "gpu" and not interpret:
            raise ValueError(
                f"the block kernels compile only for the GPU, not {platform}; "
                "pass interpret=True to run them in the Pallas interpreter"
            )
        self.use_pallas = bool(use_pallas)
        # Round-trip self-check of one sampled block per encode batch, on by
        # default whenever a hand-written kernel is in the path: a wrong
        # payload raises VerificationError instead of shipping.  Costs one
        # host-side block decode per encode() call.
        self.verify = self.use_pallas if verify is None else bool(verify)

        if self.use_pallas:
            encode_shard = functools.partial(
                encode_triton.encode_blocks, spec=spec, interpret=interpret
            )
            decode_shard = functools.partial(
                decode_triton.decode_blocks, spec=spec, out_bound=block_size,
                interpret=interpret,
            )
        else:
            encode_shard = jax.vmap(self._encode_one)
            decode_shard = jax.vmap(self._decode_one)

        # check_vma=False: pure data parallelism with no cross-device
        # communication; the lax scans start from replicated constants that
        # become device-varying, which the check would reject.
        def sharded(fn):
            return jax.jit(
                _shard_map(
                    fn,
                    mesh=self.mesh,
                    in_specs=(P(axis), P(axis)),
                    out_specs=(P(axis),) * 4,
                    check_vma=False,
                )
            )

        self._encode_batch = sharded(encode_shard)
        self._decode_batch = sharded(decode_shard)

    def _encode_one(self, block, n_valid):
        res = _encode.encode_block(block, n_valid, self.spec, fix_eoi_width=True)
        buf, n_bytes = bitpack.pack_codes_jax(
            res["codes"], res["widths"], self.spec.endianness,
            out_bytes=self._packed_bound,
        )
        return buf, n_bytes, res["error"], res["error_code"]

    def _decode_one(self, comp, n_valid):
        res = _decode.decode_block(
            comp, n_valid, self.spec, out_bound=self.block_size
        )
        return res["out"], res["total_len"], res["error"], res["error_code"]

    # ---- public API ----------------------------------------------------------

    def encode(self, data: bytes) -> bytes:
        """Compress to the LZWT container."""
        data = bytes(data)
        n_blocks = math.ceil(len(data) / self.block_size) if data else 0
        if n_blocks == 0:
            return framing.pack_frame(self.spec, self.block_size, 0, [])

        N = self._pad_rows(n_blocks)
        bs = self.block_size
        blocks = np.zeros((N, bs), np.uint8)
        lens = np.zeros(N, np.int32)
        arr = np.frombuffer(data, np.uint8)
        full = len(data) // bs
        blocks[:full] = arr[: full * bs].reshape(full, bs)
        lens[:full] = bs
        rem = len(data) - full * bs
        if rem:
            blocks[full, :rem] = arr[full * bs :]
            lens[full] = rem

        bufs, n_bytes, errs, err_codes = self._encode_batch(
            self.shard_rows(blocks), self.shard_rows(lens)
        )
        errs = np.asarray(errs)[:n_blocks]
        if errs.any():
            i = int(np.argmax(errs != 0))
            raise UnexpectedCodeError(
                int(np.asarray(err_codes)[i]), self.spec.code_size
            )
        bufs = np.asarray(bufs)
        n_bytes = np.asarray(n_bytes)
        payloads = [bufs[i, : n_bytes[i]].tobytes() for i in range(n_blocks)]
        if self.verify and payloads:
            self._verify_sample(data, payloads)
        return framing.pack_frame(self.spec, self.block_size, len(data), payloads)

    def _verify_sample(self, data: bytes, payloads: list[bytes]) -> None:
        """Decode-check the largest payload of the batch against its source.

        The largest payload exercises the widest table/width range; the
        check decodes it on the host (native runtime when available, the
        scalar oracle otherwise) and raises :class:`VerificationError` on
        any mismatch.
        """
        from lzw_jax.spec import LzwError, VerificationError

        i = max(range(len(payloads)), key=lambda k: len(payloads[k]))
        bs = self.block_size
        expect = data[i * bs : (i + 1) * bs]
        rt = self._native()
        try:
            if rt is not None:
                got = rt.decode(payloads[i], self.spec)
            else:
                from lzw_jax.ops import reference as _oracle

                got = _oracle.decode_bytes(payloads[i], self.spec)
        except LzwError as exc:
            raise VerificationError(i, f"decode failed: {exc}") from exc
        if got != expect:
            k = next(
                (j for j, (a, b) in enumerate(zip(got, expect)) if a != b),
                min(len(got), len(expect)),
            )
            raise VerificationError(
                i, f"{len(got)}/{len(expect)} bytes, first diff at {k}"
            )

    def decode(self, container: bytes) -> bytes:
        """Decompress an LZWT container (order-preserving gather)."""
        header, payloads = framing.parse_frame(bytes(container))
        # Wire-equivalence, not dataclass equality: any spec constructor that
        # names the same byte format decodes the container.
        if not header.spec.wire_equivalent(self.spec):
            raise framing.FramingError(
                f"container spec {header.spec} != codec spec {self.spec}"
            )
        if header.n_blocks == 0:
            return b""

        N = self._pad_rows(header.n_blocks)
        comp_bound = max(self._packed_bound, max(len(p) for p in payloads))
        comp = np.zeros((N, comp_bound), np.uint8)
        clens = np.zeros(N, np.int32)
        for i, p in enumerate(payloads):
            comp[i, : len(p)] = np.frombuffer(p, np.uint8)
            clens[i] = len(p)

        outs, tlens, errs, err_codes = self._decode_batch(
            self.shard_rows(comp), self.shard_rows(clens)
        )
        errs = np.asarray(errs)[: header.n_blocks]
        if errs.any():
            i = int(np.argmax(errs != 0))
            self._raise_decode(int(errs[i]), int(np.asarray(err_codes)[i]))
        outs = np.asarray(outs)
        tlens = np.asarray(tlens)
        parts = [outs[i, : tlens[i]].tobytes() for i in range(header.n_blocks)]
        out = b"".join(parts)
        if len(out) != header.orig_size:
            raise framing.FramingError(
                f"decoded {len(out)} bytes, container claims {header.orig_size}"
            )
        return out

    # ---- streaming container API ----------------------------------------------

    def encode_stream(self, src, dst, batch_blocks: int = 256) -> int:
        """Compress ``src`` into ``dst`` as an LZWS record stream.

        Memory is O(batch): ``batch_blocks`` blocks are read, encoded on the
        device/mesh as one batch, and written as records before the next
        batch is read — the container-level analog of the reference's
        streaming Read->Write API, for inputs that don't fit in host RAM.
        Returns the number of *uncompressed* bytes consumed.
        """
        framing.write_stream_header(dst, self.spec, self.block_size)
        total = 0
        while True:
            chunk = _read_exact(src, self.block_size * batch_blocks)
            if not chunk:
                break
            total += len(chunk)
            container = self.encode(chunk)
            _, payloads = framing.parse_frame(container)
            for p in payloads:
                framing.write_stream_record(dst, bytes(p))
        framing.write_stream_end(dst, total)
        return total

    def decode_stream(self, src, dst, batch_blocks: int = 256) -> int:
        """Decompress an LZWS record stream; returns bytes written.

        Reads records in batches, decodes each batch on the device/mesh, and
        writes plaintext immediately — bounded memory for any stream length.
        Only the final block of the stream may be shorter than block_size
        (the layout :func:`framing.write_stream_header` documents).
        """
        spec, block_size = framing.read_stream_header(src)
        if not spec.wire_equivalent(self.spec):
            raise framing.FramingError(
                f"stream spec {spec} != codec spec {self.spec}"
            )
        if block_size != self.block_size:
            raise framing.FramingError(
                f"stream block size {block_size} != codec {self.block_size}"
            )
        written = 0
        blocks_done = 0
        batch: list[bytes] = []
        orig_size = None

        def flush(records: list[bytes], final: bool):
            nonlocal written, blocks_done
            if not records:
                return
            if final:
                sub_orig = orig_size - blocks_done * self.block_size
            else:
                # Every record with a successor is a full block (only the
                # stream's final block may be short).
                sub_orig = len(records) * self.block_size
            out = self.decode(framing.pack_frame(
                self.spec, self.block_size, sub_orig, records
            ))
            dst.write(out)
            written += len(out)
            blocks_done += len(records)

        while orig_size is None:
            rec = framing.read_stream_record(src)
            if isinstance(rec, int):
                orig_size = rec
                flush(batch, final=True)
            else:
                batch.append(rec)
                # Keep one record in reserve: the last record of the stream
                # may be a short tail block, and only the final flush knows
                # its true size.
                if len(batch) > batch_blocks:
                    flush(batch[:-1], final=False)
                    batch = batch[-1:]
        if written != orig_size:
            raise framing.FramingError(
                f"decoded {written} bytes, stream claims {orig_size}"
            )
        return written

    def decode_range(self, container: bytes, start_block: int,
                     end_block: int) -> bytes:
        """Decode blocks [start_block, end_block) only.

        The per-block length table makes every block independently decodable
        — the framework's checkpoint/resume and fault-isolation story
        (`SURVEY.md` §5): a failed or interrupted decode restarts at any
        block boundary, and random access costs one header parse.
        """
        header, payloads = framing.parse_frame(bytes(container))
        if not 0 <= start_block <= end_block <= header.n_blocks:
            raise IndexError(
                f"block range [{start_block}, {end_block}) outside "
                f"0..{header.n_blocks}"
            )
        if start_block == end_block:
            return b""
        sub_orig = self._range_orig_size(header, start_block, end_block)
        sub = framing.pack_frame(
            self.spec, self.block_size, sub_orig,
            [bytes(p) for p in payloads[start_block:end_block]],
        )
        return self.decode(sub)

    def _range_orig_size(self, header: framing.FrameHeader, lo: int,
                         hi: int) -> int:
        end = min(hi * self.block_size, header.orig_size)
        return max(0, end - lo * self.block_size)

    # ---- helpers -------------------------------------------------------------

    def shard_rows(self, rows: np.ndarray) -> jax.Array:
        """Place a host batch on the mesh, its rows split over the devices."""
        return jax.device_put(rows, NamedSharding(self.mesh, P(self.axis)))

    @staticmethod
    def _native():
        """The native runtime, or None when the toolchain is unavailable."""
        try:
            from lzw_jax.native.runtime import get_runtime

            return get_runtime()
        except Exception:
            return None

    def _pad_rows(self, n: int) -> int:
        """Pad the batch to a multiple of the mesh size (power-of-two steps)."""
        ndev = self.mesh.devices.size
        N = ndev
        while N < n:
            N *= 2
        return N

    @staticmethod
    def _raise_decode(err: int, err_code: int):
        if err == _decode.ERR_UNEXPECTED_CODE:
            raise UnexpectedCodeError(err_code)
        if err == _decode.ERR_MISSING_CLEAR:
            raise MissingClearCodeError()
        if err == _decode.ERR_TRUNCATED:
            raise TruncatedStreamError()
        raise AssertionError(f"unknown decode error kind {err}")
