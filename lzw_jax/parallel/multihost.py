"""Multi-host scaling helpers.

The analog of a distributed communication backend (`SURVEY.md`
§2.4): process-group initialisation via ``jax.distributed``, a global mesh
over every device of every process, and ordered host-side assembly of
per-host compressed payloads with ``multihost_utils.process_allgather``
(which rides the network between hosts).  Intra-host block parallelism stays in
:class:`lzw_jax.parallel.block.BlockParallelCodec` over the host's local
devices; this layer shards *block ranges* across processes.

Single-process environments degrade gracefully: every helper works with
``jax.process_count() == 1`` (the CI configuration).  The multi-process legs
are exercised for real by ``tests/test_multihost.py``, which launches 2-4
CPU processes under ``jax.distributed`` and round-trips uneven block counts
through this codec.
"""

from __future__ import annotations

import math

import numpy as np

import jax

from lzw_jax.parallel import framing
from lzw_jax.parallel.block import BlockParallelCodec, local_mesh
from lzw_jax.spec import LzwSpec

__all__ = ["initialize", "MultiHostBlockCodec"]


def initialize(**kwargs) -> None:
    """Initialise the JAX process group (no-op when already initialised or
    single-process).  Pass-through of ``jax.distributed.initialize`` kwargs."""
    if jax.process_count() > 1:
        return  # already initialised by the runtime
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError):
        # Single-process / already-initialised environments.
        pass


def _process_slice(n_blocks: int, process_id: int, process_count: int):
    """Contiguous block range owned by one process (balanced split)."""
    per = math.ceil(n_blocks / process_count)
    lo = min(process_id * per, n_blocks)
    hi = min(lo + per, n_blocks)
    return lo, hi


class MultiHostBlockCodec:
    """Block-parallel codec sharding block ranges across hosts.

    Each process encodes/decodes its contiguous range of blocks on its local
    devices, then payload bytes are exchanged with ``process_allgather`` so
    every host can assemble the full container in submission order (no
    single-host serialization point: the gather is all-to-all between hosts).
    """

    def __init__(self, spec: LzwSpec, block_size: int = 1 << 16,
                 local_codec: BlockParallelCodec | None = None):
        self.spec = spec
        self.block_size = block_size
        # The local codec must mesh over *addressable* devices only: in a
        # multi-process runtime ``jax.devices()`` is global and a shard_map
        # over non-addressable devices cannot consume host-local arrays.
        self.local = local_codec or BlockParallelCodec(
            spec, block_size, mesh=local_mesh()
        )

    # ---- encode --------------------------------------------------------------

    def encode(self, data: bytes) -> bytes:
        """Compress; every process must pass identical ``data``.

        For truly host-sharded inputs use :meth:`encode_shards` with
        per-host chunks.
        """
        n_proc = jax.process_count()
        if n_proc == 1:
            return self.local.encode(data)
        n_blocks = math.ceil(len(data) / self.block_size)
        lo, hi = _process_slice(n_blocks, jax.process_index(), n_proc)
        local_payloads = self._encode_blocks(data, lo, hi)
        all_payloads = _exchange_block_payloads(local_payloads, n_blocks)
        return framing.pack_frame(
            self.spec, self.block_size, len(data), all_payloads
        )

    def encode_shards(self, shard: bytes, total_size: int) -> bytes:
        """Compress host-sharded input: process p holds blocks [lo_p, hi_p).

        ``shard`` must be exactly this process's contiguous byte range under
        the balanced block split of a ``total_size``-byte stream (the same
        split :meth:`encode` computes); every process receives the full
        container.
        """
        n_proc = jax.process_count()
        if n_proc == 1:
            if len(shard) != total_size:
                raise ValueError("single-process shard must be the whole input")
            return self.local.encode(shard)
        n_blocks = math.ceil(total_size / self.block_size)
        lo, hi = _process_slice(n_blocks, jax.process_index(), n_proc)
        expect = self._range_size(total_size, lo, hi)
        if len(shard) != expect:
            raise ValueError(
                f"process {jax.process_index()} shard is {len(shard)} bytes, "
                f"expected {expect}"
            )
        local_payloads = self._encode_payloads_of(shard)
        all_payloads = _exchange_block_payloads(local_payloads, n_blocks)
        return framing.pack_frame(
            self.spec, self.block_size, total_size, all_payloads
        )

    def _encode_blocks(self, data: bytes, lo: int, hi: int) -> list[bytes]:
        if lo >= hi:
            return []
        return self._encode_payloads_of(
            data[lo * self.block_size : hi * self.block_size]
        )

    def _encode_payloads_of(self, chunk: bytes) -> list[bytes]:
        if not chunk:
            return []
        sub = self.local.encode(chunk)
        _, payloads = framing.parse_frame(sub)
        return [bytes(p) for p in payloads]

    # ---- decode --------------------------------------------------------------

    def decode(self, container: bytes) -> bytes:
        n_proc = jax.process_count()
        if n_proc == 1:
            return self.local.decode(container)
        header, payloads = framing.parse_frame(container)
        lo, hi = _process_slice(header.n_blocks, jax.process_index(), n_proc)
        local_out = b"" if lo >= hi else self.local.decode(
            framing.pack_frame(
                self.spec, self.block_size,
                self._range_orig_size(header, lo, hi),
                [bytes(p) for p in payloads[lo:hi]],
            )
        )
        # One decoded blob per process, gathered in process order; idle
        # processes contribute an empty blob.  Concatenation in process
        # order IS submission order because the block split is contiguous.
        parts = _exchange_blobs(local_out)
        out = b"".join(parts)
        if len(out) != header.orig_size:
            raise framing.FramingError(
                f"decoded {len(out)} bytes, container claims "
                f"{header.orig_size}"
            )
        return out

    def _range_orig_size(self, header: framing.FrameHeader, lo: int, hi: int):
        return self._range_size(header.orig_size, lo, hi)

    def _range_size(self, total: int, lo: int, hi: int) -> int:
        end = min(hi * self.block_size, total)
        return max(0, end - lo * self.block_size)


def _exchange_block_payloads(local: list[bytes], n_blocks: int) -> list[bytes]:
    """All-gather per-process payload lists, reassembled in block order.

    ``process_allgather`` needs identical shapes on every process, so each
    side pads its list to the balanced per-process maximum (``ceil(n/P)``)
    and its payload matrix to the *global* maximum payload length (one extra
    scalar all-gather).  Reconstruction slices per process using the same
    deterministic split — no sentinel/heuristic decoding of padding rows.
    """
    from jax.experimental import multihost_utils

    n_proc = jax.process_count()
    per = math.ceil(n_blocks / n_proc) if n_blocks else 1
    lens = np.zeros(per, np.int64)
    lens[: len(local)] = [len(p) for p in local]
    all_lens = multihost_utils.process_allgather(lens)  # [P, per]
    gmax = int(all_lens.max()) if all_lens.size else 0
    buf = np.zeros((per, max(gmax, 1)), np.uint8)
    for i, p in enumerate(local):
        buf[i, : len(p)] = np.frombuffer(p, np.uint8)
    all_bufs = multihost_utils.process_allgather(buf)  # [P, per, gmax]
    out: list[bytes] = []
    for p in range(n_proc):
        lo, hi = _process_slice(n_blocks, p, n_proc)
        for j in range(hi - lo):
            out.append(all_bufs[p, j, : all_lens[p, j]].tobytes())
    assert len(out) == n_blocks
    return out


def _exchange_blobs(local: bytes) -> list[bytes]:
    """All-gather one variable-length blob per process, in process order."""
    from jax.experimental import multihost_utils

    n = np.array([len(local)], np.int64)
    all_n = multihost_utils.process_allgather(n).reshape(-1)
    gmax = int(all_n.max()) if all_n.size else 0
    buf = np.zeros(max(gmax, 1), np.uint8)
    if local:
        buf[: len(local)] = np.frombuffer(local, np.uint8)
    all_bufs = multihost_utils.process_allgather(buf).reshape(
        all_n.shape[0], -1
    )
    return [all_bufs[p, : all_n[p]].tobytes() for p in range(all_n.shape[0])]
