"""Block-parallel scaling: framing container, shard_map pipeline, multihost."""

from lzw_jax.parallel.block import BlockParallelCodec
from lzw_jax.parallel.framing import FrameHeader, pack_frame, parse_frame

__all__ = ["BlockParallelCodec", "FrameHeader", "pack_frame", "parse_frame"]
