"""lzw_jax — a block-parallel LZW compression framework in JAX.

Built from scratch in JAX/XLA/Pallas with the full capability surface of the
Rust reference library salzweg (redwarp/lzw): GIF-style, TIFF-style and fixed
12-bit LZW with bit-exact wire compatibility, plus block-parallel scaling
across accelerators and hosts that the single-threaded reference never had.
"""

from lzw_jax.utils.cache import enable_compilation_cache

enable_compilation_cache()

from lzw_jax.api import (
    FixedCodec,
    GifCodec,
    LzwCodec,
    TiffCodec,
    VariableCodec,
)
from lzw_jax.spec import (
    CodeSizeError,
    CodeSizeStrategy,
    DecodingError,
    Endianness,
    EncodingError,
    LzwError,
    LzwSpec,
    MissingClearCodeError,
    TruncatedStreamError,
    UnexpectedCodeError,
)

__version__ = "0.1.0"

__all__ = [
    "FixedCodec",
    "GifCodec",
    "LzwCodec",
    "TiffCodec",
    "VariableCodec",
    "CodeSizeError",
    "CodeSizeStrategy",
    "DecodingError",
    "Endianness",
    "EncodingError",
    "LzwError",
    "LzwSpec",
    "MissingClearCodeError",
    "TruncatedStreamError",
    "UnexpectedCodeError",
]
