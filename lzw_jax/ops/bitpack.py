"""Vectorized variable-width bit packing/unpacking.

Vectorized replacement for the reference's streaming bit I/O (`lzw/src/io.rs`).
The reference shifts one code at a time through a u32 accumulator, emitting a
byte whenever 8 bits are ready (`io.rs:239-246`, `:302-309`).  Here the whole
code stream is packed in one data-parallel pass:

  1. exclusive prefix-sum of the code widths gives each code's bit offset;
  2. every code spans at most 3 output bytes (width <= 16, offset-in-byte <= 7,
     16 + 7 = 23 bits < 24), so each code is pre-shifted into a 24-bit window
     and its three byte lanes are scatter-OR'd into the output buffer.

Contributions of distinct codes to a shared byte occupy disjoint bits, so a
scatter-ADD realises the OR.  Codes with width 0 are "holes" (masked-out slots
from the lockstep encoder) and contribute nothing — this lets the encoder emit
a fixed number of slots per input byte without a compaction pass.

Bit-order contract matches `io.rs` exactly, including the trailing ``fill()``
zero-padding of the final partial byte (`io.rs:251-259`, `:314-322`): the
output length is ceil(total_bits / 8) and pad bits are zero.

Both a NumPy implementation (host-side framing, tests) and a jit-friendly JAX
implementation (device-side, static output bound) are provided.
"""

from __future__ import annotations

import numpy as np

from lzw_jax.spec import Endianness

__all__ = [
    "pack_codes_np",
    "unpack_fixed_np",
    "pack_codes_jax",
    "unpack_fixed_jax",
    "packed_size",
]


def packed_size(total_bits: int) -> int:
    return (total_bits + 7) // 8


# --------------------------------------------------------------------------- #
# NumPy                                                                       #
# --------------------------------------------------------------------------- #


def pack_codes_np(
    codes: np.ndarray, widths: np.ndarray, endianness: Endianness
) -> np.ndarray:
    """Pack ``codes[i]`` (widths[i] bits each; width 0 = hole) into bytes."""
    codes = np.asarray(codes, dtype=np.int64)
    widths = np.asarray(widths, dtype=np.int64)
    offsets = np.cumsum(widths) - widths
    total_bits = int(offsets[-1] + widths[-1]) if len(widths) else 0
    n_bytes = packed_size(total_bits)
    out = np.zeros(n_bytes + 2, dtype=np.int64)  # +2 slack for 3-byte windows

    valid = widths > 0
    masked = np.where(valid, codes & ((1 << widths) - 1), 0)
    byte_idx = offsets >> 3
    shift = offsets & 7
    if endianness is Endianness.LITTLE:
        window = masked << shift
        lanes = (window & 0xFF, (window >> 8) & 0xFF, (window >> 16) & 0xFF)
    else:
        window = masked << (24 - widths - shift)
        # width-0 holes would shift by 24-0-sh; masked is 0 there so harmless,
        # but clamp the shift to stay in defined range.
        window = np.where(valid, window, 0)
        lanes = ((window >> 16) & 0xFF, (window >> 8) & 0xFF, window & 0xFF)
    for lane, vals in enumerate(lanes):
        np.add.at(out, np.minimum(byte_idx + lane, n_bytes + 1), vals)
    return out[:n_bytes].astype(np.uint8)


def unpack_fixed_np(
    data: np.ndarray, width: int, endianness: Endianness
) -> np.ndarray:
    """Unpack all whole ``width``-bit codes from a byte array.

    Trailing bits that don't form a whole code are discarded, matching the
    EOF-tolerant bulk read of `io.rs:58-78`.
    """
    data = np.asarray(data, dtype=np.uint8)
    n_codes = (8 * len(data)) // width
    padded = np.concatenate([data.astype(np.int64), np.zeros(2, dtype=np.int64)])
    bit = np.arange(n_codes, dtype=np.int64) * width
    byte_idx = bit >> 3
    shift = bit & 7
    b0, b1, b2 = padded[byte_idx], padded[byte_idx + 1], padded[byte_idx + 2]
    mask = (1 << width) - 1
    if endianness is Endianness.LITTLE:
        window = b0 | (b1 << 8) | (b2 << 16)
        return ((window >> shift) & mask).astype(np.int32)
    window = (b0 << 16) | (b1 << 8) | b2
    return ((window >> (24 - shift - width)) & mask).astype(np.int32)


# --------------------------------------------------------------------------- #
# JAX                                                                         #
# --------------------------------------------------------------------------- #


def pack_codes_jax(codes, widths, endianness: Endianness, out_bytes: int):
    """Jittable pack with a static output bound.

    Args:
      codes:  i32[N] code values (holes allowed).
      widths: i32[N] bit widths, 0 marks a hole.
      endianness: static.
      out_bytes: static output buffer size; must be >= ceil(sum(widths)/8).

    Returns:
      (u8[out_bytes] buffer zero-padded past the stream, i32 n_valid_bytes)
    """
    import jax.numpy as jnp

    codes = codes.astype(jnp.int32)
    widths = widths.astype(jnp.int32)
    offsets = jnp.cumsum(widths) - widths
    total_bits = jnp.sum(widths)
    n_bytes = (total_bits + 7) >> 3

    valid = widths > 0
    masked = jnp.where(valid, codes & ((1 << widths) - 1), 0)
    byte_idx = offsets >> 3
    shift = offsets & 7
    if endianness is Endianness.LITTLE:
        window = masked << shift
        lanes = (window & 0xFF, (window >> 8) & 0xFF, (window >> 16) & 0xFF)
    else:
        window = jnp.where(valid, masked << (24 - widths - shift), 0)
        lanes = ((window >> 16) & 0xFF, (window >> 8) & 0xFF, window & 0xFF)

    out = jnp.zeros(out_bytes + 2, dtype=jnp.int32)
    for lane, vals in enumerate(lanes):
        idx = jnp.minimum(byte_idx + lane, out_bytes + 1)
        out = out.at[idx].add(vals, mode="drop")
    return out[:out_bytes].astype(jnp.uint8), n_bytes


def unpack_fixed_jax(data, width: int, endianness: Endianness, n_codes: int):
    """Jittable fixed-width unpack of a static number of codes.

    ``data`` is u8[M] with at least ceil(n_codes*width/8) valid bytes; callers
    compute ``n_codes = (8 * n_valid_bytes) // width`` host-side (static).
    """
    import jax.numpy as jnp

    padded = jnp.concatenate(
        [data.astype(jnp.int32), jnp.zeros(2, dtype=jnp.int32)]
    )
    bit = jnp.arange(n_codes, dtype=jnp.int32) * width
    byte_idx = bit >> 3
    shift = bit & 7
    b0 = padded[byte_idx]
    b1 = padded[byte_idx + 1]
    b2 = padded[byte_idx + 2]
    mask = (1 << width) - 1
    if endianness is Endianness.LITTLE:
        window = b0 | (b1 << 8) | (b2 << 16)
        return (window >> shift) & mask
    window = (b0 << 16) | (b1 << 8) | b2
    return (window >> (24 - shift - width)) & mask
