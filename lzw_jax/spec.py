"""Configuration types and error contract for the LZW framework.

Capability parity notes (reference: redwarp/lzw "salzweg", mounted at /root/reference):

* ``Endianness``        mirrors `lzw/src/lib.rs:59-65`.
* ``CodeSizeStrategy``  mirrors `lzw/src/lib.rs:71-91` (``increment`` is 0 for the
  default strategy and 1 for TIFF "early change").
* The error taxonomy mirrors `lzw/src/encoder.rs:16-52` (``Io``, ``CodeSize``,
  ``UnexpectedCode``) and `lzw/src/decoder.rs:14-50` (``Io``, ``CodeSize``,
  ``UnexpectedCode``, ``MissingClearCode``).  Host I/O errors surface as native
  Python ``OSError``; the LZW-specific conditions get typed exceptions below so user
  code can catch the same cases the reference distinguishes.

Unlike the reference, which threads ``code_size``/``endianness``/``strategy`` through
every call, this framework freezes the full wire-format description in an immutable
``LzwSpec``.  A spec is hashable and is used as a static argument to jitted
encode/decode functions, so each distinct wire format compiles exactly once.
"""

from __future__ import annotations

import dataclasses
import enum

__all__ = [
    "Endianness",
    "CodeSizeStrategy",
    "LzwSpec",
    "LzwError",
    "EncodingError",
    "DecodingError",
    "CodeSizeError",
    "UnexpectedCodeError",
    "MissingClearCodeError",
    "TruncatedStreamError",
    "VerificationError",
    "MAX_WIDTH",
    "MAX_TABLE_SIZE",
    "MAX_WORD_LEN",
]

# Hard wire-format constants shared by every salzweg flavor.
MAX_WIDTH = 12  # `encoder.rs:279` MAX_WRITE_SIZE / `decoder.rs:193` MAX_READ_SIZE
MAX_TABLE_SIZE = 4096  # `decoder.rs:185`
# Longest decodable word: 4096 - 2^2 - 2 + 1 (`decoder.rs:186-192`).
MAX_WORD_LEN = 4091


class Endianness(enum.Enum):
    """Bit-packing order of codes in the compressed byte stream."""

    BIG = "big"
    LITTLE = "little"


class CodeSizeStrategy(enum.Enum):
    """When the variable-width read/write size bumps.

    DEFAULT bumps when the dictionary reaches ``2**width``; TIFF bumps one code
    earlier ("early change", ``2**width - 1``).
    """

    DEFAULT = 0
    TIFF = 1

    @property
    def increment(self) -> int:
        return self.value


class LzwError(Exception):
    """Base class for all LZW codec errors."""


class EncodingError(LzwError):
    """Base class for errors raised while encoding."""


class DecodingError(LzwError):
    """Base class for errors raised while decoding."""


class CodeSizeError(EncodingError, DecodingError):
    """Code size out of bounds; it must be between 2 and 8 included."""

    def __init__(self, code_size: int):
        self.code_size = code_size
        super().__init__(f"Code size must be between 2 and 8, was {code_size}.")


class UnexpectedCodeError(EncodingError, DecodingError):
    """An out-of-range symbol was encountered.

    While encoding: an input byte >= 2**code_size (`encoder.rs:315-317`).
    While decoding: a code beyond the next free dictionary index
    (`decoder.rs:240-242`) or a corrupt suffix chain (`decoder.rs:257-260`).
    """

    def __init__(self, code: int, code_size: int | None = None):
        self.code = code
        self.code_size = code_size
        if code_size is not None:
            msg = (
                f"Unexpected code {code}. For code size {code_size}, "
                f"data should be < {1 << code_size}."
            )
        else:
            msg = f"Unexpected code while decompressing: {code}"
        super().__init__(msg)


class MissingClearCodeError(DecodingError):
    """The dictionary would grow past 4096 entries without a CLEAR code."""

    def __init__(self):
        super().__init__(
            "Dictionary growing past 4096, expected CLEAR_CODE missing"
        )


class TruncatedStreamError(DecodingError):
    """The compressed stream ended before an expected code could be read.

    The reference surfaces this as an ``Io`` error from ``read_exact``
    (`io.rs:45`); this framework types it explicitly.
    """

    def __init__(self):
        super().__init__("Compressed stream ended unexpectedly")


class VerificationError(EncodingError):
    """An encoded payload failed its on-the-fly round-trip self-check.

    Raised by the container encoder's ``verify`` mode, which decode-checks a
    sampled block per batch on the host: with two known shape-triggered
    hardware miscompiles worked around in the kernels (EVOLUTION.md), a new
    shape miscomputing should be a loud error, not silent corruption.  The
    reference's analog is its always-asserted determinism posture
    (`encoder.rs:715-737`).
    """

    def __init__(self, block_index: int, detail: str = ""):
        self.block_index = block_index
        msg = f"Encoded payload failed round-trip verification at block " \
              f"{block_index}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


@dataclasses.dataclass(frozen=True)
class LzwSpec:
    """Immutable description of one LZW wire format.

    Use the class methods :meth:`gif`, :meth:`tiff`, :meth:`fixed` or
    :meth:`variable` instead of the raw constructor; they mirror the four facade
    types of the reference (`encoder.rs:353,446,530,153`).
    """

    code_size: int
    endianness: Endianness
    strategy: CodeSizeStrategy
    variable: bool  # variable-width with CLEAR/EOI vs fixed 12-bit, no controls

    # ---- flavor constructors -------------------------------------------------

    @classmethod
    def gif(cls, code_size: int) -> "LzwSpec":
        """GIF-style: caller code size 2..=8, LSB-first, default strategy."""
        return cls(code_size, Endianness.LITTLE, CodeSizeStrategy.DEFAULT, True)

    @classmethod
    def tiff(cls) -> "LzwSpec":
        """TIFF-style: code size 8, MSB-first, early-change strategy."""
        return cls(8, Endianness.BIG, CodeSizeStrategy.TIFF, True)

    @classmethod
    def fixed(cls, endianness: Endianness) -> "LzwSpec":
        """Original fixed 12-bit LZW: byte alphabet, no CLEAR/EOI codes."""
        return cls(8, endianness, CodeSizeStrategy.DEFAULT, False)

    @classmethod
    def variable(
        cls,
        code_size: int,
        endianness: Endianness,
        strategy: CodeSizeStrategy = CodeSizeStrategy.DEFAULT,
    ) -> "LzwSpec":
        """Generic variable-width flavor with explicit parameters."""
        return cls(code_size, endianness, strategy, True)

    # ---- derived wire-format facts ------------------------------------------

    def validate(self) -> None:
        """Raise :class:`CodeSizeError` unless 2 <= code_size <= 8.

        Only the variable flavors validate (`encoder.rs:281-283`,
        `decoder.rs:180-182`); the fixed flavor hard-wires code size 8.
        """
        if self.variable and not 2 <= self.code_size <= 8:
            raise CodeSizeError(self.code_size)

    @property
    def alphabet_size(self) -> int:
        return 1 << self.code_size

    @property
    def clear_code(self) -> int:
        """Only meaningful for variable flavors."""
        return 1 << self.code_size

    @property
    def end_code(self) -> int:
        """END-OF-INFORMATION; only meaningful for variable flavors."""
        return (1 << self.code_size) + 1

    @property
    def first_free_code(self) -> int:
        """Index of the first dictionary entry added at runtime."""
        return self.alphabet_size + 2 if self.variable else self.alphabet_size

    @property
    def initial_width(self) -> int:
        """Read/write width right after (re)initialisation."""
        return self.code_size + 1 if self.variable else MAX_WIDTH

    @property
    def max_code_value(self) -> int:
        """Largest input byte value the encoder accepts beyond the first byte."""
        return self.alphabet_size - 1

    def width_bump_threshold(self, width: int) -> int:
        """Dictionary size at which the width bumps past ``width``.

        Mirrors ``(1 << width) - strategy.increment()`` (`encoder.rs:292`,
        `decoder.rs:213`).
        """
        return (1 << width) - self.strategy.increment

    def wire_key(self) -> tuple:
        """Canonical key of the *wire format* this spec describes.

        Two specs with equal wire keys produce and accept byte-identical
        streams even if constructed differently: the fixed flavor hard-wires
        code size 8 and never consults the width-bump strategy
        (`encoder.rs:618-658`), so those fields are excluded for it.
        """
        if self.variable:
            return (True, self.code_size, self.endianness, self.strategy)
        return (False, self.endianness)

    def wire_equivalent(self, other: "LzwSpec") -> bool:
        """True when ``other`` reads/writes the same byte streams as self."""
        return self.wire_key() == other.wire_key()
