"""Error-kind differential fuzz: corrupt streams fail identically everywhere.

The reference pins exact error types and payloads (`decoder.rs:240-242`
UnexpectedCode, `:257-260` corrupt chain, `:281-283` MissingClearCode; io
truncation via `io.rs:45`).  This fuzz drives randomly corrupted streams
through every backend (scalar oracle, XLA codec, native batch, native
streaming) and asserts they agree on the *outcome*: either the identical
decoded bytes, or the identical exception class and offending code.
"""

import io

import numpy as np
import pytest

from lzw_jax.api import LzwCodec
from lzw_jax.native.runtime import get_runtime, native_available
from lzw_jax.spec import (
    DecodingError,
    Endianness,
    LzwSpec,
    MissingClearCodeError,
    TruncatedStreamError,
    UnexpectedCodeError,
)

SPECS = [
    LzwSpec.gif(7),
    LzwSpec.tiff(),
    LzwSpec.fixed(Endianness.LITTLE),
]
IDS = ["gif7", "tiff", "fixed_le"]


def _outcome(fn, *args):
    """(kind, payload) capturing success bytes or typed failure + code."""
    try:
        return ("ok", fn(*args))
    except UnexpectedCodeError as e:
        return ("unexpected", e.code)
    except MissingClearCodeError:
        return ("missing_clear", None)
    except TruncatedStreamError:
        return ("truncated", None)
    except DecodingError as e:  # pragma: no cover - unexpected class
        return ("other", type(e).__name__)


def _corruptions(stream: bytes, rng) -> list[bytes]:
    out = []
    if len(stream) < 4:
        return out
    for _ in range(3):  # random byte flips
        b = bytearray(stream)
        i = int(rng.integers(0, len(b)))
        b[i] ^= int(rng.integers(1, 256))
        out.append(bytes(b))
    out.append(stream[: int(rng.integers(1, len(stream)))])  # truncation
    # Splice two halves from different positions (desyncs widths).
    i = int(rng.integers(1, len(stream)))
    j = int(rng.integers(1, len(stream)))
    out.append(stream[:i] + stream[j:])
    # Pure noise.
    out.append(rng.integers(0, 256, size=int(rng.integers(4, 60)))
               .astype(np.uint8).tobytes())
    return out


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_decode_error_parity(spec):
    if not native_available():
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(0xE44)
    rt = get_runtime()
    oracle = LzwCodec(spec, backend="oracle")
    jax_codec = LzwCodec(spec, backend="jax")

    hi = 1 << spec.code_size
    for trial in range(5):
        data = rng.integers(0, hi, size=int(rng.integers(20, 400))).astype(
            np.uint8).tobytes()
        stream = oracle.encode(data)
        for k, bad in enumerate(_corruptions(stream, rng)):
            want = _outcome(oracle.decode, bad)
            got_native = _outcome(rt.decode, bad, spec)
            assert got_native == want, (
                f"native vs oracle on trial {trial} corruption {k}: "
                f"{got_native} != {want}"
            )
            got_jax = _outcome(jax_codec.decode, bad)
            assert got_jax == want, (
                f"jax vs oracle on trial {trial} corruption {k}: "
                f"{got_jax} != {want}"
            )

            def stream_decode(payload):
                dst = io.BytesIO()
                LzwCodec(spec, backend="native").decode_stream(
                    io.BytesIO(payload), dst, chunk_size=17
                )
                return dst.getvalue()

            got_stream = _outcome(stream_decode, bad)
            assert got_stream == want, (
                f"stream vs oracle on trial {trial} corruption {k}: "
                f"{got_stream} != {want}"
            )
