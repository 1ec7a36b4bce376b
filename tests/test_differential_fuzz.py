"""Cross-implementation differential fuzzing.

The reference's differential oracle is its exploration crate asserting six
encoder designs produce identical code streams (`exploration/src/lib.rs:
539-607`).  Here all four implementations of this framework — scalar
oracle, XLA codecs, the GPU block kernels (Pallas interpreter) and the
native C++ runtime — are driven over randomized inputs and must agree
byte-for-byte, flavor by flavor.

Runtime-bounded: sizes and trial counts are chosen to keep the whole module
under ~1 minute on CI hardware.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from lzw_jax.api import LzwCodec
from lzw_jax.kernels import decode_triton, encode_triton
from lzw_jax.native.runtime import get_runtime, native_available
from lzw_jax.ops import reference as oracle
from lzw_jax.spec import CodeSizeStrategy, Endianness, LzwSpec

SPECS = [
    LzwSpec.gif(3),
    LzwSpec.tiff(),
    LzwSpec.fixed(Endianness.LITTLE),
    LzwSpec.fixed(Endianness.BIG),
    LzwSpec.variable(6, Endianness.BIG, CodeSizeStrategy.TIFF),
]
IDS = ["gif3", "tiff", "fixed_le", "fixed_be", "var6_be_tiff"]


def _gen_inputs(spec, rng, n_cases=6):
    hi = 1 << spec.code_size
    out = []
    for _ in range(n_cases):
        kind = rng.integers(0, 4)
        n = int(rng.integers(0, 300))
        if kind == 0:  # uniform random
            data = rng.integers(0, hi, size=n)
        elif kind == 1:  # runs
            data = np.repeat(rng.integers(0, hi, size=max(n // 9, 1)), 9)[:n]
        elif kind == 2:  # tiny alphabet (KwKwK-heavy)
            data = rng.integers(0, min(3, hi), size=n)
        else:  # periodic
            period = rng.integers(1, 8)
            data = np.tile(rng.integers(0, hi, size=period), n // period + 1)[:n]
        out.append(data.astype(np.uint8).tobytes())
    return out


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_all_backends_agree(spec):
    rng = np.random.default_rng(0xC0DEC)
    jax_codec = LzwCodec(spec, backend="jax")
    rt = get_runtime() if native_available() else None

    for data in _gen_inputs(spec, rng):
        golden = oracle.encode_bytes(data, spec)
        assert jax_codec.encode(data) == golden, f"jax encode ({len(data)}B)"
        if rt is not None:
            assert rt.encode(data, spec) == golden, "native encode"
        codes = oracle.encode_codes(data, spec)
        if not oracle.eoi_width_quirk(codes, spec):
            assert jax_codec.decode(golden) == data, "jax decode"
            if rt is not None:
                assert rt.decode(golden, spec) == data, "native decode"


@pytest.mark.parametrize("spec", [LzwSpec.gif(3), LzwSpec.fixed(Endianness.BIG)],
                         ids=["gif3", "fixed_be"])
def test_pallas_kernel_agrees(spec):
    # The GPU block kernels, in the Pallas interpreter: encode equals the
    # oracle's stream, decode gives back the input.
    rng = np.random.default_rng(0xF00D)
    datas = [d[:128] for d in _gen_inputs(spec, rng, n_cases=5)]
    mat = np.zeros((len(datas), 128), np.uint8)
    lens = np.zeros(len(datas), np.int32)
    for i, d in enumerate(datas):
        mat[i, : len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    payloads, lengths, errs, _ = encode_triton.encode_blocks(
        jnp.asarray(mat), jnp.asarray(lens), spec, fix_eoi=False, lanes=4,
        interpret=True,
    )
    assert not np.asarray(errs).any()
    payloads, lengths = np.asarray(payloads), np.asarray(lengths)
    for i, d in enumerate(datas):
        assert payloads[i, : lengths[i]].tobytes() == oracle.encode_bytes(
            d, spec
        ), f"case {i}"
    out, totals, errs, _ = decode_triton.decode_blocks(
        jnp.asarray(payloads), jnp.asarray(lengths), spec, out_bound=128,
        lanes=4, interpret=True,
    )
    out, totals = np.asarray(out), np.asarray(totals)
    for i, d in enumerate(datas):
        if not oracle.eoi_width_quirk(oracle.encode_codes(d, spec), spec):
            assert int(np.asarray(errs)[i]) == 0
            assert out[i, : totals[i]].tobytes() == d, f"case {i}"
