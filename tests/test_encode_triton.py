"""The GPU encode kernel, run in the Pallas interpreter, against the oracle.

Every payload must equal the scalar oracle's stream (and the native
runtime's with the EOI width fix), block by block, for every flavor and at
the dictionary's boundaries: table full, reset epochs, short and empty
blocks, out-of-range bytes.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from kernel_cases import SPECS, alphabet, matrix, sample
from lzw_jax.kernels.encode_triton import encode_blocks
from lzw_jax.native.runtime import get_runtime, native_available
from lzw_jax.ops import encode as lax_encode
from lzw_jax.ops import reference as oracle
from lzw_jax.spec import LzwSpec, MAX_TABLE_SIZE

B = 320  # one block shape for the sweeps: one compile per flavor


def run(rows, spec, block=None, lanes=4, fix_eoi=True):
    mat, lens = matrix(rows, block)
    out, n_bytes, err, err_code = encode_blocks(
        jnp.asarray(mat), jnp.asarray(lens), spec, fix_eoi=fix_eoi,
        lanes=lanes, interpret=True,
    )
    out, n_bytes = np.asarray(out), np.asarray(n_bytes)
    return ([out[i, : n_bytes[i]].tobytes() for i in range(len(rows))],
            np.asarray(err), np.asarray(err_code), out.shape)


def expected(data: bytes, spec: LzwSpec, fix_eoi: bool = True) -> bytes:
    codes = oracle.encode_codes(data, spec)
    if fix_eoi and oracle.eoi_width_quirk(codes, spec):
        return get_runtime().encode(data, spec, fix_eoi=True)
    return oracle.pack_codes(codes, spec.endianness)


@pytest.mark.parametrize("kind", ["random", "runs", "kwkwk", "periodic"])
@pytest.mark.parametrize("name", list(SPECS))
def test_matches_oracle(name, kind):
    spec = SPECS[name]
    rng = np.random.default_rng(len(name) * 31 + len(kind))
    rows = [sample(kind, n, spec, rng) for n in (B, B - 1, 1, 0, 17, 200)]
    payloads, err, _, _ = run(rows, spec, block=B)
    assert not err.any()
    for data, got in zip(rows, payloads):
        assert got == expected(data, spec), f"{len(data)} B"


@pytest.mark.parametrize("name", ["fixed_le", "fixed_be"])
def test_fixed_table_freezes_when_full(name):
    # > 4096 misses: the fixed flavor stops inserting and keeps coding.
    spec = SPECS[name]
    rng = np.random.default_rng(5)
    data = sample("random", 6000, spec, rng)
    assert len(oracle.encode_codes(data, spec)) > MAX_TABLE_SIZE
    (got,), err, _, _ = run([data], spec)
    assert got == expected(data, spec)


@pytest.mark.parametrize("name", ["gif8", "tiff", "gif2"])
def test_variable_reset_epochs(name):
    # A full 12-bit table forces CLEAR and a new epoch, several times over.
    spec = SPECS[name]
    rng = np.random.default_rng(6)
    n = 9000 if spec.code_size == 8 else 60000
    data = sample("random", n, spec, rng)
    clears = [c for c, _ in oracle.encode_codes(data, spec)
              if c == spec.clear_code]
    assert len(clears) >= 3
    (got,), err, _, _ = run([data], spec)
    assert not err.any()
    assert got == expected(data, spec)


def test_errors_are_per_block():
    spec = SPECS["gif7"]
    good = bytes(range(100))
    bad = bytes([1, 2, 3, 200, 4])
    first_unchecked = bytes([200, 1, 2])  # the first byte is never checked
    payloads, err, err_code, _ = run([good, bad, first_unchecked, good],
                                     spec, block=128)
    assert err.tolist() == [0, lax_encode.ERR_UNEXPECTED_CODE, 0, 0]
    assert int(err_code[1]) == 200
    assert payloads[0] == payloads[3] == expected(good, spec)
    assert payloads[2] == expected(first_unchecked, spec)


def test_eoi_width_fix():
    spec = LzwSpec.gif(2)
    rng = np.random.default_rng(0)
    quirky = []
    while len(quirky) < 3:
        data = rng.integers(0, 4, size=int(rng.integers(4, 40)))
        data = data.astype(np.uint8).tobytes()
        if oracle.eoi_width_quirk(oracle.encode_codes(data, spec), spec):
            quirky.append(data)
    fixed, _, _, _ = run(quirky, spec, block=64)
    plain, _, _, _ = run(quirky, spec, block=64, fix_eoi=False)
    for data, f, p in zip(quirky, fixed, plain):
        assert p == oracle.encode_bytes(data, spec)
        if native_available():
            assert f == get_runtime().encode(data, spec, fix_eoi=True)
        assert oracle.decode_bytes(f, spec) == data


@pytest.mark.parametrize("n_rows,lanes", [(1, 4), (5, 4), (9, 8), (3, 1)])
def test_batch_padding_and_shapes(n_rows, lanes):
    spec = SPECS["tiff"]
    rng = np.random.default_rng(n_rows)
    rows = [sample("random", int(rng.integers(0, 1000)), spec, rng)
            for _ in range(n_rows)]
    payloads, err, _, shape = run(rows, spec, block=1000, lanes=lanes)
    assert shape == (n_rows, lax_encode.packed_bound(1000, spec))
    assert not err.any()
    assert payloads == [expected(r, spec) for r in rows]


def test_golden_lorem_ipsum(lorem_ipsum, lorem_ipsum_encoded):
    (got,), err, _, _ = run([lorem_ipsum], SPECS["gif7"], fix_eoi=False)
    assert got == lorem_ipsum_encoded


def test_matches_lax_codec_on_image(tokyo_pixels):
    # The kernel and the portable lax codec agree on real data.
    spec = SPECS["gif7"]
    rows = [tokyo_pixels[i : i + 2048] for i in range(0, 8192, 2048)]
    payloads, _, _, _ = run(rows, spec)
    for data, got in zip(rows, payloads):
        block = jnp.asarray(np.frombuffer(data, np.uint8))
        res = lax_encode.encode_block(block, jnp.int32(len(data)), spec,
                                      fix_eoi_width=True)
        widths = np.asarray(res["widths"])
        codes = np.asarray(res["codes"])
        pairs = list(zip(codes[widths > 0].tolist(),
                         widths[widths > 0].tolist()))
        assert got == oracle.pack_codes(pairs, spec.endianness)
    assert alphabet(spec) == 128
