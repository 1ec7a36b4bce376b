"""The GPU decode kernel, run in the Pallas interpreter, against the oracle.

For well-formed streams the kernel must return the oracle's bytes; for
corrupt ones the oracle's typed error and offending code.  Foreign streams
with early CLEARs, table-full epochs, stale tables after a CLEAR and the
output bound are covered explicitly.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from kernel_cases import (
    SPECS, corruptions, kernel_outcome, matrix, oracle_outcome, sample,
)
from lzw_jax.kernels import schedule as sched_mod
from lzw_jax.kernels.decode_triton import decode_blocks
from lzw_jax.ops import reference as oracle
from lzw_jax.spec import LzwSpec, MAX_TABLE_SIZE, MAX_WIDTH
from lzw_jax.utils.testdata import spliced_nonstrict_stream

BOUND = 1 << 15


def run(streams, spec, bound=BOUND, lanes=4, width=None):
    mat, lens = matrix(streams, width)
    res = decode_blocks(jnp.asarray(mat), jnp.asarray(lens), spec,
                        out_bound=bound, lanes=lanes, interpret=True)
    out, total, err, err_code = (np.asarray(x) for x in res)
    return [kernel_outcome(out[i], total[i], err[i], err_code[i], bound)
            for i in range(len(streams))], out.shape


def assert_like_oracle(streams, spec, **kw):
    got, _ = run(streams, spec, **kw)
    for i, s in enumerate(streams):
        assert got[i] == oracle_outcome(s, spec), f"stream {i} ({len(s)} B)"


@pytest.mark.parametrize("kind", ["random", "runs", "kwkwk", "periodic"])
@pytest.mark.parametrize("name", list(SPECS))
def test_round_trips_match_oracle(name, kind):
    spec = SPECS[name]
    rng = np.random.default_rng(len(name) * 7 + len(kind))
    streams = [oracle.encode_bytes(sample(kind, n, spec, rng), spec)
               for n in (400, 399, 1, 0, 33)]
    assert_like_oracle(streams, spec, width=704)


@pytest.mark.parametrize("name", ["gif3", "gif7", "tiff", "fixed_le",
                                  "fixed_be"])
def test_corrupt_streams_match_oracle(name):
    spec = SPECS[name]
    rng = np.random.default_rng(0xE44 + len(name))
    streams = []
    for _ in range(4):
        data = sample("random", int(rng.integers(20, 300)), spec, rng)
        streams += corruptions(oracle.encode_bytes(data, spec), rng)
    assert_like_oracle(streams, spec)


@pytest.mark.parametrize("name", ["gif7", "tiff", "gif2", "var6_be_tiff"])
def test_early_clear_streams(name):
    # Foreign encoders may CLEAR before the table is full
    # (`decoder.rs:222-227`): the kernel handles CLEAR inline.
    spec = SPECS[name]
    rng = np.random.default_rng(1)
    srcs = [sample("random", n, spec, rng) for n in (2500, 4600, 900)]
    streams = [spliced_nonstrict_stream(s, spec, piece=700 + 150 * i)
               for i, s in enumerate(srcs)]
    streams.append(oracle.encode_bytes(srcs[0], spec))  # strict beside
    got, _ = run(streams, spec)
    for g, s in zip(got, srcs + srcs[:1]):
        assert g == ("ok", s)


def test_early_clear_truncated_raises():
    spec = SPECS["gif7"]
    rng = np.random.default_rng(3)
    stream = spliced_nonstrict_stream(sample("random", 3000, spec, rng),
                                      spec, piece=1000)
    got, _ = run([stream[: len(stream) // 2]], spec)
    assert got == [("truncated", None)]


@pytest.mark.parametrize("name", ["gif8", "tiff", "fixed_le"])
def test_multi_epoch_streams(name):
    # Several table-full epochs (variable) or a frozen table (fixed).
    spec = SPECS[name]
    rng = np.random.default_rng(7)
    data = sample("random", 1 << 14, spec, rng)
    got, _ = run([oracle.encode_bytes(data, spec)], spec)
    assert got == [("ok", data)]


def _strict_prefix(spec, n_data: int, tail=()):
    """A stream of exactly ``n_data`` data codes from an oracle encode,
    with ``tail`` (code, width) symbols appended."""
    rng = np.random.default_rng(42)
    src = sample("random", 4 * n_data + 4096, spec, rng)
    cw = oracle.encode_codes(src, spec)
    body = [(c, w) for c, w in cw if c not in (spec.clear_code, spec.end_code)]
    head = [cw[0]] + body[:n_data]
    return oracle.pack_codes(head + list(tail), spec.endianness)


def _full_epoch(spec) -> int:
    """Data codes in one table-full epoch."""
    return MAX_TABLE_SIZE - spec.first_free_code + 1


def test_eoi_on_last_slot_of_full_epoch():
    spec = SPECS["gif7"]
    n = _full_epoch(spec) - 1
    w_eoi = sched_mod.emission_schedule(spec, n + 3).eoi_width(n, True)
    stream = _strict_prefix(spec, n, [(spec.end_code, w_eoi)])
    assert_like_oracle([stream], spec)


def test_eoi_in_table_full_gap():
    spec = SPECS["gif7"]
    n = _full_epoch(spec)
    stream = _strict_prefix(spec, n, [(spec.end_code, MAX_WIDTH)])
    assert_like_oracle([stream], spec)


def test_missing_clear_raises():
    # A data code where the table-full CLEAR must sit (`decoder.rs:281-283`).
    spec = SPECS["gif7"]
    n = _full_epoch(spec)
    stream = _strict_prefix(spec, n, [(300, MAX_WIDTH),
                                      (spec.end_code, MAX_WIDTH)])
    got, _ = run([stream], spec)
    assert got == [("missing_clear", None)] == [oracle_outcome(stream, spec)]


@pytest.mark.parametrize("first", [5, 300, 3000])
def test_stale_first_code_after_clear(first):
    # The table survives CLEAR: a first code past the roots reads stale
    # entries, as the oracle does (`decoder.rs:230-236`).
    spec = SPECS["gif8"]
    w = spec.initial_width
    body = oracle.encode_codes(bytes(range(200)) * 3, spec)[:-1]
    codes = body + [(spec.clear_code, body[-1][1]), (first & 0x1FF, w),
                    (7, w), (spec.first_free_code, w),
                    (spec.first_free_code + 1, w), (spec.end_code, w)]
    stream = oracle.pack_codes(codes, spec.endianness)
    assert_like_oracle([stream], spec)


def test_unexpected_code_reports_the_code():
    spec = SPECS["tiff"]
    stream = bytes.fromhex("1f403a00000044000044006054")
    got, _ = run([stream], spec)
    assert got == [("unexpected", 258)]


def test_output_past_bound_is_reported():
    spec = SPECS["fixed_le"]
    data = bytes(300)
    got, _ = run([oracle.encode_bytes(data, spec)], spec, bound=128)
    assert got == [("overflow", 300)]


@pytest.mark.parametrize("n_rows,lanes", [(1, 4), (6, 4), (3, 1), (17, 16)])
def test_batch_padding_and_shapes(n_rows, lanes):
    spec = SPECS["gif7"]
    rng = np.random.default_rng(n_rows)
    srcs = [sample("random", int(rng.integers(0, 500)), spec, rng)
            for _ in range(n_rows)]
    streams = [oracle.encode_bytes(s, spec) for s in srcs]
    got, shape = run(streams, spec, bound=512, lanes=lanes)
    assert shape == (n_rows, 512)
    assert got == [("ok", s) for s in srcs]


def test_empty_payload_rows():
    # Padding rows (no bytes): fixed ends cleanly, variable is truncated.
    got, _ = run([b"", b""], SPECS["fixed_be"])
    assert got == [("ok", b""), ("ok", b"")]
    got, _ = run([b""], LzwSpec.gif(4))
    assert got == [("truncated", None)]
