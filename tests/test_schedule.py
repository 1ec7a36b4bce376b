"""Static-schedule pack/unpack vs the scalar oracle."""

import numpy as np
import pytest

from lzw_jax.kernels import schedule
from lzw_jax.ops import reference as oracle
from lzw_jax.spec import CodeSizeStrategy, Endianness, LzwSpec

SPECS = [
    LzwSpec.gif(2), LzwSpec.gif(7), LzwSpec.tiff(),
    LzwSpec.variable(4, Endianness.BIG, CodeSizeStrategy.TIFF),
    LzwSpec.variable(8, Endianness.LITTLE),
]
IDS = ["gif2", "gif7", "tiff", "var4", "var8"]


def oracle_data_codes(data, spec):
    """Data codes (no CLEAR/EOI) from the oracle's emission list."""
    cw = oracle.encode_codes(data, spec)
    return [c for c, w in cw if not (
        c in (spec.clear_code, spec.end_code)
        and _is_control(cw, c, spec)
    )]


def _is_control(cw, c, spec):
    return True  # placeholder; filtering below uses positions instead


def split_controls(cw, spec):
    """Separate the oracle emission list into data codes, asserting the
    control codes sit exactly where the static schedule expects them."""
    sched = None
    data = []
    i = 0
    assert cw[0][0] == spec.clear_code  # leading CLEAR
    rest = cw[1:-1]
    eoi = cw[-1]
    assert eoi[0] == spec.end_code
    n_guess = sum(1 for c, w in rest if True)
    sched = schedule.emission_schedule(spec, max(n_guess, 4))
    m = 0
    for c, w in rest:
        if m > 0 and sched.clear_after[m - 1] and c == spec.clear_code \
                and w == 12:
            continue  # scheduled mid-stream CLEAR
        assert w == sched.widths[m], (m, w, sched.widths[m])
        data.append(c)
        m += 1
    return data


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
@pytest.mark.parametrize("n", [0, 1, 7, 300, 5000])
def test_pack_matches_oracle(spec, n):
    rng = np.random.default_rng(n + 17)
    data = rng.integers(0, 1 << spec.code_size, size=n).astype(
        np.uint8
    ).tobytes()
    codes = split_controls(oracle.encode_codes(data, spec), spec) if n else []
    S = max(len(codes) + 2, 8)
    dense = np.zeros((1, S), np.int32)
    dense[0, : len(codes)] = codes
    counts = np.array([len(codes)], np.int32)
    packed, lengths = schedule.pack_variable(dense, counts, spec,
                                             fix_eoi=False)
    expect = oracle.encode_bytes(data, spec)
    assert packed[0, : lengths[0]].tobytes() == expect


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_unpack_round_trip(spec):
    rng = np.random.default_rng(3)
    datas = [
        rng.integers(0, 1 << spec.code_size, size=k).astype(np.uint8).tobytes()
        for k in (0, 1, 40, 900, 6000)
    ]
    code_lists = [
        split_controls(oracle.encode_codes(d, spec), spec) if d else []
        for d in datas
    ]
    payload_list = [oracle.encode_bytes(d, spec) for d in datas]
    pb = ((max(len(p) for p in payload_list) + 3) // 4) * 4
    payloads = np.zeros((len(datas), pb), np.uint8)
    plens = np.zeros(len(datas), np.int64)
    for i, p in enumerate(payload_list):
        payloads[i, : len(p)] = np.frombuffer(p, np.uint8)
        plens[i] = len(p)
    dense, counts, strict = schedule.unpack_variable(payloads, plens, spec)
    for i, codes in enumerate(code_lists):
        if oracle.eoi_width_quirk(oracle.encode_codes(datas[i], spec), spec):
            continue  # reference stream not self-consistent; skip
        assert strict[i], f"stream {i} flagged non-strict"
        assert counts[i] == len(codes)
        assert list(dense[i, : counts[i]]) == codes


def test_nonstrict_detected():
    # A GIF stream with an early CLEAR (legal wire format, not schedule-
    # strict): CLEAR, 0, CLEAR, 0, EOI at cs=2.
    spec = LzwSpec.gif(2)
    cw = [(4, 3), (0, 3), (4, 3), (0, 3), (5, 3)]
    enc = oracle.pack_codes(cw, spec.endianness)
    payloads = np.zeros((1, 8), np.uint8)
    payloads[0, : len(enc)] = np.frombuffer(enc, np.uint8)
    _, _, strict = schedule.unpack_variable(
        payloads, np.array([len(enc)], np.int64), spec
    )
    assert not strict[0]


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_device_pack_matches_host(spec):
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    code_lists = []
    for k in (0, 1, 40, 900, 5000):
        data = rng.integers(0, 1 << spec.code_size, size=k).astype(
            np.uint8
        ).tobytes()
        code_lists.append(
            split_controls(oracle.encode_codes(data, spec), spec) if k else []
        )
    S = max(max(len(c) for c in code_lists) + 2, 8)
    dense = np.zeros((len(code_lists), S), np.int32)
    counts = np.zeros(len(code_lists), np.int32)
    for i, codes in enumerate(code_lists):
        dense[i, : len(codes)] = codes
        counts[i] = len(codes)
    host_p, host_l = schedule.pack_variable(dense, counts, spec, fix_eoi=True)
    dev_p, dev_l = schedule.pack_variable_device(
        jnp.asarray(dense), jnp.asarray(counts), spec, fix_eoi=True
    )
    dev_p = np.asarray(dev_p)
    dev_l = np.asarray(dev_l)
    assert (host_l == dev_l).all()
    for i in range(len(code_lists)):
        assert dev_p[i, : dev_l[i]].tobytes() == \
            host_p[i, : host_l[i]].tobytes(), f"stream {i}"


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_device_unpack_matches_host(spec):
    import jax.numpy as jnp

    rng = np.random.default_rng(13)
    datas = [
        rng.integers(0, 1 << spec.code_size, size=k).astype(np.uint8).tobytes()
        for k in (0, 1, 40, 900, 6000)
    ]
    payload_list = [oracle.encode_bytes(d, spec) for d in datas]
    pb = ((max(len(p) for p in payload_list) + 3) // 4) * 4
    payloads = np.zeros((len(datas), pb), np.uint8)
    plens = np.zeros(len(datas), np.int64)
    for i, p in enumerate(payload_list):
        payloads[i, : len(p)] = np.frombuffer(p, np.uint8)
        plens[i] = len(p)
    h_dense, h_counts, h_strict = schedule.unpack_variable(
        payloads, plens, spec
    )
    counts, strict, S = schedule.recover_counts(payloads, plens, spec)
    d_dense, d_ok = schedule.unpack_variable_device(
        jnp.asarray(payloads), jnp.asarray(counts.astype(np.int32)), spec, S
    )
    d_dense = np.asarray(d_dense)
    assert ((strict & np.asarray(d_ok)) == h_strict).all()
    assert (counts == h_counts).all()
    assert (d_dense == h_dense).all()
