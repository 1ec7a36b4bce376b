#!/usr/bin/env python3
"""Smoke test of the LZWT block container on the GPU.

Drives the container through its public entry points (``encode``,
``decode``, ``decode_range``) at 32 MiB per flavor, checks every result
byte for byte against the native runtime and the scalar oracle, times the
block kernels, compares them with the plain lax path on a 4 MiB prefix
(output and rate), and prints one JSON line last:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Usage:
    python chip_smoke.py               # one card: all phases
    python chip_smoke.py --four-cards  # only the four-card sharding phase

It exits non-zero, with no JSON line, when JAX finds no GPU or any phase
fails.  All JAX work runs in this one process; ``nvidia-smi`` runs in a
child that does not import JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ASSETS = pathlib.Path(__file__).resolve().parent / "test-assets"
MIB = 1 << 20
CORPUS_MIB = 32  # per flavor, as bench.py
FOUR_CARD_MIB = 128
REPS = 5
COMPARE_MIB = 4  # kernel-vs-lax comparison: a prefix of each flavor's data
COMPARE_REPS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """Name and power limit of the card, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def corpus(n_bytes: int, fold: int | None = None) -> bytes:
    """The committed corpora, concatenated and tiled to ``n_bytes``.

    ``fold`` maps every byte below ``2**fold`` (``b % 2**fold``), for the
    GIF flavors whose alphabet is smaller than a byte.
    """
    import numpy as np

    from lzw_jax.utils.corpus import load_tokyo_pixels

    base = np.frombuffer(
        load_tokyo_pixels(ASSETS / "tokyo_128_colors.png")
        + (ASSETS / "sunflower.bmp").read_bytes()
        + (ASSETS / "lorem_ipsum.txt").read_bytes(),
        np.uint8,
    )
    data = np.tile(base, -(-n_bytes // base.size))[:n_bytes]
    if fold is not None:
        data = data % (1 << fold)
    return data.tobytes()


def expect_raises(exc_type, fn, *args, code=None):
    try:
        fn(*args)
    except exc_type as e:
        if code is not None and e.code != code:
            raise AssertionError(f"{exc_type.__name__} code {e.code} != {code}")
        return
    raise AssertionError(f"expected {exc_type.__name__}")


def timed(fn, reps: int = REPS):
    """(median seconds, result) over ``reps`` calls; the calls return host
    bytes, so each one ends after the device work and the transfer."""
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def phase_golden() -> None:
    from lzw_jax import GifCodec, LzwSpec, TiffCodec
    from lzw_jax.spec import (
        CodeSizeError, TruncatedStreamError, UnexpectedCodeError,
    )

    text = (ASSETS / "lorem_ipsum.txt").read_bytes()
    golden = (ASSETS / "lorem_ipsum_encoded.bin").read_bytes()
    codec = GifCodec(7, backend="jax")
    assert codec.encode(text) == golden, "golden encode differs"
    assert codec.decode(golden) == text, "golden decode differs"
    expect_raises(CodeSizeError, LzwSpec.gif(9).validate)
    expect_raises(TruncatedStreamError, codec.decode, golden[:-40])
    corrupt = bytes.fromhex("1f403a00000044000044006054")
    expect_raises(UnexpectedCodeError, TiffCodec(backend="jax").decode,
                  corrupt, code=258)
    log("golden: encode/decode byte-exact, 3 error probes typed")


def corrupt_payload(spec) -> tuple[bytes, int]:
    """A stream whose second data code is past the next free code."""
    from lzw_jax.ops import reference as oracle
    from lzw_jax.spec import MAX_WIDTH

    bad = spec.first_free_code + 100
    if spec.variable:
        w = spec.initial_width
        codes = [(spec.clear_code, w), (1, w), (bad, w), (spec.end_code, w)]
    else:
        codes = [(1, MAX_WIDTH), (bad, MAX_WIDTH)]
    return oracle.pack_codes(codes, spec.endianness), bad


def phase_container(name, spec, block_size, data, rt, report) -> None:
    from lzw_jax.parallel import BlockParallelCodec, framing
    from lzw_jax.spec import UnexpectedCodeError
    from lzw_jax.utils.testdata import spliced_nonstrict_stream

    mib = len(data) / MIB
    n_blocks = -(-len(data) // block_size)
    codec = BlockParallelCodec(spec, block_size=block_size, verify=False)
    assert codec.use_pallas, "the GPU did not choose the block kernels"

    t0 = time.perf_counter()
    container = codec.encode(data)
    enc_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = codec.decode(container)
    dec_first = time.perf_counter() - t0
    assert out == data, f"{name}: round trip differs"
    header, payloads = framing.parse_frame(container)
    want = rt.encode_blocks(data, spec, block_size)
    assert len(payloads) == len(want) == n_blocks
    diff = [i for i, (a, b) in enumerate(zip(payloads, want)) if bytes(a) != b]
    assert not diff, f"{name}: {len(diff)} payloads differ from native, first {diff[:4]}"

    lo = n_blocks // 3
    hi = min(lo + 7, n_blocks)
    got = codec.decode_range(container, lo, hi)
    assert got == data[lo * block_size : hi * block_size], "decode_range"

    if spec.variable:  # foreign streams with early CLEARs
        k = min(8, len(data) // block_size)
        foreign = [
            spliced_nonstrict_stream(data[i * block_size : (i + 1) * block_size],
                                     spec, piece=1500)
            for i in range(k)
        ]
        sub = data[: k * block_size]
        assert codec.decode(framing.pack_frame(spec, block_size, len(sub),
                                               foreign)) == sub, "foreign"
    bad, bad_code = corrupt_payload(spec)
    broken = [bytes(p) for p in payloads]
    broken[n_blocks // 2] = bad
    expect_raises(UnexpectedCodeError, codec.decode,
                  framing.pack_frame(spec, block_size, header.orig_size,
                                     broken), code=bad_code)
    log(f"{name}: {n_blocks} blocks of {block_size} B, {mib:.0f} MiB, "
        f"ratio {len(container) / len(data):.4f}: round trip, native "
        f"payloads, decode_range, foreign and corrupt containers exact; "
        f"first call (compile) encode {enc_first:.2f}s decode {dec_first:.2f}s")

    enc_s, _ = timed(lambda: codec.encode(data))
    dec_s, _ = timed(lambda: codec.decode(container))
    row = {"cell": name, "mib": mib, "blocks": n_blocks,
           "encode_kernel_mib_s": mib / enc_s,
           "decode_kernel_mib_s": mib / dec_s,
           "first_call_s": {"encode": enc_first, "decode": dec_first}}
    log(f"{name}: kernel encode {row['encode_kernel_mib_s']:.1f} MiB/s, "
        f"decode {row['decode_kernel_mib_s']:.1f} MiB/s (median of {REPS}, "
        f"uncompressed bytes, host bytes to host bytes)")
    row["vs_lax"] = compare_with_lax(name, codec, data[: COMPARE_MIB * MIB])
    report.append(row)


def compare_with_lax(name, codec, data) -> dict:
    """Kernel and plain lax path through the container on the same data.

    The lax path takes tens of seconds per call on the GPU (each loop trip
    is its own launches), so this runs on a COMPARE_MIB prefix of the
    flavor's data, with COMPARE_REPS timed calls each after a warm-up.
    """
    from lzw_jax.parallel import BlockParallelCodec

    lax = BlockParallelCodec(codec.spec, block_size=codec.block_size,
                             use_pallas=False, verify=False)
    container = codec.encode(data)
    t0 = time.perf_counter()
    assert lax.encode(data) == container, f"{name}: lax container differs"
    assert lax.decode(container) == data, f"{name}: lax decode differs"
    lax_first = time.perf_counter() - t0
    mib = len(data) / MIB
    rates = {"mib": mib, "reps": COMPARE_REPS, "lax_first_call_s": lax_first}
    for op, fn, lax_fn in (
        ("encode", lambda: codec.encode(data), lambda: lax.encode(data)),
        ("decode", lambda: codec.decode(container),
         lambda: lax.decode(container)),
    ):
        rates[f"{op}_kernel_mib_s"] = mib / timed(fn, COMPARE_REPS)[0]
        rates[f"{op}_lax_mib_s"] = mib / timed(lax_fn, COMPARE_REPS)[0]
    log(f"{name}: on the first {mib:.0f} MiB, kernel vs lax: encode "
        f"{rates['encode_kernel_mib_s']:.1f} vs {rates['encode_lax_mib_s']:.1f}"
        f" MiB/s, decode {rates['decode_kernel_mib_s']:.1f} vs "
        f"{rates['decode_lax_mib_s']:.1f} MiB/s (median of {COMPARE_REPS})")
    return rates


def phase_four_cards(devices) -> None:
    import numpy as np
    from jax.sharding import Mesh

    from lzw_jax.parallel import BlockParallelCodec
    from lzw_jax.spec import Endianness, LzwSpec

    assert len(devices) >= 4, f"need 4 GPUs, found {len(devices)}"
    four = Mesh(np.array(devices[:4]), ("data",))
    one = Mesh(np.array(devices[:1]), ("data",))
    for name, spec, bs, fold in (
        ("fixed12_le_4k", LzwSpec.fixed(Endianness.LITTLE), 4096, None),
        ("gif7_64k", LzwSpec.gif(7), 65536, 7),
    ):
        data = corpus(FOUR_CARD_MIB * MIB, fold)
        codec4 = BlockParallelCodec(spec, block_size=bs, mesh=four,
                                    verify=False)
        assert codec4.use_pallas
        rows = codec4.shard_rows(np.zeros((4 * 8, 8), np.uint8))
        placed = {s.device for s in rows.addressable_shards}
        assert placed == set(devices[:4]), f"blocks placed on {placed}"
        container = codec4.encode(data)
        assert codec4.decode(container) == data, f"{name}: 4-card round trip"
        t0 = time.perf_counter()
        codec4.encode(data)
        enc4 = time.perf_counter() - t0
        t0 = time.perf_counter()
        codec4.decode(container)
        dec4 = time.perf_counter() - t0
        codec1 = BlockParallelCodec(spec, block_size=bs, mesh=one,
                                    verify=False)
        assert codec1.encode(data) == container, f"{name}: 4-card != 1-card"
        mib = len(data) / MIB
        log(f"{name}: {mib:.0f} MiB over 4 cards byte-identical to one card; "
            f"encode {mib / enc4:.1f} MiB/s, decode {mib / dec4:.1f} MiB/s "
            f"(one warm call each)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharding phase")
    args = ap.parse_args()

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 1
    log(f"device: {devices[0].device_kind} x{len(devices)}")
    log(f"card: {card_line()}")

    if args.four_cards:
        phase_four_cards(devices)
        count = 4
    else:
        from lzw_jax.native.runtime import get_runtime
        from lzw_jax.spec import Endianness, LzwSpec

        rt = get_runtime()
        phase_golden()
        report = []
        size = CORPUS_MIB * MIB
        for name, spec, bs, fold in (
            ("fixed12_le_4k", LzwSpec.fixed(Endianness.LITTLE), 4096, None),
            ("gif7_64k", LzwSpec.gif(7), 65536, 7),
            ("tiff_64k", LzwSpec.tiff(), 65536, None),
        ):
            phase_container(name, spec, bs, corpus(size, fold), rt, report)
        peak = devices[0].memory_stats().get("peak_bytes_in_use", 0)
        log(f"peak device memory: {peak / MIB:.0f} MiB")
        log("rates: " + json.dumps(report))
        count = 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
