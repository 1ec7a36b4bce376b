"""Benchmark entry point: prints ONE JSON line.

Headline metric (BASELINE.json): fixed-12-bit LZW encode throughput on the
image corpus through the block container on one GPU, in uncompressed
bytes/s (the reference's definition, `README.md:16-19`).  Every rate is end
to end through ``BlockParallelCodec`` on its chosen device path: host bytes
in, container (or plain bytes) out, transfers included, median of 5 warm
calls.  Each result is checked byte for byte (round trip, and payloads
against the native runtime).

Earlier lines name the device and the card's power limit.  Without a GPU the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ASSETS = pathlib.Path(__file__).resolve().parent / "test-assets"
BASELINE_FIXED12_ENCODE = 120 * (1 << 20)  # bytes/s, reference README.md:27
BASELINE_FIXED12_DECODE = 210 * (1 << 20)  # bytes/s, reference README.md:28
BASELINE_VAR_ENCODE = 70 * (1 << 20)       # bytes/s, reference README.md:27
BASELINE_VAR_DECODE = 200 * (1 << 20)      # bytes/s, reference README.md:28
CORPUS_MB = 32
REPS = 5


def _corpus(target_bytes: int) -> bytes:
    from lzw_jax.utils.corpus import load_tokyo_pixels

    base = load_tokyo_pixels(ASSETS / "tokyo_128_colors.png")
    reps = max(1, target_bytes // len(base) + 1)
    return (base * reps)[:target_bytes]


def _median_s(fn) -> float:
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _rates(spec, block_size: int, data: bytes) -> tuple[float, float]:
    """(encode, decode) bytes/s of the container, checked byte for byte."""
    from lzw_jax.native.runtime import get_runtime
    from lzw_jax.parallel import BlockParallelCodec, framing

    codec = BlockParallelCodec(spec, block_size=block_size, verify=False)
    container = codec.encode(data)  # compiles
    assert codec.decode(container) == data, "round trip differs"
    _, payloads = framing.parse_frame(container)
    want = get_runtime().encode_blocks(data, spec, block_size)
    assert [bytes(p) for p in payloads] == want, "payloads differ from native"
    enc = _median_s(lambda: codec.encode(data))
    dec = _median_s(lambda: codec.decode(container))
    return len(data) / enc, len(data) / dec


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX platform {dev.platform!r})", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"# device: {dev.device_kind} x{len(jax.devices())}; card: {card}",
          flush=True)

    from lzw_jax.spec import Endianness, LzwSpec

    data = _corpus(CORPUS_MB << 20)
    enc, dec = _rates(LzwSpec.fixed(Endianness.LITTLE), 1 << 12, data)
    folded = (np.frombuffer(data, np.uint8) % 128).astype(np.uint8).tobytes()
    venc, vdec = _rates(LzwSpec.gif(7), 1 << 16, folded)
    result = {
        "metric": "fixed12_encode_bytes_per_s_1chip",
        "value": round(enc, 1),
        "unit": "bytes/s",
        "vs_baseline": round(enc / BASELINE_FIXED12_ENCODE, 4),
        "extra": {
            "device_kind": dev.device_kind,
            "fixed12_decode_bytes_per_s_1chip": round(dec, 1),
            "fixed12_decode_vs_baseline": round(dec / BASELINE_FIXED12_DECODE, 4),
            "var64k_encode_bytes_per_s_1chip": round(venc, 1),
            "var64k_encode_vs_baseline": round(venc / BASELINE_VAR_ENCODE, 4),
            "var64k_decode_bytes_per_s_1chip": round(vdec, 1),
            "var64k_decode_vs_baseline": round(vdec / BASELINE_VAR_DECODE, 4),
        },
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
