"""Memory profiles of one codec run — the dhat-harness analog.

The reference's `memory-profiling/` crate swaps in the dhat allocator and
prints heap deltas around a single codec run per binary
(`memory-profiling/tests/compress_text_salzweg.rs:1-27`).  Equivalents here:

* host heap deltas via ``tracemalloc`` around each backend run;
* device memory via ``jax.profiler``-backed per-device stats
  (`lzw_jax.utils.profiling.device_memory_report`).

Asserts nothing, like the reference — human-inspected evidence that the
decoder allocates almost nothing beyond its tables and that device buffers
are bounded by the static shapes.
"""

import pathlib
import sys
import tracemalloc

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from lzw_jax.spec import Endianness, LzwSpec

ASSETS = pathlib.Path(__file__).resolve().parent.parent / "test-assets"


def host_profile(label, fn):
    tracemalloc.start()
    before = tracemalloc.take_snapshot()
    fn()
    after = tracemalloc.take_snapshot()
    tracemalloc.stop()
    total = sum(s.size_diff for s in after.compare_to(before, "filename"))
    print(f"{label:40s}: host heap delta {total/1024:10.1f} KiB")


def main():
    data = (ASSETS / "lorem_ipsum.txt").read_bytes()
    spec = LzwSpec.gif(7)

    from lzw_jax.ops import reference as oracle

    enc = oracle.encode_bytes(data, spec)
    host_profile("oracle encode lorem_ipsum",
                 lambda: oracle.encode_bytes(data, spec))
    host_profile("oracle decode lorem_ipsum",
                 lambda: oracle.decode_bytes(enc, spec))

    try:
        from lzw_jax.native.runtime import get_runtime

        rt = get_runtime()
        host_profile("native encode lorem_ipsum",
                     lambda: rt.encode(data, spec))
        host_profile("native decode lorem_ipsum",
                     lambda: rt.decode(enc, spec))
    except Exception as e:
        print(f"native runtime unavailable: {e}")

    from lzw_jax.api import GifCodec
    from lzw_jax.utils.profiling import device_memory_report

    codec = GifCodec(7)
    codec.encode(data)  # compile outside the measured run
    host_profile("jax encode lorem_ipsum", lambda: codec.encode(data))
    host_profile("jax decode lorem_ipsum", lambda: codec.decode(enc))
    print("\ndevice memory after runs:")
    for dev, stats in device_memory_report().items():
        print(f"  {dev}: {stats}")


if __name__ == "__main__":
    main()
