"""Worker process for the real multi-host test (tests/test_multihost.py).

Launched N times by the test with ``jax.distributed.initialize`` over
localhost CPU processes — the CI-runnable stand-in for the host-to-host
legs of a multi-host cluster.  Each process round-trips containers
through :class:`MultiHostBlockCodec` and writes its results to a
per-process file the parent asserts on.

Usage: python multihost_worker.py <coordinator> <num_procs> <proc_id> <outdir>
"""

import os
import pathlib
import sys
import traceback

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main() -> int:
    coordinator, num_procs, proc_id, outdir = sys.argv[1:5]
    num_procs = int(num_procs)
    proc_id = int(proc_id)
    out = pathlib.Path(outdir) / f"proc{proc_id}.out"

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

    import jax

    # Force the CPU like tests/conftest.py, even where an accelerator exists.
    jax.config.update("jax_platforms", "cpu")

    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_procs,
        process_id=proc_id,
    )
    assert jax.process_count() == num_procs

    import numpy as np

    from lzw_jax.parallel.multihost import MultiHostBlockCodec, _process_slice
    from lzw_jax.spec import Endianness, LzwSpec

    results = {}

    rng = np.random.default_rng(7)
    base = rng.integers(0, 128, size=3 * 4096 + 1000).astype(np.uint8)
    # Uneven block counts: 4 blocks over 3 procs -> (2, 2, 0) split at P=3;
    # also a tiny 1-block input so most processes are idle.
    cases = {
        "uneven": base.tobytes(),               # 4 blocks of 4096
        "tiny": base[:100].tobytes(),           # 1 block
        "empty": b"",
        "exact": base[: 2 * 4096].tobytes(),    # 2 full blocks
    }

    for flavor, spec in (
        ("fixed", LzwSpec.fixed(Endianness.LITTLE)),
        ("gif", LzwSpec.gif(7)),
    ):
        codec = MultiHostBlockCodec(spec, block_size=4096)
        for name, data in cases.items():
            container = codec.encode(data)
            round_tripped = codec.decode(container)
            results[f"{flavor}.{name}.ok"] = round_tripped == data
            results[f"{flavor}.{name}.len"] = len(container)

    # Host-sharded encode: each process only holds its own byte range.
    spec = LzwSpec.fixed(Endianness.LITTLE)
    codec = MultiHostBlockCodec(spec, block_size=4096)
    data = cases["uneven"]
    n_blocks = (len(data) + 4095) // 4096
    lo, hi = _process_slice(n_blocks, proc_id, num_procs)
    shard = data[lo * 4096 : hi * 4096]
    container = codec.encode_shards(shard, len(data))
    results["shards.ok"] = codec.decode(container) == data
    # Every process must assemble the identical container bytes.
    results["container.digest"] = __import__("hashlib").sha256(
        container
    ).hexdigest()

    out.write_text(repr(results))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
