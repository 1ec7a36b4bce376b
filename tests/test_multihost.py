"""Multi-host (DCN) codec tests.

Two tiers, mirroring `SURVEY.md` §2.4's "distributed communication backend"
component:

* single-process invariants (always run), and
* **real multi-process round-trips**: 2-3 CPU processes under
  ``jax.distributed`` exchanging payloads with ``process_allgather`` over
  localhost gRPC — the same code path a multi-host cluster's legs take.  Covers
  uneven block counts (idle processes), host-sharded encode, and container
  byte-identity across processes.
"""

import ast
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax

from lzw_jax.parallel.multihost import MultiHostBlockCodec, _process_slice
from lzw_jax.spec import Endianness, LzwSpec

WORKER = pathlib.Path(__file__).resolve().parent / "multihost_worker.py"


def test_process_slice_balance():
    for n_blocks in (0, 1, 7, 64, 65):
        for n_proc in (1, 2, 4):
            spans = [_process_slice(n_blocks, p, n_proc) for p in range(n_proc)]
            assert spans[0][0] == 0
            for (a, b), (c, d) in zip(spans, spans[1:]):
                assert b == c
            assert spans[-1][1] == n_blocks


def test_single_process_round_trip():
    assert jax.process_count() == 1
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=20000).astype(np.uint8).tobytes()
    codec = MultiHostBlockCodec(LzwSpec.fixed(Endianness.LITTLE),
                                block_size=4096)
    container = codec.encode(data)
    assert codec.decode(container) == data


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(n_procs: int, tmp_path: pathlib.Path) -> list[dict]:
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), f"127.0.0.1:{port}",
             str(n_procs), str(p), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(WORKER.parent.parent),
        )
        for p in range(n_procs)
    ]
    outputs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
    results = []
    for p in range(n_procs):
        f = tmp_path / f"proc{p}.out"
        assert f.exists(), f"worker {p} wrote no results"
        results.append(ast.literal_eval(f.read_text()))
    return results


@pytest.mark.slow
@pytest.mark.parametrize("n_procs", [2, 3])
def test_multi_process_round_trip(n_procs, tmp_path):
    """Real jax.distributed processes: encode/decode with uneven splits."""
    results = _run_workers(n_procs, tmp_path)
    for r in results:
        for key, val in r.items():
            if key.endswith(".ok"):
                assert val is True, f"{key} failed: {r}"
    # All processes assembled byte-identical containers.
    digests = {r["container.digest"] for r in results}
    assert len(digests) == 1
    # Container sizes agree across processes for every case.
    for key in results[0]:
        if key.endswith(".len"):
            assert len({r[key] for r in results}) == 1
