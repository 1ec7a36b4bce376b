"""Run metrics and profiling helpers.

The reference's observability is offline-only: criterion wall-clock reports
and dhat heap profiles (`SURVEY.md` §5).  This module provides the
equivalents: a per-run metrics record (bytes, ratio, throughput, block
counts), `jax.profiler` trace capture for kernel-level inspection, and device
memory reports as the dhat analog.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time

__all__ = ["RunMetrics", "Timer", "trace", "device_memory_report"]


@dataclasses.dataclass
class RunMetrics:
    """Lightweight metrics for one codec run."""

    operation: str  # "encode" | "decode"
    flavor: str
    bytes_in: int
    bytes_out: int
    seconds: float
    n_blocks: int = 1
    n_devices: int = 1

    @property
    def ratio(self) -> float:
        if self.operation == "encode":
            return self.bytes_out / max(self.bytes_in, 1)
        return self.bytes_in / max(self.bytes_out, 1)

    @property
    def throughput_bps(self) -> float:
        """Uncompressed bytes/s (the reference's definition, README.md:16-19)."""
        plain = self.bytes_in if self.operation == "encode" else self.bytes_out
        return plain / max(self.seconds, 1e-12)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["ratio"] = round(self.ratio, 4)
        d["throughput_MiB_s"] = round(self.throughput_bps / 2**20, 2)
        return json.dumps(d)


class Timer:
    """Wall-clock context manager: ``with Timer() as t: ...; t.seconds``."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace (Perfetto/XPlane) around a region."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_memory_report() -> dict:
    """Per-device live memory statistics (the dhat heap-stats analog)."""
    import jax

    report = {}
    for d in jax.devices():
        try:
            stats = d.memory_stats() or {}
        except Exception:
            stats = {}
        report[str(d)] = {
            "bytes_in_use": stats.get("bytes_in_use"),
            "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
            "bytes_limit": stats.get("bytes_limit"),
        }
    return report
