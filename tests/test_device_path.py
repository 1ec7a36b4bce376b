"""The choice of device path, and the GPU-only entry points on the CPU."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from lzw_jax.parallel import BlockParallelCodec
from lzw_jax.parallel.block import KERNEL, LAX, device_path
from lzw_jax.spec import Endianness, LzwSpec

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_gpu_takes_the_kernels():
    assert device_path("gpu") == KERNEL


@pytest.mark.parametrize("platform", ["cpu", "rocm", "METAL", ""])
def test_other_platforms_take_the_lax_codec(platform):
    assert device_path(platform) == LAX


def test_cpu_codec_defaults_to_lax():
    codec = BlockParallelCodec(LzwSpec.gif(7), block_size=512)
    assert not codec.use_pallas
    assert not codec.verify


def test_kernels_on_cpu_need_interpret():
    with pytest.raises(ValueError, match="interpret=True"):
        BlockParallelCodec(LzwSpec.tiff(), block_size=512, use_pallas=True)
    codec = BlockParallelCodec(LzwSpec.tiff(), block_size=512,
                               use_pallas=True, interpret=True)
    assert codec.use_pallas and codec.verify


def test_lax_path_can_be_forced():
    codec = BlockParallelCodec(LzwSpec.fixed(Endianness.BIG), block_size=256,
                               use_pallas=False, verify=True)
    data = np.arange(1000, dtype=np.uint8).tobytes()
    assert codec.decode(codec.encode(data)) == data


def _run(script: pathlib.Path, *args, cwd=ROOT):
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONDONTWRITEBYTECODE": "1"}
    return subprocess.run([sys.executable, str(script), *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _printed_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and ("ok" in obj or "metric" in obj):
            return True
    return False


@pytest.mark.parametrize("script,args", [
    ("chip_smoke.py", ()),
    ("chip_smoke.py", ("--four-cards",)),
    ("bench.py", ()),
])
def test_gpu_entry_points_fail_without_gpu(script, args):
    res = _run(ROOT / script, *args)
    assert res.returncode != 0
    assert not _printed_result(res.stdout)
    assert "no GPU" in res.stderr


def test_chip_smoke_fails_alone(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    res = _run(lone, cwd=tmp_path)
    assert res.returncode != 0
    assert not _printed_result(res.stdout)
