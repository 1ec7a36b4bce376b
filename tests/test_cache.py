"""Where the persistent compilation cache goes."""

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PROBE = """
import jax, lzw_jax
from lzw_jax.utils import cache
print(jax.config.jax_compilation_cache_dir)
print(cache.DEFAULT_DIR)
jax.jit(lambda x: x * 3 + 1)(jax.numpy.arange(7)).block_until_ready()
"""


def _cache_dir(extra_env: dict) -> tuple[str, str]:
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0", **extra_env)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split("\n")
    return out[0], out[1]


def test_env_var_is_used_and_no_other_dir(tmp_path):
    want = tmp_path / "xla-cache"
    used, default = _cache_dir({"JAX_COMPILATION_CACHE_DIR": str(want)})
    assert used == str(want)
    assert default != used
    assert any(want.iterdir()), "nothing was cached in the chosen directory"


def test_fixed_in_checkout_dir_without_env_var():
    used, default = _cache_dir({})
    assert used == default == str(ROOT / ".jax_cache")
