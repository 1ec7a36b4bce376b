"""The block kernels compiled for the card (skipped without a GPU).

Run on a GPU host with ``LZW_JAX_TEST_GPU=1 python -m pytest tests/ -m gpu``.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from lzw_jax.kernels.decode_triton import decode_blocks
from lzw_jax.kernels.encode_triton import encode_blocks
from lzw_jax.native.runtime import get_runtime
from lzw_jax.parallel import BlockParallelCodec
from lzw_jax.spec import Endianness, LzwSpec

FLAVORS = [LzwSpec.gif(7), LzwSpec.tiff(), LzwSpec.fixed(Endianness.LITTLE)]
IDS = ["gif7", "tiff", "fixed_le"]


@pytest.mark.gpu
@pytest.mark.parametrize("spec", FLAVORS, ids=IDS)
def test_compiled_kernels_match_native(gpu, spec, tokyo_pixels):
    bs = 4096
    data = np.frombuffer(tokyo_pixels[: 64 * bs], np.uint8)
    data = data % (1 << spec.code_size)
    blocks = data.reshape(64, bs)
    lens = np.full(64, bs, np.int32)
    lens[5] = 100  # a short block among full ones
    out, n_bytes, err, _ = encode_blocks(jnp.asarray(blocks),
                                         jnp.asarray(lens), spec)
    out, n_bytes = np.asarray(out), np.asarray(n_bytes)
    assert not np.asarray(err).any()
    rt = get_runtime()
    for i in range(64):
        want = rt.encode(blocks[i, : lens[i]].tobytes(), spec, fix_eoi=True)
        assert out[i, : n_bytes[i]].tobytes() == want, f"block {i}"
    plain, total, err, _ = decode_blocks(jnp.asarray(out), jnp.asarray(n_bytes),
                                         spec, out_bound=bs)
    plain, total = np.asarray(plain), np.asarray(total)
    assert not np.asarray(err).any()
    for i in range(64):
        assert plain[i, : total[i]].tobytes() == blocks[i, : lens[i]].tobytes()


@pytest.mark.gpu
def test_container_takes_the_kernels(gpu, lorem_ipsum):
    codec = BlockParallelCodec(LzwSpec.gif(7), block_size=4096)
    assert codec.use_pallas and codec.verify
    assert codec.decode(codec.encode(lorem_ipsum)) == lorem_ipsum
