"""Container encode round-trip self-check (the ``verify=`` knob).

With two shape-triggered hardware miscompiles worked around in the device
pipeline (EVOLUTION.md), the container encoder can decode-check a sampled
block per batch on the host; a corrupted payload must raise
:class:`VerificationError` instead of shipping (`encoder.rs:715-737` is the
reference's always-asserted determinism posture).
"""

import numpy as np
import pytest

from lzw_jax.ops import reference as oracle
from lzw_jax.parallel.block import BlockParallelCodec

from lzw_jax.spec import LzwSpec, VerificationError


def _codec(**kw):
    return BlockParallelCodec(
        LzwSpec.gif(7), block_size=512, use_pallas=False, **kw
    )


def test_verify_clean_roundtrip():
    rng = np.random.default_rng(0)
    data = bytes(rng.integers(0, 128, 2048).astype(np.uint8))
    c = _codec(verify=True)
    assert c.verify
    out = c.encode(data)
    assert c.decode(out) == data


def test_verify_sample_rejects_bitflip():
    rng = np.random.default_rng(1)
    data = bytes(rng.integers(0, 128, 512).astype(np.uint8))
    c = _codec(verify=True)
    good = oracle.encode_bytes(data, c.spec)
    corrupted = bytearray(good)
    corrupted[len(good) // 2] ^= 0x40
    with pytest.raises(VerificationError):
        c._verify_sample(data, [bytes(corrupted)])


def test_verify_sample_rejects_wrong_content():
    rng = np.random.default_rng(2)
    data = bytes(rng.integers(0, 128, 512).astype(np.uint8))
    other = bytes(rng.integers(0, 128, 512).astype(np.uint8))
    c = _codec(verify=True)
    wrong = oracle.encode_bytes(other, c.spec)
    with pytest.raises(VerificationError) as ei:
        c._verify_sample(data, [wrong])
    assert ei.value.block_index == 0


def test_verify_catches_injected_corruption_end_to_end(monkeypatch):
    """Corrupt the payload stream between encode and framing: the batch
    self-check must catch it before the container is returned."""
    rng = np.random.default_rng(3)
    data = bytes(rng.integers(0, 128, 1536).astype(np.uint8))
    c = _codec(verify=True)

    # Inject the corruption just before the verify hook sees the batch —
    # the sampled (largest) payload is the one flipped.
    orig_verify = BlockParallelCodec._verify_sample

    def inject_then_verify(self, d, payloads):
        payloads = list(payloads)
        i = max(range(len(payloads)), key=lambda k: len(payloads[k]))
        mut = bytearray(payloads[i])
        mut[len(mut) // 2] ^= 0x11
        payloads[i] = bytes(mut)
        return orig_verify(self, d, payloads)

    monkeypatch.setattr(BlockParallelCodec, "_verify_sample", inject_then_verify)
    with pytest.raises(VerificationError):
        c.encode(data)


def test_verify_default_off_without_kernels():
    # On the CPU/virtual-mesh path the XLA scan codec is in play (already
    # differentially tested); verify defaults off there, on with kernels.
    c = _codec()
    assert c.verify is False
