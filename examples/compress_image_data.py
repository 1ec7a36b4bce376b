"""Compress indexed-image pixel data.

Counterpart of the reference's `lzw/examples/compress_image_data.rs`: decode
the palette indices of `tokyo_128_colors.png` (values 0..128) and compress
them with the GIF flavor at code size 7 — and additionally run the
block-parallel container codec over the device mesh, which the single-
threaded reference has no analog for.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from lzw_jax import GifCodec
from lzw_jax.parallel import BlockParallelCodec
from lzw_jax.spec import LzwSpec
from lzw_jax.utils.corpus import load_tokyo_pixels

ASSETS = pathlib.Path(__file__).resolve().parent.parent / "test-assets"


def main():
    pixels = load_tokyo_pixels(ASSETS / "tokyo_128_colors.png")
    print(f"indexed pixels: {len(pixels)} bytes")

    # Raw single-stream (reference-compatible wire bytes).
    codec = GifCodec(code_size=7)
    compressed = codec.encode(pixels)
    print(f"single stream: {len(compressed)} bytes "
          f"(ratio {len(compressed)/len(pixels):.3f})")

    # Block-parallel container across all local devices.
    pcodec = BlockParallelCodec(LzwSpec.gif(7))
    container = pcodec.encode(pixels)
    assert pcodec.decode(container) == pixels
    print(f"container ({pcodec.mesh.devices.size} device(s), "
          f"{pcodec.block_size}B blocks): {len(container)} bytes "
          f"(ratio {len(container)/len(pixels):.3f})")


if __name__ == "__main__":
    main()
