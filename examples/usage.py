"""Round-trip the text corpus against the reference golden file.

Counterpart of the reference's `lzw/examples/usage.rs`: encode
`test-assets/lorem_ipsum.txt` with the GIF flavor at code size 7, check the
bytes equal `lorem_ipsum_encoded.bin`, decode, and compare.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from lzw_jax import GifCodec

ASSETS = pathlib.Path(__file__).resolve().parent.parent / "test-assets"


def main():
    data = (ASSETS / "lorem_ipsum.txt").read_bytes()
    golden = (ASSETS / "lorem_ipsum_encoded.bin").read_bytes()

    codec = GifCodec(code_size=7)
    compressed = codec.encode(data)
    assert compressed == golden, "wire bytes differ from the reference"
    print(f"compressed {len(data)} -> {len(compressed)} bytes "
          f"(ratio {len(compressed)/len(data):.3f}), matches golden file")

    decompressed = codec.decode(compressed)
    assert decompressed == data
    print("round-trip OK")


if __name__ == "__main__":
    main()
