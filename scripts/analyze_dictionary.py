"""Dictionary-shape statistics on the benchmark corpora.

The analog of the reference's instrumented trie (`exploration/src/tree.rs`),
which histogrammed children-per-node to justify its 3-state Node enum.  The
block design cares about different shape questions: miss rate (how many scan
rows the compacted table would hold), child counts (how selective a
parent-key match is), and phrase lengths (decode pass-2 round counts).
"""

import collections
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from lzw_jax.ops import reference as oracle
from lzw_jax.spec import Endianness, LzwSpec
from lzw_jax.utils.corpus import load_corpus

ASSETS = pathlib.Path(__file__).resolve().parent.parent / "test-assets"


def analyze(data: bytes, spec: LzwSpec, label: str):
    table = {}
    children = collections.Counter()  # prefix -> child count
    n_miss = 0
    n_steps = 0
    lengths = []  # phrase byte lengths
    prefix = data[0]
    plen = 1
    next_index = spec.first_free_code
    for k in data[1:]:
        n_steps += 1
        child = table.get((prefix, k))
        if child is not None:
            prefix = child
            plen += 1
            continue
        n_miss += 1
        lengths.append(plen)
        if spec.variable or next_index < 4096:
            table[(prefix, k)] = next_index
            children[prefix] += 1
            next_index += 1
            if spec.variable and next_index == 4096 - spec.strategy.increment:
                table.clear()
                children.clear()
                next_index = spec.first_free_code
        prefix = k
        plen = 1
    child_hist = collections.Counter(children.values())
    n_parents = len(children) or 1
    avg_len = sum(lengths) / max(len(lengths), 1)
    print(f"{label}:")
    print(f"  steps {n_steps}, miss rate {n_miss/n_steps:.2f}, "
          f"avg phrase {avg_len:.2f} B, max phrase {max(lengths or [0])}")
    top = {c: n for c, n in sorted(child_hist.items())[:5]}
    print(f"  children-per-parent histogram (top): {top} "
          f"(parents with 1 child: {child_hist.get(1, 0)/n_parents:.0%})")


def main():
    corpus = load_corpus(ASSETS)
    for name, data in corpus.items():
        analyze(data, LzwSpec.gif(7), f"{name} / gif cs=7")
        analyze(data, LzwSpec.fixed(Endianness.LITTLE), f"{name} / fixed-12")


if __name__ == "__main__":
    main()
