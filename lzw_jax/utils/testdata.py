"""Synthesized foreign-stream test vectors shared by tests and benches."""

from __future__ import annotations


def spliced_nonstrict_stream(data: bytes, spec, piece: int = 2000) -> bytes:
    """A valid variable-flavor stream with EARLY CLEARs (every ``piece``
    bytes), the foreign-stream shape the reference decoder handles natively
    (`decoder.rs:222-227`) but the strict-schedule device decoder rejects.

    Notably, Pillow's own GIF encoder turns out to emit CLEAR exactly at
    table-full — its streams ARE strict and take the device path — so the
    non-strict suites need a synthesized early-CLEAR stream.
    """
    from lzw_jax.kernels import schedule as sched_mod
    from lzw_jax.ops import reference as oracle

    assert piece < 3000  # keeps each piece free of its own table-full CLEAR
    chunks = [data[i : i + piece] for i in range(0, len(data), piece)]
    spliced: list[tuple[int, int]] = []
    clear_w = None  # decoder read width for the next (early) CLEAR
    for ch in chunks:
        cw = oracle.encode_codes(ch, spec)  # [CLEAR@init, ..., EOI@w_enc]
        body = cw[:-1]
        assert all(c != spec.clear_code for c, _ in body[1:])
        if clear_w is not None:
            body[0] = (spec.clear_code, clear_w)
        spliced += body
        n_data = len(cw) - 2
        sched = sched_mod.emission_schedule(spec, n_data + 1)
        clear_w = sched.eoi_width(n_data, True)  # decoder width here
    spliced.append((spec.end_code, clear_w))
    return oracle.pack_codes(spliced, spec.endianness)
