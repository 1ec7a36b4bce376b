"""Static emission schedules for variable-width LZW.

The reference threads code width through its sequential loop (`encoder.rs:
289-292,326-335`), but width bumps and CLEAR resets depend only on how many
codes have been emitted since the last reset — never on the data.  For any
spec, the whole wire layout (per-ordinal width, CLEAR positions, bit offsets)
is therefore a *static* schedule: the sequential kernel only has to produce
code values, and bit packing becomes static-slice arithmetic on the host/XLA
side — no data-dependent bit cursors, no scatter.

A stream following this schedule is called *strict*: everything salzweg's
encoder (or ours) produces is strict.  Foreign GIF/TIFF streams with early
CLEARs are not; the device decoder detects the mismatch and the caller falls
back to the general decoders.

This module computes schedules (host, cached) and packs/unpacks code arrays
against them with vectorized static-width segment math.
"""

from __future__ import annotations

import functools

import numpy as np

from lzw_jax.spec import LzwSpec, MAX_WIDTH

__all__ = [
    "Schedule", "emission_schedule", "pack_variable", "unpack_variable",
    "recover_counts", "unpack_variable_device", "pack_variable_device",
]


class Schedule:
    """Static wire schedule for data-code ordinals 0..n_max-1.

    Attributes (numpy, length n_max + 1 where noted):
      widths[m]:       write width of data code m.
      clear_after[m]:  True if a CLEAR (12 bits) follows data code m (only
                       when another data code follows).
      bit_off[m]:      bit offset of data code m (after the initial CLEAR);
                       bit_off[n_max] is the offset one-past-last.
      nxt_of[m]:       dictionary index the encoder assigns at miss m.
      epoch_start[m]:  ordinal of the first code of m's dictionary epoch.
    """

    def __init__(self, spec: LzwSpec, n_max: int):
        self.spec = spec
        self.n_max = n_max
        inc = spec.strategy.increment
        first_free = spec.first_free_code
        widths = np.empty(n_max, np.int64)
        clear_after = np.zeros(n_max, bool)
        nxt_of = np.empty(n_max, np.int64)
        epoch_start = np.empty(n_max, np.int64)
        width = spec.initial_width
        nxt = first_free
        estart = 0
        for m in range(n_max):
            widths[m] = width
            nxt_of[m] = nxt
            epoch_start[m] = estart
            new_index = nxt
            nxt += 1
            if new_index == (1 << width) - inc:
                if width < MAX_WIDTH:
                    width += 1
                else:
                    clear_after[m] = True
                    width = spec.initial_width
                    nxt = first_free
                    estart = m + 1
        self.widths = widths
        self.clear_after = clear_after
        self.nxt_of = nxt_of
        self.epoch_start = epoch_start
        bit_off = np.zeros(n_max + 1, np.int64)
        bit_off[1:] = np.cumsum(widths + MAX_WIDTH * clear_after)
        bit_off += spec.initial_width  # the leading CLEAR
        self.bit_off = bit_off
        # width the *decoder* expects after consuming n data codes (its
        # insert trails the encoder's by one emission — `decoder.rs:272-280`).
        self.next_width = np.empty(n_max + 1, np.int64)
        self.next_width[:n_max] = widths
        self.next_width[n_max] = width
        # total wire bits for a stream of n data codes + EOI (with fix).
        self.eoi_off = self.bit_off[: n_max + 1]

    def eoi_width(self, n: int, fix: bool) -> int:
        """Width of the trailing EOI for a stream of n data codes."""
        if n == 0:
            return self.spec.initial_width
        if not fix:
            return int(self.widths[n - 1])
        if self.clear_after[n - 1]:
            # The decoder's table hit 4096 exactly; read size stays 12.
            return MAX_WIDTH
        return int(self.next_width[n]) if n < len(self.next_width) else int(
            self.widths[n - 1]
        )

    def total_bits(self, n: int, fix: bool = True) -> int:
        """Wire bits for n data codes incl. leading CLEAR and trailing EOI."""
        if n == 0:
            return 2 * self.spec.initial_width
        base = int(self.bit_off[n])
        if self.clear_after[n - 1]:
            base -= MAX_WIDTH  # no CLEAR after the final code (not a miss)
        return base + self.eoi_width(n, fix)

    @functools.cached_property
    def segments(self):
        """Constant-width runs: list of (ordinal_a, ordinal_b, width).

        CLEAR symbols are modelled during pack/unpack as width-12 gaps at
        clear_after positions (value = spec.clear_code when a data code
        follows).
        """
        segs = []
        a = 0
        for m in range(1, self.n_max + 1):
            boundary = (
                m == self.n_max
                or self.widths[m] != self.widths[a]
                or self.clear_after[m - 1]
            )
            if boundary:
                segs.append((a, m, int(self.widths[a])))
                a = m
        return segs


@functools.lru_cache(maxsize=64)
def emission_schedule(spec: LzwSpec, n_max: int) -> Schedule:
    return Schedule(spec, n_max)


@functools.lru_cache(maxsize=8)
def _pack_variable_jitted(spec: LzwSpec, fix_eoi: bool):
    import jax
    import jax.numpy as jnp

    def f(dense, counts):
        return pack_variable(dense, counts, spec, fix_eoi, xp=jnp)

    return jax.jit(f)


def pack_variable_device(dense, counts, spec: LzwSpec, fix_eoi: bool = True):
    """Jitted on-device pack: dense codes stay in HBM, only packed payload
    bytes (the compressed data) ever cross the host link."""
    return _pack_variable_jitted(spec, fix_eoi)(dense, counts)


def pack_variable(dense, counts, spec: LzwSpec, fix_eoi: bool = True, xp=np):
    """Pack dense data-code arrays against the static schedule.

    Args:
      dense:  i32[N, S] data codes (zeros past counts — value 0 packs as
              zero bits, invisible under the zero-filled buffer + trimming).
      counts: i32[N] data-code counts per stream.
      spec:   variable-flavor spec (static).
      xp:     numpy or jax.numpy.
    Returns:
      (bytes u8[N, PB], lengths i32[N]) — PB = ceil(max total bits / 8).
    """
    assert spec.variable
    N, S = dense.shape
    sched = emission_schedule(spec, S)
    little = spec.endianness.value == "little"
    clear = spec.clear_code

    max_bits = sched.total_bits(S, fix_eoi)
    PB = (max_bits + 7) // 8 + 16  # slack for group-rounded segment tails
    out = xp.zeros((N, PB), dtype=xp.int32)

    def add_symbol_column(out, values, width, bit_off):
        """OR one fixed-position symbol (per stream) into the buffer."""
        b0 = bit_off >> 3
        sh = bit_off & 7
        if little:
            window = values << sh
            parts = (window & 0xFF, (window >> 8) & 0xFF, (window >> 16) & 0xFF)
        else:
            window = values << (24 - width - sh)
            parts = ((window >> 16) & 0xFF, (window >> 8) & 0xFF, window & 0xFF)
        for i, p in enumerate(parts):
            out = _iadd(out, (slice(None), b0 + i), p, xp)
        return out

    # Leading CLEAR.
    out = add_symbol_column(
        out, xp.full((N,), clear, dtype=xp.int32), spec.initial_width, 0
    )

    counts = counts.astype(xp.int32)

    # Data-code segments: constant width, consecutive bit positions.  A
    # width-w run is periodic: groups of g symbols (g a multiple of
    # lcm(w,8)/w, chosen >= 8 so spill stays within 3 bytes) cover exactly
    # g*w/8 bytes, so packing is pure reshape + static shifts — no scatter.
    import math

    for (a, b, w) in sched.segments:
        m = b - a
        base_g = (8 * w // math.gcd(w, 8)) // w  # lcm(w,8)/w symbols
        g = base_g * ((8 + base_g - 1) // base_g)  # >= 8 symbols per group
        P = g * w // 8  # bytes per group (>= 3)
        o = int(sched.bit_off[a])
        align = o & 7
        base_byte = o >> 3
        R = (m + g - 1) // g
        seg = xp.zeros((N, R * g), dtype=xp.int32)
        seg = _iset(seg, (slice(None), slice(0, m)), dense[:, a:b], xp)
        seg = seg.reshape(N, R, g)
        acc = xp.zeros((N, R, P + 3), dtype=xp.int32)
        for cpos in range(g):
            bitc = align + cpos * w
            bb = bitc >> 3
            shc = bitc & 7
            if little:
                window = seg[..., cpos] << shc
                shifts = (0, 8, 16)
            else:
                window = seg[..., cpos] << (24 - w - shc)
                shifts = (16, 8, 0)
            for lane, s in enumerate(shifts):
                acc = _iadd(
                    acc, (slice(None), slice(None), bb + lane),
                    (window >> s) & 0xFF, xp,
                )
        # Fold each group's spill bytes into the next group's head.
        main = acc[:, :, :P]
        main = _iadd(
            main, (slice(None), slice(1, None), slice(0, 3)),
            acc[:, :-1, P : P + 3], xp,
        )
        out = _iadd(
            out, (slice(None), slice(base_byte, base_byte + R * P)),
            main.reshape(N, R * P), xp,
        )
        out = _iadd(
            out, (slice(None), slice(base_byte + R * P, base_byte + R * P + 3)),
            acc[:, -1, P : P + 3], xp,
        )

    # Mid-stream CLEARs: emitted only when a data code follows.
    for m in np.nonzero(sched.clear_after[:S])[0]:
        present = (counts > (m + 1)).astype(xp.int32)
        vals = present * clear
        out = add_symbol_column(
            out, vals, MAX_WIDTH, int(sched.bit_off[m] + sched.widths[m])
        )

    # Trailing EOI: per-stream position/width.  Host: loop the handful of
    # distinct counts.  Device: precomputed (offset, width, byte length)
    # tables indexed by counts — one tiny gather + scatter-add per stream.
    eoi = spec.end_code
    if xp is np:
        for n_codes in _unique_counts(counts, xp):
            mask = (counts == n_codes).astype(xp.int32)
            if n_codes == 0:
                off = spec.initial_width
                w = spec.initial_width
            else:
                off = sched.total_bits(n_codes, fix_eoi) - sched.eoi_width(
                    n_codes, fix_eoi
                )
                w = sched.eoi_width(n_codes, fix_eoi)
            out = add_symbol_column(out, mask * eoi, w, int(off))
        lengths = np.asarray(
            [(sched.total_bits(int(n), fix_eoi) + 7) // 8
             for n in _as_list(counts)]
        )
        return (out[:, :PB] & 0xFF).astype(np.uint8), lengths.astype(np.int32)

    # xp is jax.numpy: vectorized per-stream EOI + lengths.
    off_tab = np.empty(S + 1, np.int32)
    w_tab = np.empty(S + 1, np.int32)
    len_tab = np.empty(S + 1, np.int32)
    off_tab[0] = w_tab[0] = spec.initial_width
    len_tab[0] = (2 * spec.initial_width + 7) // 8
    for n in range(1, S + 1):
        w_tab[n] = sched.eoi_width(n, fix_eoi)
        off_tab[n] = sched.total_bits(n, fix_eoi) - w_tab[n]
        len_tab[n] = (sched.total_bits(n, fix_eoi) + 7) // 8
    off = xp.asarray(off_tab)[counts]
    w = xp.asarray(w_tab)[counts]
    lengths = xp.asarray(len_tab)[counts]
    b0 = off >> 3
    sh = off & 7
    if little:
        window = (eoi << sh).astype(xp.int32)
    else:
        window = (eoi << (24 - w - sh)).astype(xp.int32)
    parts = xp.stack(
        [(window >> s) & 0xFF for s in ((0, 8, 16) if little else (16, 8, 0))],
        axis=-1,
    )
    rows = xp.arange(N)[:, None]
    cols = b0[:, None] + xp.arange(3)[None, :]
    out = out.at[rows, cols].add(parts)
    return (out[:, :PB] & 0xFF).astype(xp.uint8), lengths.astype(xp.int32)


def _iadd(out, idx, val, xp):
    if xp is np:
        out[idx] += val
        return out
    return out.at[idx].add(val)


def _iset(out, idx, val, xp):
    if xp is np:
        out[idx] = val
        return out
    return out.at[idx].set(val)


def _unique_counts(counts, xp):
    if xp is np:
        return sorted(set(int(c) for c in counts))
    raise NotImplementedError


def _as_list(counts):
    return [int(c) for c in counts]


def recover_counts(payloads, plens, spec: LzwSpec):
    """Host-side stream-length recovery + frame-level strictness checks.

    Candidates for a stream's data-code count n are every n whose wire byte
    length matches; ambiguity (possible at small code sizes where several
    3-bit codes share a byte) is resolved by checking the trailing EOI.
    Streams are grouped by byte length so the candidate sets are shared.

    Returns (counts i64[N], strict bool[N], S).  ``strict`` here covers the
    checks that need only a handful of byte reads per stream (byte-length /
    EOI match, leading CLEAR, mid-stream CLEARs); the per-data-slot
    CLEAR/EOI check lives with the unpack.
    """
    assert spec.variable
    N, PB = payloads.shape
    # Upper bound on data codes: every code at the minimum width.
    S = int((8 * PB) // spec.initial_width + 2)
    sched = emission_schedule(spec, S)
    little = spec.endianness.value == "little"

    # int32 suffices: reads combine <= 3 bytes (< 2^24) before shifting.
    padded = np.zeros((N, PB + 4), np.int32)
    padded[:, :PB] = payloads

    def read_cols(bit_offs, widths):
        """Read one symbol per (stream, position): bit_offs/widths (M,)."""
        bit_offs = np.asarray(bit_offs, np.int64)
        widths = np.asarray(widths, np.int64)
        b0 = bit_offs >> 3
        if little:
            w0 = (padded[:, b0] | (padded[:, b0 + 1] << 8)
                  | (padded[:, b0 + 2] << 16))
            return (w0 >> (bit_offs & 7)) & ((1 << widths) - 1)
        wbe = ((padded[:, b0] << 16) | (padded[:, b0 + 1] << 8)
               | padded[:, b0 + 2])
        return (wbe >> (24 - (bit_offs & 7) - widths)) & ((1 << widths) - 1)

    totals = np.array([sched.total_bits(n, True) for n in range(S + 1)])
    totals_nofix = np.array([sched.total_bits(n, False) for n in range(S + 1)])
    byte_len = (totals + 7) // 8
    byte_len_nofix = (totals_nofix + 7) // 8
    counts = np.zeros(N, np.int64)
    chosen = np.zeros(N, bool)
    strict = np.ones(N, bool)

    plens = np.asarray(plens, np.int64)
    zero = plens == 0
    chosen |= zero  # n = 0
    for nbytes in np.unique(plens[~chosen]) if (~chosen).any() else []:
        rows = np.nonzero(plens == nbytes)[0]
        cands = np.nonzero(
            (byte_len == nbytes) | (byte_len_nofix == nbytes)
        )[0]
        for n in cands[::-1]:
            n = int(n)
            todo = rows[~chosen[rows]]
            if todo.size == 0:
                break
            for fix in (True, False):
                if (sched.total_bits(n, fix) + 7) // 8 != nbytes:
                    continue
                off = sched.total_bits(n, fix) - sched.eoi_width(n, fix)
                w = sched.eoi_width(n, fix)
                if (off >> 3) + 2 >= padded.shape[1]:
                    continue
                v = read_cols([off], [w])[todo, 0]
                hit = todo[v == spec.end_code]
                counts[hit] = n
                chosen[hit] = True
    strict &= chosen
    counts[~chosen] = 0
    max_n = int(counts.max()) if N else 0

    # Validate the leading CLEAR.
    lead = read_cols([0], [spec.initial_width])[:, 0]
    strict &= (lead == spec.clear_code) | (plens == 0)

    # Mid-stream CLEARs (a handful of positions).
    for m in np.nonzero(sched.clear_after[:max_n])[0]:
        cvals = read_cols(
            [int(sched.bit_off[m] + sched.widths[m])], [MAX_WIDTH]
        )[:, 0]
        mid = (m + 1) < counts
        strict &= ~mid | (cvals == spec.clear_code)

    return counts, strict, S


def _unpack_segments(payloads_padded, counts, spec: LzwSpec, S: int, xp):
    """Segment-wise dense-code unpack, numpy or jax.numpy.

    ``payloads_padded``: int32/int64 [N, PB+4] byte values.  Returns
    (dense i32[N, S], data_ok bool[N]) where data_ok is False when a data
    slot holds CLEAR/EOI (non-strict stream).

    Each constant-width segment is periodic — g symbols cover exactly
    P = g*w/8 bytes — so unpacking is reshape + static shifts per in-group
    position, with each group's 3 spill bytes borrowed from the next group.
    No gathers: elementwise ops, cumulative sums and one scatter.
    """
    import math

    N = payloads_padded.shape[0]
    sched = emission_schedule(spec, S)
    little = spec.endianness.value == "little"
    max_n = int(counts.max()) if hasattr(counts, "max") and xp is np else S
    dense_parts = []
    ok = xp.ones((N,), bool)
    counts_i = counts.astype(xp.int64 if xp is np else xp.int32)

    pos = 0
    for (a, b, w) in sched.segments:
        if a >= max_n:
            break
        b_eff = min(b, max_n) if xp is np else b
        m = b_eff - a
        base_g = (8 * w // math.gcd(w, 8)) // w
        g = base_g * ((8 + base_g - 1) // base_g)
        P = g * w // 8
        o = int(sched.bit_off[a])
        align = o & 7
        base_byte = o >> 3
        R = (m + g - 1) // g
        need = base_byte + R * P + 3
        if need > payloads_padded.shape[1]:
            pad = need - payloads_padded.shape[1]
            payloads_padded = xp.concatenate(
                [payloads_padded,
                 xp.zeros((N, pad), payloads_padded.dtype)], axis=1
            )
        main = payloads_padded[:, base_byte : base_byte + R * P]
        main = main.reshape(N, R, P)
        tail = payloads_padded[:, base_byte + R * P : base_byte + R * P + 3]
        nxt3 = xp.concatenate(
            [main[:, 1:, :3], tail.reshape(N, 1, 3)], axis=1
        )
        grp = xp.concatenate([main, nxt3], axis=2)  # (N, R, P+3)
        cols = []
        mask = (1 << w) - 1
        for cpos in range(g):
            bitc = align + cpos * w
            bb = bitc >> 3
            sh = bitc & 7
            if little:
                w0 = (grp[..., bb] | (grp[..., bb + 1] << 8)
                      | (grp[..., bb + 2] << 16))
                cols.append((w0 >> sh) & mask)
            else:
                w0 = ((grp[..., bb] << 16) | (grp[..., bb + 1] << 8)
                      | grp[..., bb + 2])
                cols.append((w0 >> (24 - w - sh)) & mask)
        vals = xp.stack(cols, axis=-1).reshape(N, R * g)[:, :m]
        ord_ = xp.arange(a, b_eff)
        sel = ord_[None, :] < counts_i[:, None]
        vals = xp.where(sel, vals, 0)
        # A data-code slot holding CLEAR/EOI means a non-strict stream.
        ok &= ~(
            sel & ((vals == spec.clear_code) | (vals == spec.end_code))
        ).any(axis=1)
        dense_parts.append(vals.astype(xp.int32))
        pos = b_eff

    if pos < S:
        dense_parts.append(xp.zeros((N, S - pos), xp.int32))
    dense = xp.concatenate(dense_parts, axis=1) if dense_parts else xp.zeros(
        (N, S), xp.int32
    )
    return dense, ok


def unpack_variable_device(payloads, counts, spec: LzwSpec, S: int):
    """Device-side dense-code unpack (jnp): payload bytes stay the only
    host→device transfer.  Returns (dense i32[N, S], data_ok bool[N])."""
    import jax.numpy as jnp

    padded = jnp.pad(
        payloads.astype(jnp.int32), ((0, 0), (0, 4))
    )
    return _unpack_segments(padded, counts, spec, S, jnp)


def unpack_variable(payloads, plens, spec: LzwSpec, xp=np):
    """Unpack strict streams to dense data codes + validation flags (host).

    Returns (dense i32[N, S], counts i32[N], strict bool[N]).  ``strict`` is
    False when the stream deviates from the static schedule (early CLEAR,
    missing EOI, width drift) — callers must fall back to the general
    decoder for those streams.
    """
    assert spec.variable and xp is np
    N, PB = payloads.shape
    counts, strict, S = recover_counts(payloads, plens, spec)
    padded = np.zeros((N, PB + 4), np.int64)
    padded[:, :PB] = payloads
    dense, data_ok = _unpack_segments(padded, counts, spec, S, np)
    return dense, counts.astype(np.int32), strict & data_ok
