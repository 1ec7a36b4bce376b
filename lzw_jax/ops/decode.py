"""Jittable LZW decoder (single block): sequential table scan + parallel
word materialization.

Data-parallel redesign of the reference decoder (`decoder.rs:174-290` variable,
`:553-642` fixed).  The reference interleaves three jobs in one byte-at-a-time
loop: reading variable-width codes, growing the prefix/suffix/length tables,
and walking suffix chains backwards through a stack to materialise each word
(`decoder.rs:251-267`).  Only the first two are inherently sequential — and
they are O(1) per *code*, not per byte.  The expensive part (materialising
~2-4 output bytes per code) is embarrassingly parallel once the tables exist.

Pass 1 — sequential scan over codes (cheap):
  * reads each code at the current bit cursor/width (LSB or MSB order);
  * maintains the dictionary as **append-only global tables**: every insert
    gets a fresh global id, and a local->global ``code_map`` translates wire
    codes of the current dictionary epoch.  A CLEAR reset just rewinds the
    local index — old entries stay immutable forever, which is what makes
    pass 2 able to use one final snapshot of the tables.  (The reference
    instead overwrites table slots in place and is forced to materialise
    before the next insert.)
  * tracks, per emitted word: global id, length, output offset.  Lengths are
    O(1) via the stored length table (as in the reference); offsets are the
    running sum.

Pass 2 — data-parallel chain walk:
  * every word walks its suffix chain in lockstep rounds, scattering one byte
    per round at ``offset + length - 1 - round``; total scatter work equals
    the decoded size.  This replaces the reference's per-word sequential
    stack (`decoder.rs:201,251-267`) with a vectorizable two-pass scheme.

Compatibility: byte-exact on all well-formed streams and on the reference's
error taxonomy (UnexpectedCode beyond next index, MissingClearCode, truncated
stream).  For corrupt-but-not-erroring streams the reference emits
stale-table garbage (`decoder.rs:230-236` after a reset); we emit the same
bytes for the single-literal case but do not chase full bug-equivalence of
garbage output on streams the reference itself cannot round-trip.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from lzw_jax.spec import LzwSpec, MAX_TABLE_SIZE, MAX_WIDTH

__all__ = [
    "decode_pass1",
    "decode_pass2",
    "decode_block",
    "pass1_step_bound",
]

ERR_NONE = 0
ERR_UNEXPECTED_CODE = 1
ERR_MISSING_CLEAR = 2
ERR_TRUNCATED = 3


def pass1_step_bound(n_bytes: int, spec: LzwSpec) -> int:
    """Static bound on the number of codes in an ``n_bytes`` stream."""
    min_width = spec.initial_width if spec.variable else MAX_WIDTH
    return (8 * n_bytes) // min_width + 1


@functools.partial(jax.jit, static_argnames=("spec",))
def decode_pass1(data, n_valid, spec: LzwSpec):
    """Sequential scan: codes -> (global id, length, offset) word list.

    Args:
      data:    u8[M] compressed bytes, padded past ``n_valid``.
      n_valid: i32 scalar count of valid bytes.
      spec:    static wire format.

    Returns dict with global string tables (``gprefix``, ``gsuffix``,
    append-only, immutable), per-word arrays ``out_g``/``out_len``/``out_off``
    (length = pass1_step_bound(M)), ``n_words``, ``total_len``, ``error`` and
    ``error_code``.
    """
    M = data.shape[0]
    S = pass1_step_bound(M, spec)
    alphabet = spec.alphabet_size
    G = alphabet + S + 2  # roots + dynamic entries + UNINIT sentinel
    UNINIT = G - 1
    variable = spec.variable
    little = spec.endianness.value == "little"

    padded = jnp.concatenate([data.astype(jnp.int32), jnp.zeros(2, jnp.int32)])
    total_bits = 8 * n_valid

    roots = jnp.arange(alphabet, dtype=jnp.int32)
    gprefix = jnp.zeros(G, jnp.int32).at[:alphabet].set(roots)
    gsuffix = jnp.zeros(G, jnp.int32).at[:alphabet].set(roots)
    gfirst = jnp.zeros(G, jnp.int32).at[:alphabet].set(roots)
    glength = jnp.zeros(G, jnp.int32).at[:alphabet].set(1)
    # Wire code each entry was inserted under; used only to report the exact
    # code value on corrupt-chain errors (`decoder.rs:257-260`).
    glocal = jnp.zeros(G, jnp.int32).at[:alphabet].set(roots)
    # local wire code -> global id; stale across resets by design
    # (mirrors the reference's tables not being cleared, `decoder.rs:222-227`).
    code_map = jnp.full(MAX_TABLE_SIZE, UNINIT, jnp.int32)
    code_map = code_map.at[:alphabet].set(roots)

    out_g = jnp.zeros(S, jnp.int32)
    out_len = jnp.zeros(S, jnp.int32)
    out_off = jnp.zeros(S, jnp.int32)
    # First-code literals are emitted without a chain walk in the reference
    # (`decoder.rs:230-236`) and are exempt from corrupt-chain detection.
    out_lit = jnp.zeros(S, jnp.bool_)

    def read_code(cursor, width):
        byte = cursor >> 3
        sh = cursor & 7
        b0 = padded[byte]
        b1 = padded[byte + 1]
        b2 = padded[byte + 2]
        mask = (1 << width) - 1
        if little:
            window = b0 | (b1 << 8) | (b2 << 16)
            return (window >> sh) & mask
        window = (b0 << 16) | (b1 << 8) | b2
        return (window >> (24 - sh - width)) & mask

    def threshold_of(width):
        return (1 << width) - spec.strategy.increment

    init_state = dict(
        cursor=jnp.int32(0),
        read_size=jnp.int32(spec.initial_width),
        next_local=jnp.int32(spec.first_free_code),
        gcount=jnp.int32(alphabet),
        prev_exists=jnp.bool_(False),
        prev_g=jnp.int32(0),
        step=jnp.int32(0),
        off=jnp.int32(0),
        done=jnp.bool_(False),
        err=jnp.int32(ERR_NONE),
        err_code=jnp.int32(0),
        gprefix=gprefix,
        gsuffix=gsuffix,
        gfirst=gfirst,
        glength=glength,
        glocal=glocal,
        code_map=code_map,
        out_g=out_g,
        out_len=out_len,
        out_off=out_off,
        out_lit=out_lit,
    )

    def cond(s):
        return (~s["done"]) & (s["step"] < S)

    def body(s):
        can_read = s["cursor"] + s["read_size"] <= total_bits
        code = read_code(s["cursor"], s["read_size"])
        cursor = s["cursor"] + s["read_size"]

        if variable:
            truncated = ~can_read
            is_clear = can_read & (code == spec.clear_code)
            is_end = can_read & (code == spec.end_code)
            process = can_read & ~is_clear & ~is_end
        else:
            truncated = jnp.bool_(False)
            is_clear = jnp.bool_(False)
            is_end = ~can_read  # clean termination on bit exhaustion
            process = can_read

        first = process & ~s["prev_exists"]
        normal = process & s["prev_exists"]

        g_mapped = s["code_map"][jnp.clip(code, 0, MAX_TABLE_SIZE - 1)]
        bad = normal & (code > s["next_local"])
        kwkwk = normal & (code == s["next_local"])
        normal_ok = normal & ~bad
        table_full = s["next_local"] >= MAX_TABLE_SIZE
        if variable:
            missing_clear = normal_ok & table_full
            normal_ok = normal_ok & ~missing_clear
            may_insert = normal_ok
        else:
            missing_clear = jnp.bool_(False)
            may_insert = normal_ok & ~table_full

        prev_g = s["prev_g"]
        prev_len = s["glength"][prev_g]
        prev_first = s["gfirst"][prev_g]

        g_new = s["gcount"]
        g_cur = jnp.where(kwkwk, g_new, g_mapped)
        cur_first = jnp.where(kwkwk, prev_first, s["gfirst"][g_mapped])
        cur_len = jnp.where(kwkwk, prev_len + 1, s["glength"][g_mapped])

        # Append-only insert of the new dictionary entry.
        ins = may_insert
        gprefix = s["gprefix"].at[g_new].set(jnp.where(ins, prev_g, 0))
        gsuffix = s["gsuffix"].at[g_new].set(jnp.where(ins, cur_first, 0))
        gfirst = s["gfirst"].at[g_new].set(jnp.where(ins, prev_first, 0))
        glength = s["glength"].at[g_new].set(jnp.where(ins, prev_len + 1, 0))
        glocal = s["glocal"].at[g_new].set(jnp.where(ins, s["next_local"], 0))
        code_map = s["code_map"].at[
            jnp.where(ins, s["next_local"], MAX_TABLE_SIZE - 1)
        ].set(jnp.where(ins, g_new, s["code_map"][MAX_TABLE_SIZE - 1]))
        gcount = jnp.where(ins, g_new + 1, g_new)
        next_local = jnp.where(ins, s["next_local"] + 1, s["next_local"])

        # Emit the decoded word (single literal for the first code).
        emit = first | normal_ok
        word_g = jnp.where(first, g_mapped, g_cur)
        word_len = jnp.where(first, 1, cur_len)
        out_g = s["out_g"].at[s["step"]].set(jnp.where(emit, word_g, 0))
        out_len = s["out_len"].at[s["step"]].set(jnp.where(emit, word_len, 0))
        out_off = s["out_off"].at[s["step"]].set(s["off"])
        out_lit = s["out_lit"].at[s["step"]].set(first)
        off = s["off"] + jnp.where(emit, word_len, 0)
        step = s["step"] + 1

        # Width schedule (`decoder.rs:277-280`) and CLEAR reset.
        read_size = s["read_size"]
        if variable:
            bump = ins & (next_local == threshold_of(read_size)) & (
                read_size < MAX_WIDTH
            )
            read_size = jnp.where(bump, read_size + 1, read_size)
            read_size = jnp.where(is_clear, spec.initial_width, read_size)
            next_local = jnp.where(is_clear, spec.first_free_code, next_local)

        err_kind = jnp.where(
            truncated, ERR_TRUNCATED,
            jnp.where(bad, ERR_UNEXPECTED_CODE,
                      jnp.where(missing_clear, ERR_MISSING_CLEAR, ERR_NONE)),
        )
        done = is_end | (err_kind != ERR_NONE)

        prev_exists = jnp.where(
            is_clear, False, jnp.where(emit, True, s["prev_exists"])
        )
        prev_g = jnp.where(emit, word_g, prev_g)

        return dict(
            cursor=cursor,
            read_size=read_size,
            next_local=next_local,
            gcount=gcount,
            prev_exists=prev_exists,
            prev_g=prev_g,
            step=step,
            off=off,
            done=done,
            err=jnp.where(s["err"] == ERR_NONE, err_kind, s["err"]),
            err_code=jnp.where(bad, code, s["err_code"]),
            gprefix=gprefix,
            gsuffix=gsuffix,
            gfirst=gfirst,
            glength=glength,
            glocal=glocal,
            code_map=code_map,
            out_g=out_g,
            out_len=out_len,
            out_off=out_off,
            out_lit=out_lit,
        )

    s = jax.lax.while_loop(cond, body, init_state)
    return {
        "gprefix": s["gprefix"],
        "gsuffix": s["gsuffix"],
        "glocal": s["glocal"],
        "out_g": s["out_g"],
        "out_len": s["out_len"],
        "out_off": s["out_off"],
        "out_lit": s["out_lit"],
        "n_words": s["step"],
        "total_len": s["off"],
        "error": s["err"],
        "error_code": s["err_code"],
        "max_len": jnp.max(s["out_len"]),
    }


@functools.partial(jax.jit, static_argnames=("out_bound", "alphabet"))
def decode_pass2(
    gprefix, gsuffix, glocal, out_g, out_len, out_off, out_lit,
    out_bound: int, alphabet: int,
):
    """Parallel materialization: lockstep backwards chain walk.

    Returns (u8[out_bound] output, i32 err_word_step, i32 err_code).  Bytes
    past the decoded length are zero; writes beyond ``out_bound`` are dropped
    (the caller checks ``total_len``).

    A word whose first byte (the last walked) is not a root entry has a
    suffix chain longer than its recorded length — the corrupt-chain case the
    reference detects by stack underflow (`decoder.rs:257-260`).
    ``err_word_step`` is the earliest such word's index (or i32.max), and
    ``err_code`` the wire code at the underflow point, matching the value the
    reference reports.
    """
    pos0 = out_off + out_len - 1
    big = jnp.int32(2**31 - 1)
    n_words = out_g.shape[0]
    state = (
        jnp.zeros(out_bound, jnp.int32),
        out_g,
        pos0,
        out_len,
        jnp.full(n_words, big, jnp.int32),  # per-word underflow flag
    )

    def cond(s):
        return jnp.any(s[3] > 0)

    def body(s):
        out, cur, pos, rem, bad = s
        active = rem > 0
        byte = gsuffix[cur]
        # Out-of-range / inactive writes land at index out_bound and drop.
        idx = jnp.where(active & (pos >= 0) & (pos < out_bound), pos, out_bound)
        out = out.at[idx].set(byte, mode="drop")
        underflow = active & (rem == 1) & (cur >= alphabet) & ~out_lit
        bad = jnp.where(underflow, glocal[cur], bad)
        cur = jnp.where(active, gprefix[cur], cur)
        return (out, cur, pos - 1, jnp.maximum(rem - 1, 0), bad)

    out, _, _, _, bad = jax.lax.while_loop(cond, body, state)
    steps = jnp.arange(n_words, dtype=jnp.int32)
    err_word_step = jnp.min(jnp.where(bad != big, steps, big))
    err_code = jnp.where(
        err_word_step != big, bad[jnp.clip(err_word_step, 0, n_words - 1)], 0
    )
    return out.astype(jnp.uint8), err_word_step, err_code


def decode_block(data, n_valid, spec: LzwSpec, out_bound: int):
    """Fused two-pass decode with a static output bound (container path).

    Error precedence follows stream order: a pass-2 corrupt-chain error on an
    earlier word wins over a pass-1 error on a later code.
    """
    p1 = decode_pass1(data, n_valid, spec)
    out, err_word_step, err_code2 = decode_pass2(
        p1["gprefix"], p1["gsuffix"], p1["glocal"], p1["out_g"],
        p1["out_len"], p1["out_off"], p1["out_lit"], out_bound,
        spec.alphabet_size,
    )
    big = jnp.int32(2**31 - 1)
    # The pass-1 error (if any) occurred on the last processed step.
    p1_step = jnp.where(p1["error"] != ERR_NONE, p1["n_words"] - 1, big)
    chain_first = err_word_step < p1_step
    error = jnp.where(chain_first, ERR_UNEXPECTED_CODE, p1["error"])
    error_code = jnp.where(chain_first, err_code2, p1["error_code"])
    return {
        "out": out,
        "total_len": p1["total_len"],
        "error": error,
        "error_code": error_code,
    }
