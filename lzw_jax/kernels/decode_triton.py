"""Block decode kernel for the GPU: the whole code loop in one launch.

Pallas through Triton, one block per lane as in
:mod:`lzw_jax.kernels.encode_triton`.  Each lane reads its codes at the
running bit cursor, keeps the reference decoder's string table in device
memory (two int32 words per code: ``prefix << 8 | suffix`` and the word
length) and writes every word straight into its output row by walking the
suffix chain backwards, as the scalar oracle does
(:func:`lzw_jax.ops.reference.decode_bytes`).  CLEAR is handled inline,
so self-produced streams and foreign streams with early CLEARs take the
same path.

The table is updated in place and survives CLEAR, which reproduces the
oracle's stale-table bytes on corrupt streams.  Root entries are never
written (inserts start at the first free code), so they are computed rather
than stored.  Errors follow the ``ops.decode`` contract: one
``(error, error_code)`` pair per block, in stream order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from lzw_jax.kernels.encode_triton import LANES, _any, _shr
from lzw_jax.ops.decode import (
    ERR_MISSING_CLEAR,
    ERR_NONE,
    ERR_TRUNCATED,
    ERR_UNEXPECTED_CODE,
)
from lzw_jax.spec import Endianness, LzwSpec, MAX_TABLE_SIZE, MAX_WIDTH

__all__ = ["decode_blocks"]

_WORDS = 2 * MAX_TABLE_SIZE  # table words per lane


def _kernel(comp_ref, clen_ref, _tab_in, _out_in, total_ref, err_ref,
            errcode_ref, tab_ref, out_ref, *, spec: LzwSpec, row: int,
            bound: int, lanes: int):
    variable = spec.variable
    little = spec.endianness is Endianness.LITTLE
    alphabet = spec.alphabet_size
    inc = spec.strategy.increment
    init_width = spec.initial_width if variable else MAX_WIDTH

    lane = pl.program_id(0) * lanes + jnp.arange(lanes, dtype=jnp.int32)
    total_bits = 8 * plt.load(clen_ref.at[lane])
    cbase = lane * row
    tbase = lane * _WORDS
    obase = lane * bound
    zero = jnp.zeros(lanes, jnp.int32)
    no = zero < 0

    def entry(code, mask):
        """(prefix << 8 | suffix, length) of ``code``; roots computed."""
        stored = mask & (code >= alphabet)
        ps = plt.load(tab_ref.at[tbase + 2 * code], mask=stored, other=0)
        ln = plt.load(tab_ref.at[tbase + 2 * code + 1], mask=stored, other=0)
        root = code < alphabet
        return jnp.where(root, code, ps), jnp.where(root, 1, ln)

    def emit(pos, byte, mask):
        inside = mask & (pos >= 0) & (pos < bound)
        plt.store(out_ref.at[obase + jnp.clip(pos, 0, bound - 1)],
                  byte.astype(jnp.uint8), mask=inside)

    def read_code(cursor, width, mask):
        byte = _shr(cursor, 3)
        sh = cursor & 7
        b = [
            plt.load(comp_ref.at[cbase + jnp.minimum(byte + j, row - 1)],
                     mask=mask & (byte + j < row), other=0).astype(jnp.int32)
            for j in range(3)
        ]
        low = jnp.left_shift(1, width) - 1
        if little:
            window = b[0] | jnp.left_shift(b[1], 8) | jnp.left_shift(b[2], 16)
            return _shr(window, sh) & low
        window = jnp.left_shift(b[0], 16) | jnp.left_shift(b[1], 8) | b[2]
        return _shr(window, 24 - sh - width) & low

    def body(s):
        cursor, width, nxt, prev, have_prev, pos, done, err, err_code = s
        live = ~done
        can_read = cursor + width <= total_bits
        code = read_code(cursor, width, live & can_read)
        if variable:
            truncated = live & ~can_read
            is_clear = live & can_read & (code == spec.clear_code)
            is_end = live & can_read & (code == spec.end_code)
            process = live & can_read & ~is_clear & ~is_end
        else:
            truncated = is_clear = no
            is_end = live & ~can_read  # clean end on bit exhaustion
            process = live & can_read
        first = process & ~have_prev
        normal = process & have_prev
        bad = normal & (code > nxt)
        kwkwk = normal & (code == nxt)
        ok = normal & ~bad
        src = jnp.where(kwkwk, prev, code)
        _, n = entry(src, ok)

        def walk(w):
            c, at, walking, under = w
            at = jnp.where(walking, at - 1, at)
            fail = walking & (at <= 0)
            step = walking & ~fail
            ps, _ = entry(c, step)
            emit(pos + at, ps & 0xFF, step)
            c = jnp.where(step, _shr(ps, 8), c)
            return c, at, step & (c >= alphabet), under | fail

        c, _, _, under = lax.while_loop(
            lambda w: _any(w[2]), walk, (src, n, ok & (src >= alphabet), no)
        )
        good = ok & ~under
        emit(pos, c, good)  # the word's first byte is its root code
        emit(pos + n, c, good & kwkwk)
        lit, _ = entry(code, first)
        emit(pos, lit & 0xFF, first)
        pos = pos + jnp.where(first, 1, jnp.where(good, n + kwkwk, 0))

        full = nxt >= MAX_TABLE_SIZE
        missing = good & full if variable else no
        insert = good & ~full
        _, prev_len = entry(prev, insert)
        slot = tbase + 2 * jnp.minimum(nxt, MAX_TABLE_SIZE - 1)
        plt.store(tab_ref.at[slot], jnp.left_shift(prev, 8) | c, mask=insert)
        plt.store(tab_ref.at[slot + 1], prev_len + 1, mask=insert)
        nxt = jnp.where(insert, nxt + 1, nxt)
        new_width = width
        if variable:
            bump = (insert & (width < MAX_WIDTH)
                    & (nxt == jnp.left_shift(1, width) - inc))
            new_width = jnp.where(bump, width + 1, width)
            new_width = jnp.where(is_clear, init_width, new_width)
            nxt = jnp.where(is_clear, spec.first_free_code, nxt)
        prev = jnp.where(first | good, code, prev)
        have_prev = (have_prev | first) & ~is_clear

        kind = jnp.where(
            truncated, ERR_TRUNCATED,
            jnp.where(bad | (ok & under), ERR_UNEXPECTED_CODE,
                      jnp.where(missing, ERR_MISSING_CLEAR, ERR_NONE)))
        err_code = jnp.where(bad, code, jnp.where(ok & under, c, err_code))
        return (jnp.where(live, cursor + width, cursor), new_width, nxt,
                prev, have_prev, pos, done | is_end | (kind != ERR_NONE),
                jnp.where(err == ERR_NONE, kind, err), err_code)

    state = (zero, zero + init_width, zero + spec.first_free_code, zero, no,
             zero, no, zero + ERR_NONE, zero)
    s = lax.while_loop(lambda s: _any(~s[6]), body, state)
    plt.store(total_ref.at[lane], s[5])
    plt.store(err_ref.at[lane], s[7])
    plt.store(errcode_ref.at[lane], s[8])


@functools.partial(
    jax.jit, static_argnames=("spec", "out_bound", "lanes", "interpret"))
def decode_blocks(comp, n_valid, spec: LzwSpec, out_bound: int,
                  lanes: int = LANES, interpret: bool = False):
    """Decode a batch of independent streams.

    Args:
      comp:      u8[N, M] compressed payloads, zero padded past ``n_valid``.
      n_valid:   i32[N] payload lengths in bytes.
      spec:      static wire format.
      out_bound: static output row size; bytes past it are dropped (the
        caller compares ``total_len`` with what it expects).
      lanes:     blocks per program (a power of two).
      interpret: run the kernel in the Pallas interpreter (CPU tests).

    Returns (out u8[N, out_bound], total_len i32[N], error i32[N],
    error_code i32[N]), as :func:`lzw_jax.ops.decode.decode_block`.
    """
    N, M = comp.shape
    Np = -(-N // lanes) * lanes
    comp = jnp.pad(comp.astype(jnp.uint8), ((0, Np - N), (0, 0)))
    n_valid = jnp.pad(n_valid.astype(jnp.int32), (0, Np - N))
    kernel = functools.partial(_kernel, spec=spec, row=M, bound=out_bound,
                               lanes=lanes)
    i32 = lambda n: jax.ShapeDtypeStruct((n,), jnp.int32)  # noqa: E731
    total, err, err_code, _, out = pl.pallas_call(
        kernel,
        out_shape=(i32(Np), i32(Np), i32(Np), i32(Np * _WORDS),
                   jax.ShapeDtypeStruct((Np * out_bound,), jnp.uint8)),
        grid=(Np // lanes,),
        input_output_aliases={2: 3, 3: 4},
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="lzw_decode_blocks",
    )(comp.reshape(-1), n_valid, jnp.zeros(Np * _WORDS, jnp.int32),
      jnp.zeros(Np * out_bound, jnp.uint8))
    return out.reshape(Np, out_bound)[:N], total[:N], err[:N], err_code[:N]
