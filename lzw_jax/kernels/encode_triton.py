"""Block encode kernel for the GPU: the whole dictionary scan in one launch.

Pallas through Triton.  Each program owns ``lanes`` independent blocks, one
per thread; the loop over a block's bytes runs inside the kernel, so a batch
of blocks costs one launch however long the blocks are.

* Each lane's dictionary is an open-addressing hash table in device memory,
  one packed ``key << 12 | code`` int32 word per slot
  (``key = prefix << 8 | byte``), probed and filled with masked gathers and
  scatters.  The variable flavors interleave an epoch word with every slot,
  so the table-full reset is a counter bump; the fixed flavor never resets
  and marks an empty slot with 0 (a live entry has a code >= 256).
* Codes are bit-packed (LSB- or MSB-first) inside the same loop, so the
  kernel writes finished payload bytes and only those cross to the host.

Semantics follow :func:`lzw_jax.ops.encode.encode_block` step for step: the
same hash, the same emission order, the same ``(error, error_code)``
contract and the same EOI width fix.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from lzw_jax.ops.encode import ERR_NONE, ERR_UNEXPECTED_CODE, packed_bound
from lzw_jax.spec import Endianness, LzwSpec, MAX_TABLE_SIZE, MAX_WIDTH

__all__ = ["LANES", "HASH_BITS", "encode_blocks"]

LANES = 32  # blocks per program: one warp, one block per thread
HASH_BITS = 13  # 8192 slots for at most 4097 live entries


def _any(mask):
    return jnp.max(mask.astype(jnp.int32)) > 0


def _shr(x, n):
    return lax.shift_right_logical(x, jnp.asarray(n, jnp.int32))


def _hash(key):
    """Fibonacci hash, as ``ops.encode._hash`` (2654435761 mod 2**32)."""
    return _shr(key * jnp.int32(-1640531535), 32 - HASH_BITS)


def _put(out_ref, base, cap, little, writer, code, width, cond):
    """Append ``width``-bit ``code`` where ``cond``; flush whole bytes.

    ``writer`` is (acc, nbits, pos): at most 7 pending bits, so one code of
    <= 12 bits completes at most two bytes.
    """
    acc, nbits, pos = writer
    w = jnp.where(cond, width, 0)
    code = code & (jnp.left_shift(1, w) - 1)
    acc = acc | jnp.left_shift(code, nbits) if little else (
        jnp.left_shift(acc, w) | code)
    nbits = nbits + w
    for _ in range(2):
        full = nbits >= 8
        if little:
            byte = acc & 0xFF
        else:
            byte = _shr(acc, jnp.maximum(nbits - 8, 0)) & 0xFF
        plt.store(out_ref.at[base + jnp.minimum(pos, cap - 1)],
                  byte.astype(jnp.uint8), mask=full & (pos < cap))
        if little:
            acc = jnp.where(full, _shr(acc, 8), acc)
        nbits = jnp.where(full, nbits - 8, nbits)
        pos = jnp.where(full, pos + 1, pos)
    if not little:
        acc = acc & (jnp.left_shift(1, nbits) - 1)
    return acc, nbits, pos


def _kernel(data_ref, nvalid_ref, _table_in, out_ref, nbytes_ref, err_ref,
            errcode_ref, table_ref, *, spec: LzwSpec, block: int, cap: int,
            lanes: int, fix_eoi: bool):
    variable = spec.variable
    little = spec.endianness is Endianness.LITTLE
    H = 1 << HASH_BITS
    stride = 2 if variable else 1  # table words per slot
    inc = spec.strategy.increment
    init_width = spec.initial_width if variable else MAX_WIDTH

    lane = pl.program_id(0) * lanes + jnp.arange(lanes, dtype=jnp.int32)
    n = plt.load(nvalid_ref.at[lane])
    dbase = lane * block
    obase = lane * cap
    tbase = lane * (H * stride)
    zero = jnp.zeros(lanes, jnp.int32)
    put = functools.partial(_put, out_ref, obase, cap, little)

    writer = (zero, zero, zero)
    if variable:
        writer = put(writer, zero + spec.clear_code, init_width, n >= 0)

    def step(i, s):
        writer, prefix, nxt, width, epoch, err, err_code = s
        k = plt.load(data_ref.at[dbase + i]).astype(jnp.int32)
        active = (i < n) & (err == ERR_NONE)
        if variable:
            bad = active & (i > 0) & (k > spec.max_code_value)
            err = jnp.where(bad, ERR_UNEXPECTED_CODE, err)
            err_code = jnp.where(bad, k, err_code)
            active = active & ~bad
        scan = active & (i > 0)
        key = jnp.left_shift(prefix, 8) | k

        def probe(c):
            h, probing, found, val = c
            slot = tbase + h * stride
            e = plt.load(table_ref.at[slot], mask=probing, other=0)
            if variable:
                ep = plt.load(table_ref.at[slot + 1], mask=probing, other=0)
                live = ep == epoch
            else:
                live = e != 0
            match = probing & live & (_shr(e, 12) == key)
            found = found | match
            val = jnp.where(match, e & 0xFFF, val)
            go = probing & live & ~match
            return jnp.where(go, (h + 1) & (H - 1), h), go, found, val

        h, _, found, val = lax.while_loop(
            lambda c: _any(c[1]), probe, (_hash(key), scan, scan & False, zero)
        )
        miss = scan & ~found
        insert = miss if variable else miss & (nxt < MAX_TABLE_SIZE)
        slot = tbase + h * stride
        plt.store(table_ref.at[slot], jnp.left_shift(key, 12) | nxt,
                  mask=insert)
        if variable:
            plt.store(table_ref.at[slot + 1], epoch, mask=insert)
        writer = put(writer, prefix, width, miss)
        new_index = nxt
        nxt = jnp.where(insert, nxt + 1, nxt)
        if variable:
            bump = miss & (new_index == jnp.left_shift(1, width) - inc)
            grow = bump & (width < MAX_WIDTH)
            reset = bump & (width >= MAX_WIDTH)
            writer = put(writer, zero + spec.clear_code, MAX_WIDTH, reset)
            width = jnp.where(grow, width + 1,
                              jnp.where(reset, init_width, width))
            epoch = jnp.where(reset, epoch + 1, epoch)
            nxt = jnp.where(reset, spec.first_free_code, nxt)
        prefix = jnp.where(
            active, jnp.where((i == 0) | miss, k, val), prefix)
        return writer, prefix, nxt, width, epoch, err, err_code

    state = (writer, zero, zero + spec.first_free_code, zero + init_width,
             zero + 1, zero + ERR_NONE, zero)
    writer, prefix, nxt, width, _, err, err_code = lax.fori_loop(
        0, jnp.max(n), step, state)

    nonempty = n > 0
    ok = err == ERR_NONE
    writer = put(writer, prefix, width, ok & nonempty)
    if variable:
        eoi_width = width
        if fix_eoi:
            quirk = (nonempty & (width < MAX_WIDTH)
                     & (nxt == jnp.left_shift(1, width) - inc))
            eoi_width = jnp.where(quirk, width + 1, width)
        writer = put(writer, zero + spec.end_code, eoi_width, ok)
    acc, nbits, pos = writer
    tail = nbits > 0
    byte = acc if little else jnp.left_shift(acc, 8 - nbits)
    plt.store(out_ref.at[obase + jnp.minimum(pos, cap - 1)],
              (byte & 0xFF).astype(jnp.uint8), mask=tail & (pos < cap))
    plt.store(nbytes_ref.at[lane], jnp.where(tail, pos + 1, pos))
    plt.store(err_ref.at[lane], err)
    plt.store(errcode_ref.at[lane], err_code)


@functools.partial(
    jax.jit, static_argnames=("spec", "fix_eoi", "lanes", "interpret"))
def encode_blocks(blocks, n_valid, spec: LzwSpec, fix_eoi: bool = True,
                  lanes: int = LANES, interpret: bool = False):
    """Encode a batch of blocks into bit-packed payloads.

    Args:
      blocks:  u8[N, B] input bytes, zero padded past ``n_valid``.
      n_valid: i32[N] valid leading bytes of each block.
      spec:    static wire format.
      fix_eoi: widen a trailing EOI that lands on a width bump, as
        ``ops.encode.encode_block(fix_eoi_width=True)``.
      lanes:   blocks per program (a power of two).
      interpret: run the kernel in the Pallas interpreter (CPU tests).

    Returns (payload u8[N, packed_bound(B)], n_bytes i32[N], error i32[N],
    error_code i32[N]).
    """
    N, B = blocks.shape
    cap = packed_bound(B, spec)
    Np = -(-N // lanes) * lanes
    blocks = jnp.pad(blocks.astype(jnp.uint8), ((0, Np - N), (0, 0)))
    n_valid = jnp.pad(n_valid.astype(jnp.int32), (0, Np - N))
    words = (1 << HASH_BITS) * (2 if spec.variable else 1)
    table = jnp.zeros(Np * words, jnp.int32)
    kernel = functools.partial(_kernel, spec=spec, block=B, cap=cap,
                               lanes=lanes, fix_eoi=fix_eoi)
    i32 = lambda n: jax.ShapeDtypeStruct((n,), jnp.int32)  # noqa: E731
    out, n_bytes, err, err_code, _ = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((Np * cap,), jnp.uint8), i32(Np),
                   i32(Np), i32(Np), i32(Np * words)),
        grid=(Np // lanes,),
        input_output_aliases={2: 4},
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="lzw_encode_blocks",
    )(blocks.reshape(-1), n_valid, table)
    return out.reshape(Np, cap)[:N], n_bytes[:N], err[:N], err_code[:N]
