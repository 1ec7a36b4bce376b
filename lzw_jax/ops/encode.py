"""Jittable LZW encoder (single block), XLA-portable path.

Data-parallel redesign of the reference's encoder core (`encoder.rs:273-346`
variable, `:618-658` fixed).  Differences from the reference are structural,
not semantic:

* The arena trie (`encoder.rs:58-149`) becomes an **open-addressing hash
  table** over the key ``(prefix_code << 8) | byte`` — flat arrays, no
  pointer chasing, the natural shape for vector hardware.
* Dictionary reset (`encoder.rs:330-333`) is O(1): entries carry an **epoch
  tag** and a reset just bumps the current epoch, implicitly invalidating
  every slot (the reference re-allocates its node vector instead).
* The bit writer is decoupled: the scan emits (code, width) slots — exactly
  two per input byte, width 0 marking an empty slot — and the vectorized
  packer (`lzw_jax.ops.bitpack`) materialises bytes in a second data-parallel
  pass.  This keeps the sequential scan minimal and lets the same scan drive
  any endianness.

The function is pure and vmap-able over blocks; block-parallel encoding just
vmaps it and shards the batch dimension over the device mesh.

Capacity note: the table holds at most 4097 live entries (`encoder.rs:76`);
with ``hash_bits=13`` (8192 slots) the load factor stays at or under 50% even
with a full stale epoch resident, and the probe loop always terminates
because at most 4097 slots can be live in the current epoch.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from lzw_jax.spec import LzwSpec, MAX_TABLE_SIZE, MAX_WIDTH

__all__ = ["encode_block", "encoder_output_slots", "packed_bound"]

# Error kinds reported in the result (host raises the typed exceptions).
ERR_NONE = 0
ERR_UNEXPECTED_CODE = 1


def encoder_output_slots(block_size: int) -> int:
    """Number of (code, width) slots for a block of ``block_size`` bytes.

    Slot layout: [CLEAR] + 2 per byte (miss code, possible reset CLEAR) +
    [final prefix, EOI].  Unused slots have width 0 and are skipped by the
    packer.
    """
    return 2 * block_size + 3


def packed_bound(block_size: int, spec: LzwSpec) -> int:
    """Static worst-case compressed size in bytes for one block."""
    if spec.variable:
        # Worst case: every byte misses at up to 12 bits, plus a CLEAR per
        # table fill (at least 4096 - 2**cs - 2 misses apart), plus leading
        # CLEAR and trailing prefix+EOI.
        resets = block_size // (MAX_TABLE_SIZE - spec.first_free_code) + 1
        bits = MAX_WIDTH * (block_size + resets + 3)
    else:
        bits = MAX_WIDTH * (block_size + 1)
    return (bits + 7) // 8 + 1


def _hash(key, hash_bits: int):
    """Fibonacci hash of the 21-bit (prefix, byte) key into hash_bits bits."""
    h = key.astype(jnp.uint32) * jnp.uint32(2654435761)
    return (h >> jnp.uint32(32 - hash_bits)).astype(jnp.int32)


@functools.partial(
    jax.jit, static_argnames=("spec", "hash_bits", "fix_eoi_width")
)
def encode_block(
    block, n_valid, spec: LzwSpec, hash_bits: int = 13,
    fix_eoi_width: bool = False,
):
    """Encode one block of bytes into (code, width) slots.

    Args:
      block:   u8/i32[B] input bytes, padded past ``n_valid``.
      n_valid: i32 scalar, number of valid leading bytes.
      spec:    static wire-format description.
      hash_bits: static log2 of the dictionary hash-table size.
      fix_eoi_width: when True, widen the trailing EOI code by one bit if the
        decoder-side width bump lands exactly on the final data code — the
        reference's own decoder misreads such streams (see
        ``lzw_jax.ops.reference.eoi_width_quirk``).  False (default) is
        bit-exact with the reference; the block container enables the fix so
        every block is guaranteed decodable.

    Returns dict with:
      codes:  i32[S] code values (S = encoder_output_slots(B)).
      widths: i32[S] bit widths; 0 marks an empty slot.
      error:  i32 error kind (ERR_*).
      error_code / error_pos: i32 diagnostics for the host exception.
    """
    B = block.shape[0]
    H = 1 << hash_bits
    block = block.astype(jnp.int32)

    first_free = spec.first_free_code
    init_width = spec.initial_width
    variable = spec.variable

    def threshold_of(width):
        return (1 << width) - spec.strategy.increment

    def probe(keys, epochs, key, epoch):
        """Find first slot whose entry is absent (stale epoch) or matches."""
        h0 = _hash(key, hash_bits)

        def cond(h):
            live = epochs[h] == epoch
            return live & (keys[h] != key)

        h = jax.lax.while_loop(cond, lambda h: (h + 1) & (H - 1), h0)
        found = (epochs[h] == epoch) & (keys[h] == key)
        return h, found

    def step(state, inputs):
        i, k = inputs
        (keys, epochs, vals, epoch, prefix, next_index, width, err, err_code,
         err_pos) = state

        active = (i < n_valid) & (err == ERR_NONE)
        is_first = i == 0

        bad = active & ~is_first & (k > spec.max_code_value) if variable else False
        if variable:
            err = jnp.where(bad, ERR_UNEXPECTED_CODE, err)
            err_code = jnp.where(bad, k, err_code)
            err_pos = jnp.where(bad, i, err_pos)
            active = active & ~bad

        key = (prefix << 8) | k
        h, found = probe(keys, epochs, key, epoch)
        miss = active & ~is_first & ~found
        hit = active & ~is_first & found

        # Slot 0: the prefix code, emitted on a miss.
        code0 = prefix
        width0 = jnp.where(miss, width, 0)

        # Dictionary insert on miss (fixed flavor freezes at 4096 entries).
        may_insert = miss if variable else miss & (next_index < MAX_TABLE_SIZE)
        keys = keys.at[h].set(jnp.where(may_insert, key, keys[h]))
        epochs = epochs.at[h].set(jnp.where(may_insert, epoch, epochs[h]))
        vals = vals.at[h].set(jnp.where(may_insert, next_index, vals[h]))
        new_index = next_index
        next_index = jnp.where(may_insert, next_index + 1, next_index)

        if variable:
            bump = miss & (new_index == threshold_of(width))
            grow = bump & (width < MAX_WIDTH)
            reset = bump & (width >= MAX_WIDTH)
            # Slot 1: CLEAR at 12 bits when the full table forces a reset.
            code1 = jnp.int32(spec.clear_code)
            width1 = jnp.where(reset, MAX_WIDTH, 0)
            width = jnp.where(grow, width + 1, jnp.where(reset, init_width, width))
            epoch = jnp.where(reset, epoch + 1, epoch)
            next_index = jnp.where(reset, first_free, next_index)
        else:
            code1 = jnp.int32(0)
            width1 = jnp.int32(0)

        prefix = jnp.where(
            active, jnp.where(is_first | miss, k, vals[h]), prefix
        )

        state = (keys, epochs, vals, epoch, prefix, next_index, width, err,
                 err_code, err_pos)
        return state, (code0, width0, code1, width1)

    keys0 = jnp.zeros(H, jnp.int32)
    epochs0 = jnp.zeros(H, jnp.int32)
    vals0 = jnp.zeros(H, jnp.int32)
    state0 = (
        keys0, epochs0, vals0, jnp.int32(1), jnp.int32(0),
        jnp.int32(first_free), jnp.int32(init_width), jnp.int32(ERR_NONE),
        jnp.int32(0), jnp.int32(0),
    )
    idx = jnp.arange(B, dtype=jnp.int32)
    state, (c0, w0, c1, w1) = jax.lax.scan(step, state0, (idx, block))
    (_, _, _, _, prefix, _, width, err, err_code, err_pos) = state

    body_codes = jnp.stack([c0, c1], axis=1).reshape(-1)
    body_widths = jnp.stack([w0, w1], axis=1).reshape(-1)

    nonempty = n_valid > 0
    ok = err == ERR_NONE
    if variable:
        (_, _, _, _, _, next_index, _, _, _, _) = state
        eoi_width = width
        if fix_eoi_width:
            quirk = (
                nonempty
                & (next_index == threshold_of(width))
                & (width < MAX_WIDTH)
            )
            eoi_width = jnp.where(quirk, width + 1, width)
        head_codes = jnp.array([spec.clear_code], jnp.int32)
        head_widths = jnp.where(ok, init_width, 0)[None]
        tail_codes = jnp.array([0, spec.end_code], jnp.int32).at[0].set(prefix)
        tail_widths = jnp.stack(
            [jnp.where(ok & nonempty, width, 0), jnp.where(ok, eoi_width, 0)]
        )
        codes = jnp.concatenate([head_codes, body_codes, tail_codes])
        widths = jnp.concatenate([head_widths, body_widths, tail_widths])
    else:
        tail_codes = prefix[None]
        tail_widths = jnp.where(ok & nonempty, MAX_WIDTH, 0)[None]
        pad = jnp.zeros(2, jnp.int32)  # keep S uniform across flavors
        codes = jnp.concatenate([body_codes, tail_codes, pad])
        widths = jnp.concatenate([body_widths, tail_widths, pad])

    return {
        "codes": codes,
        "widths": widths,
        "error": err,
        "error_code": err_code,
        "error_pos": err_pos,
    }
