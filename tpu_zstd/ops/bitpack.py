"""Vectorized bit deposit: pack variable-width bit fields into a u32 word stream.

Data-parallel replacement for the reference's sequential GPU bitstream writer
(reference src/gpu_bitstream.cuh:14-50 `BIT_CStream_t`): instead of a serial
LSB-first append loop, every field's absolute bit offset is computed with one
prefix sum and all fields are deposited in parallel with two scatter-adds
(contributions to the same word occupy disjoint bit ranges, so integer add is
equivalent to bitwise OR).

All functions are jittable and shape-static.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

U32 = jnp.uint32


def deposit_bits(values: jax.Array, lengths: jax.Array, num_words: int) -> tuple[jax.Array, jax.Array]:
    """Pack bit fields LSB-first at consecutive bit offsets.

    values:  (M,) uint32 field values (only the low `lengths[i]` bits are used)
    lengths: (M,) int32 bit widths (0 <= length <= 32; 0 means "no field")
    num_words: size of the output u32 word buffer (static)

    Returns (words[num_words] uint32, total_bits int32). Field i lands at bit
    offset sum(lengths[:i]) of the stream; byte j of the stream is
    (words[j//4] >> (8*(j%4))) & 0xFF.
    """
    lengths = lengths.astype(jnp.int32)
    offs = jnp.cumsum(lengths) - lengths  # exclusive prefix sum
    total_bits = offs[-1] + lengths[-1]

    if values.shape[0] >= 4096:
        # Large deposits: tree-concatenation path (no scatters).
        return deposit_bits_tree(values, lengths, num_words)

    mask = jnp.where(
        lengths >= 32,
        U32(0xFFFFFFFF),
        (U32(1) << jnp.minimum(lengths, 31).astype(U32)) - U32(1),
    )
    v = values.astype(U32) & mask

    word = offs >> 5
    sh = (offs & 31).astype(U32)
    lo = v << sh
    # High spill into the next word; shift by (32 - sh) is undefined at sh==0,
    # so split the shift into two well-defined halves.
    hi = (v >> U32(1)) >> (U32(31) - sh)

    # Drop zero-length fields entirely (their offset may alias a real field).
    live = lengths > 0
    word = jnp.where(live, word, num_words)  # out of range -> dropped
    words = jnp.zeros(num_words, dtype=U32)
    words = words.at[word].add(lo, mode="drop")
    words = words.at[word + 1].add(hi, mode="drop")
    return words, total_bits


def deposit_bits_at(
    values: jax.Array, lengths: jax.Array, offsets: jax.Array, num_words: int
) -> jax.Array:
    """Like deposit_bits but with caller-provided absolute bit offsets.

    Field bit ranges must be disjoint (add == or). Used to deposit several
    independent bitstreams (e.g. the 4 Huffman literal streams) into one word
    buffer in a single scatter pass.
    """
    lengths = lengths.astype(jnp.int32)
    offsets = offsets.astype(jnp.int32)
    mask = jnp.where(
        lengths >= 32,
        U32(0xFFFFFFFF),
        (U32(1) << jnp.minimum(lengths, 31).astype(U32)) - U32(1),
    )
    v = values.astype(U32) & mask
    word = offsets >> 5
    sh = (offsets & 31).astype(U32)
    lo = v << sh
    hi = (v >> U32(1)) >> (U32(31) - sh)
    live = lengths > 0
    word = jnp.where(live, word, num_words)
    words = jnp.zeros(num_words, dtype=U32)
    words = words.at[word].add(lo, mode="drop")
    words = words.at[word + 1].add(hi, mode="drop")
    return words


def deposit_bits_at_sorted(
    values: jax.Array, lengths: jax.Array, offsets: jax.Array, num_words: int
) -> jax.Array:
    """deposit_bits_at via sort + segmented sum instead of scatter-add.

    Routes the word contributions through two sorts so the final scatter
    writes one row per OUTPUT word (num_words) instead of one per
    contribution (2x field count): sort contributions by word, prefix-sum,
    keep each word's last row (segment tail), compact tails to the front, and
    difference adjacent tail prefix sums. u32 wraparound cancels in the
    difference; per-word sums are exact (disjoint bit ranges).
    """
    M = values.shape[0]
    lengths = lengths.astype(jnp.int32)
    offsets = offsets.astype(jnp.int32)
    mask = jnp.where(
        lengths >= 32,
        U32(0xFFFFFFFF),
        (U32(1) << jnp.minimum(lengths, 31).astype(U32)) - U32(1),
    )
    v = values.astype(U32) & mask
    word = offsets >> 5
    sh = (offsets & 31).astype(U32)
    lo = v << sh
    hi = (v >> U32(1)) >> (U32(31) - sh)
    live = lengths > 0
    BIG = jnp.int32(num_words + 1)
    w2 = jnp.concatenate([jnp.where(live, word, BIG), jnp.where(live, word + 1, BIG)])
    c2 = jnp.concatenate([lo, hi]).astype(U32)

    sw, sc = jax.lax.sort((w2, c2.astype(jnp.int32)), num_keys=1, is_stable=False)
    csum = jnp.cumsum(sc.astype(U32))
    nxt = jnp.concatenate([sw[1:], jnp.full((1,), -1, jnp.int32)])
    tail = (sw != nxt) & (sw < BIG)
    rank = jnp.arange(2 * M, dtype=jnp.int32)
    key = jnp.where(tail, rank, jnp.int32(2 * M))
    sk, tw, tc = jax.lax.sort((key, sw, csum.astype(jnp.int32)), num_keys=1, is_stable=True)
    K = min(num_words + 1, 2 * M)
    live_t = sk[:K] < jnp.int32(2 * M)  # rows past the real tails carry garbage
    tw = tw[:K]
    tc = tc[:K].astype(U32)
    totals = tc - jnp.roll(tc, 1).at[0].set(U32(0))
    words = jnp.zeros(num_words, dtype=U32)
    idx = jnp.where(live_t & (tw < num_words), tw, num_words)
    return words.at[idx].add(totals, mode="drop")


def deposit_bits_tree(
    values: jax.Array,
    lengths: jax.Array,
    num_words: int,
    max_field_bits: int = 32,
) -> tuple[jax.Array, jax.Array]:
    """deposit_bits via pairwise tree concatenation — no sorts, no scatters.

    Treats each field as a 1-word bitstream segment and merges adjacent
    segments level by level: B is bit-shifted into place after A with an
    elementwise variable shift plus a log2 static word-roll (`dynroll`).
    All work is elementwise selects/shifts over static shapes.

    Level-k segments hold at most 2^k * max_field_bits bits, clamped to the
    output capacity, which keeps per-level work ~linear in num_words.
    Returns (words[num_words] uint32, total_bits).
    """
    M = values.shape[0]
    lengths = lengths.astype(jnp.int32)
    total_bits = jnp.sum(lengths)
    mask = jnp.where(
        lengths >= 32,
        U32(0xFFFFFFFF),
        (U32(1) << jnp.minimum(lengths, 31).astype(U32)) - U32(1),
    )
    v = values.astype(U32) & mask

    words = v[:, None]  # (segments, width)
    lens = lengths
    width = 1
    cap_bits = max_field_bits
    while words.shape[0] > 1:
        if words.shape[0] % 2:
            # Odd segment counts pad with one empty segment per level instead
            # of rounding the leaf count to a power of two up front — a batch
            # bucket just past a 2^k/3 boundary would otherwise DOUBLE the
            # whole tree (bucket 20480 -> 24576 would cross the
            # 65536 -> 131072 leaf cliff).
            words = jnp.pad(words, ((0, 1), (0, 0)))
            lens = jnp.pad(lens, (0, 1))
        segs = words.shape[0] // 2
        cap_bits = min(2 * cap_bits, num_words * 32)
        new_width = min(-(-cap_bits // 32), num_words)
        A, B = words[0::2], words[1::2]
        La, Lb = lens[0::2], lens[1::2]
        s = (La & 31).astype(U32)[:, None]
        ws = La >> 5  # word offset of B within the merged segment
        # Bit-shift B left by s across words (little-endian).
        Bprev = jnp.pad(B, ((0, 0), (1, 0)))[:, :-1]
        Bs = (B << s) | ((Bprev >> U32(1)) >> (U32(31) - s))
        spill = (B[:, -1:] >> U32(1)) >> (U32(31) - s)  # top-word overflow
        Bs = jnp.concatenate([Bs, spill], axis=1)
        pad_to = lambda x: (
            jnp.pad(x, ((0, 0), (0, new_width - x.shape[1])))
            if x.shape[1] < new_width
            else x[:, :new_width]
        )
        words = pad_to(A) + dynroll(pad_to(Bs), ws[:, None], width)
        lens = La + Lb
        width = new_width
    out = words[0]
    if out.shape[0] < num_words:
        out = jnp.pad(out, (0, num_words - out.shape[0]))
    return out, total_bits


def shift_words(words: jax.Array, bit_offset: jax.Array, out_words: int) -> jax.Array:
    """Place a little-endian u32 word bitstream at an absolute bit offset.

    Returns an (out_words,) buffer with the input stream shifted to start at
    `bit_offset`; summing disjoint placements composes streams (elementwise
    shift + static word-roll — no scatter). The caller guarantees the content
    fits: bit_offset + content bits <= 32 * out_words.
    """
    bit_offset = jnp.asarray(bit_offset, jnp.int32)
    s = (bit_offset & 31).astype(U32)
    ws = bit_offset >> 5
    w = words.astype(U32)
    prev = jnp.pad(w, (1, 0))[:-1]
    shifted = (w << s) | ((prev >> U32(1)) >> (U32(31) - s))
    spill = (w[-1:] >> U32(1)) >> (U32(31) - s)
    shifted = jnp.concatenate([shifted, spill])
    n = shifted.shape[0]
    if n < out_words:
        shifted = jnp.pad(shifted, (0, out_words - n))
    elif n > out_words:
        shifted = shifted[:out_words]
    return dynroll(shifted, ws, out_words)


def words_to_bytes(words: jax.Array) -> jax.Array:
    """u32 word stream -> little-endian byte stream (4x length, uint8)."""
    w = words[:, None]
    shifts = jnp.arange(4, dtype=U32) * U32(8)
    b = (w >> shifts[None, :]) & U32(0xFF)
    return b.reshape(-1).astype(jnp.uint8)


def dynroll(x: jax.Array, shift: jax.Array, max_shift: int) -> jax.Array:
    """Right-roll the last axis by a traced shift in [0, max_shift].

    Decomposes into log2(max_shift) static rolls + selects: under vmap that
    stays elementwise work, whereas jnp.roll / dynamic_update_slice with
    per-row offsets lower to gathers/scatters.
    """
    shift = jnp.asarray(shift, jnp.int32)
    for b in range(max(1, max_shift).bit_length()):
        x = jnp.where((shift >> b) & 1 != 0, jnp.roll(x, 1 << b, axis=-1), x)
    return x


def dynroll_left(x: jax.Array, shift: jax.Array, max_shift: int) -> jax.Array:
    """Left-roll the last axis by a traced shift in [0, max_shift]."""
    n = x.shape[-1]
    return dynroll(x, (n - jnp.asarray(shift, jnp.int32)) % n, n)


def place(x: jax.Array, length: jax.Array, offset: jax.Array, out_len: int, max_offset: int) -> jax.Array:
    """Mask x beyond `length`, zero-extend/trim to out_len, roll right by
    `offset`. Sum of disjoint `place` results == sequential buffer writes."""
    n = x.shape[-1]
    idx = jnp.arange(n, dtype=jnp.int32)
    xm = jnp.where(idx < length, x, jnp.zeros((), x.dtype))
    if n < out_len:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, out_len - n)]
        xm = jnp.pad(xm, pad)
    elif n > out_len:
        xm = xm[..., :out_len]
    return dynroll(xm, offset, max_offset)
