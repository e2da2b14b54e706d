"""Data-parallel LZ77 match finding + greedy parse for one block (v2).

Re-design of the reference's per-thread hash-chain kernels
(reference src/lz77_parallel.cu:26 `find_matches_kernel` — atomicExch hash-table
inserts + bounded chain walks; :177 `greedy_parse_kernel`; :207
`build_sequences_gpu_kernel`) without atomics or hash tables. The design
dates from a machine whose sorts were much faster than its element gathers,
so the pipeline is built around sorts that CARRY payloads and scans over the
static axis, with only small compaction scatters (whether a hash table built
with scatters wins on the GPU is not measured):

- previous-occurrence search: stable sort of (hash, pos, w0..w7) — the suffix's
  first 32 bytes ride through the sort, so depth-D chain candidates are the D
  preceding sorted rows and match lengths are XOR compares of shifted operands
  (zero gathers).
- back to position order: a second sort keyed by position (cheaper than an
  N-element scatter).
- greedy parse: matches are truncated at SEG-byte boundaries, making segments
  independent; one walk over the SEG axis (a Pallas kernel on the GPU,
  ops/pallas_greedy.py; a lax.scan elsewhere) reproduces the sequential
  greedy walk exactly. Literal coverage falls out of the same walk.
- sequence extraction / literal compaction: compaction-via-sort (key pushes
  non-selected rows to the end).
- long matches: contiguous same-offset sequences merged with a segmented sum
  (recovers matches beyond the compare cap and across segment boundaries).
- repcodes: rep0 reuse detected with a shift (see format/sequences.py
  encode_offset for the host-side full-history rule).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import platform

I32 = jnp.int32
U32 = jnp.uint32

HASH_PRIME = 2654435761
SEG_LOG = 10  # default greedy-parse segment (1 KB; see PipelineConfig.seg_log)
SEG = 1 << SEG_LOG


def _sort_unique(key: jax.Array, *pays: jax.Array) -> tuple[jax.Array, ...]:
    """Ascending sort of 1-D ops by a UNIQUE key (XLA's sort)."""
    return jax.lax.sort((key, *pays), num_keys=1, is_stable=False)


class BlockSequences(NamedTuple):
    """Fixed-capacity per-block parse result (entries >= nseq are zero)."""

    ll: jax.Array        # (MS,) int32 literal lengths
    ml: jax.Array        # (MS,) int32 match lengths (>= min_match)
    ob: jax.Array        # (MS,) int32 offset-base values (off+3 or repcode 1)
    off: jax.Array       # (MS,) int32 RESOLVED offsets (decoder checkpoints)
    starts: jax.Array    # (MS,) int32 match start positions
    nseq: jax.Array      # () int32
    lits: jax.Array      # (N,) uint8 literal bytes, compacted to the front
    nlit: jax.Array      # () int32 total literal count (== n - sum(ml))


def _hash_words(
    block: jax.Array, hash_log: int, min_match: int = 4
) -> tuple[jax.Array, jax.Array]:
    """4-byte words + Fibonacci hashes per position.

    min_match == 3 hashes only the low 3 bytes (reference hash fn
    lz77_parallel.h:20-23 `(b0<<16|b1<<8|b2) * 2654435761`), so chain
    candidates agree on 3 bytes and 3-byte matches become findable — the
    reference uses min_match 3 at every level (types.cpp:883-947)."""
    b = block.astype(U32)
    w = (
        b
        | (jnp.roll(b, -1) << U32(8))
        | (jnp.roll(b, -2) << U32(16))
        | (jnp.roll(b, -3) << U32(24))
    )
    hw = (w & U32(0xFFFFFF)) if min_match == 3 else w
    h = (hw * U32(HASH_PRIME)) >> U32(32 - hash_log)
    return w, h.astype(I32)


def _word_inc(x: jax.Array) -> jax.Array:
    """Matched byte count (0..4) from the XOR of two 4-byte LE words."""
    return jnp.where(
        x == 0,
        4,
        ((x & U32(0xFF)) == 0).astype(I32)
        + ((x & U32(0xFFFF)) == 0).astype(I32)
        + ((x & U32(0xFFFFFF)) == 0).astype(I32),
    )


def find_matches(
    block: jax.Array,
    n: jax.Array,
    *,
    hash_log: int,
    depth: int,
    cap: int,
    win_start: jax.Array | int = 0,
    mf_win_log: int = 0,
    sample_log: int = 0,
    two_band: bool = False,
    min_match: int = 4,
) -> tuple[jax.Array, ...]:
    """Best (capped) match per position: returns (best_ml, best_off), pos order.

    two_band=True additionally returns (ml2, off2): the best candidate at a
    NEAR offset (< 512 bytes). The optimal-parse DP prices offsets by their
    real bit cost, and a shorter-but-closer candidate often beats the longest
    match — information a single best-candidate stream cannot carry
    (the reference's binary-tree search keeps multiple candidates live the
    same way, cuda_zstd_lz77.cu:555).

    sample_log > 0 (windowed mode only): only every 2^sample_log-th position
    participates — sort rows shrink by the same factor (libzstd's fast-level
    acceleration step; matches can then only start at, and reference, sampled
    positions; unsampled positions fall out as literals).

    Ties prefer the smallest offset (the most recent previous occurrence),
    which keeps offsets repcode-friendly and lets the merge pass re-join
    truncated long matches. Positions in [win_start, n) participate as match
    sources/targets (win_start > 0 marks a dictionary-window prefix; bytes
    before it are padding and must never be referenced).

    mf_win_log > 0 restricts candidate SEARCH to 2^mf_win_log-byte windows:
    the block reshapes to (nwin, W) and every sort runs along the short axis.
    Match CONTENT still extends past window ends (words are computed on the
    full block before reshaping); only the candidate set is window-local.
    """
    N = block.shape[0]
    nwords = cap // 4
    pos = jnp.arange(N, dtype=I32)
    w, h = _hash_words(block, hash_log, min_match)
    live = (pos < n - (min_match - 1)) & (pos >= win_start)
    words = [jnp.roll(w, -4 * k).astype(I32) for k in range(nwords)]

    windowed = 0 < mf_win_log < max(1, (N - 1).bit_length()) and N % (1 << mf_win_log) == 0
    SS = 1 << sample_log if (sample_log > 0 and windowed) else 1
    pb = None
    if windowed:
        W = 1 << mf_win_log
        shape = (N // W, W // SS)
        h = h.reshape(N // W, W)[:, ::SS]
        live = live.reshape(N // W, W)[:, ::SS]
        words = [x.reshape(N // W, W)[:, ::SS] for x in words]
        if SS > 1:
            # Left-extension operand: the byte PRECEDING each sampled
            # position (sentinel 256 at position 0). A candidate pair whose
            # preceding bytes also match extends the match one byte left —
            # recovering most matches that start at unsampled positions
            # (libzstd's acceleration step simply loses them).
            pb = jnp.roll(block.astype(I32), 1).at[0].set(256)
            pb = pb.reshape(N // W, W)[:, ::SS]
        pos_axis = jnp.arange(W // SS, dtype=I32)
        plog = mf_win_log - sample_log if SS > 1 else mf_win_log
    else:
        shape = (N,)
        pos_axis = pos
        plog = max(1, (N - 1).bit_length())

    # Sort positions by (hash, pos). Both orderings are total, so the sort can
    # be UNSTABLE (a stable XLA sort appends a hidden iota tiebreak operand).
    # When hash+pos fit u32 they ride one packed key; dead rows get a
    # sentinel hash of 2^hash_log, keeping their pos order (the position-
    # restore sort then maps row r -> position r for every row). Dead rows may
    # still pair as chain candidates — the n-sp clamp below caps any such
    # match under min_match.
    lpos = jnp.broadcast_to(pos_axis, shape)
    extra = [pb] if pb is not None else []
    if hash_log + 1 + plog <= 32:
        key = ((jnp.where(live, h, 1 << hash_log).astype(U32)) << plog) | lpos.astype(U32)
        sorted_ops = jax.lax.sort(
            tuple([key] + words + extra), num_keys=1, is_stable=False
        )
        sk = (sorted_ops[0] >> plog).astype(I32)
        sp = (sorted_ops[0] & ((1 << plog) - 1)).astype(I32)
        sw = sorted_ops[1 : 1 + nwords]
    else:
        key = jnp.where(live, h, 1 << hash_log)
        sorted_ops = jax.lax.sort(
            tuple([key, lpos] + words + extra, ), num_keys=2, is_stable=False
        )
        sk, sp = sorted_ops[0], sorted_ops[1]
        sw = sorted_ops[2 : 2 + nwords]
    spb = sorted_ops[-1] if pb is not None else None

    # Select-based edge fill: .at[:, :d].set(fill) lowers to dynamic-update-
    # slices; iota-compare + where fuses elementwise.
    edge_idx = jax.lax.broadcasted_iota(I32, shape, len(shape) - 1)

    def _prev(x, d, fill):
        r = jnp.roll(x, d, axis=-1)
        return jnp.where(edge_idx < d, fill, r)

    best_ml = jnp.zeros(shape, dtype=I32)
    best_off = jnp.zeros(shape, dtype=I32)
    best_ext = jnp.zeros(shape, dtype=bool) if pb is not None else None
    if two_band:
        assert SS == 1, "two_band requires unsampled search"
        best_ml2 = jnp.zeros(shape, dtype=I32)
        best_off2 = jnp.zeros(shape, dtype=I32)
    for d in range(1, depth + 1):
        same = _prev(sk, d, -1) == sk
        pp = _prev(sp, d, 0)
        ml = jnp.zeros(shape, dtype=I32)
        alive = same
        for k in range(nwords):
            x = sw[k].astype(U32) ^ _prev(sw[k], d, 0).astype(U32)
            inc = _word_inc(x)
            ml = ml + jnp.where(alive, inc, 0)
            alive = alive & (x == 0)
        better = ml > best_ml
        best_ml = jnp.where(better, ml, best_ml)
        best_off = jnp.where(better, sp - pp, best_off)
        if two_band:
            near = (sp - pp) < 512
            better2 = near & (ml > best_ml2)
            best_ml2 = jnp.where(better2, ml, best_ml2)
            best_off2 = jnp.where(better2, sp - pp, best_off2)
        if best_ext is not None:
            ext_d = same & (spb == _prev(spb, d, -2))
            best_ext = jnp.where(better, ext_d, best_ext)

    # Clamp to block end (also cancels false matches into rolled-around words).
    if windowed:
        gsp = sp * SS + (jnp.arange(N // (1 << mf_win_log), dtype=I32) << mf_win_log)[:, None]
    else:
        gsp = sp
    best_ml = jnp.minimum(best_ml, jnp.maximum(n - gsp, 0))
    if two_band:
        best_ml2 = jnp.minimum(best_ml2, jnp.maximum(n - gsp, 0))
    if SS > 1:
        best_off = best_off * SS  # sampled-index delta -> byte offset

    # Return to position order by sorting on position. In windowed mode the
    # whole row — sp | ext | ml | off — packs into ONE 31-bit sort key (sp in
    # the top bits, so ordering is unchanged), removing the payload operand
    # from the restore sort entirely. Fallback: packed payload beside the key.
    mlb = max(4, cap.bit_length())  # ml field width
    eb = 1 if best_ext is not None else 0
    low_bits = mf_win_log + mlb + eb if windowed else 99
    if windowed and plog + low_bits <= 31:
        key2 = (sp << low_bits) | (best_ml << mf_win_log) | best_off
        if best_ext is not None:
            key2 = key2 | (best_ext.astype(I32) << (mf_win_log + mlb))
        if two_band:
            packed2 = (best_ml2 << 9) | best_off2
            skey, opk2 = jax.lax.sort((key2, packed2), num_keys=1, is_stable=False)
            skey = skey.reshape(-1)
            opk2 = opk2.reshape(-1)
            return (
                (skey >> mf_win_log) & ((1 << mlb) - 1),
                skey & ((1 << mf_win_log) - 1),
                opk2 >> 9, opk2 & ((1 << 9) - 1),
            )
        (opk,) = jax.lax.sort((key2,), num_keys=1, is_stable=False)
        if SS > 1:
            nwin = shape[0]
            mlv = (opk >> mf_win_log) & ((1 << mlb) - 1)
            offv = opk & ((1 << mf_win_log) - 1)
            extv = (opk >> (mf_win_log + mlb)) & 1
            full = jnp.zeros((nwin, (1 << mf_win_log) // SS, SS), I32)
            ml_f = full.at[:, :, 0].set(mlv).reshape(-1)
            off_f = full.at[:, :, 0].set(offv).reshape(-1)
            ext_f = full.at[:, :, 0].set(extv).reshape(-1)
            nx_ml = jnp.roll(ml_f, -1)
            nx_off = jnp.roll(off_f, -1)
            take = (jnp.roll(ext_f, -1) > 0) & (nx_ml > 0) & (ml_f == 0)
            ml_f = jnp.where(take, jnp.minimum(nx_ml + 1, jnp.maximum(n - pos, 0)), ml_f)
            off_f = jnp.where(take, nx_off, off_f)
            return ml_f, off_f
        opk = opk.reshape(-1)
        return (opk >> mf_win_log) & ((1 << mlb) - 1), opk & ((1 << mf_win_log) - 1)
    assert cap < (1 << 11)  # ml field: 11 bits above the 20-bit offset
    packed = (best_ml << 20) | best_off
    if best_ext is not None:
        assert cap < (1 << 6)  # leave bit 26 for the left-extension flag
        packed = packed | (best_ext.astype(I32) << 26)
    if two_band:
        packed2 = (best_ml2 << 9) | best_off2
        _, opk, opk2 = jax.lax.sort((sp, packed, packed2), num_keys=1, is_stable=False)
        opk = opk.reshape(-1)
        opk2 = opk2.reshape(-1)
        return (
            opk >> 20, opk & ((1 << 20) - 1),
            opk2 >> 9, opk2 & ((1 << 9) - 1),
        )
    _, opk = jax.lax.sort((sp, packed), num_keys=1, is_stable=False)
    if SS > 1:
        nwin = shape[0]
        mlv = (opk >> 20) & 63
        offv = opk & ((1 << 20) - 1)
        extv = opk >> 26
        full = jnp.zeros((nwin, (1 << mf_win_log) // SS, SS), I32)
        ml_f = full.at[:, :, 0].set(mlv).reshape(-1)
        off_f = full.at[:, :, 0].set(offv).reshape(-1)
        ext_f = full.at[:, :, 0].set(extv).reshape(-1)
        # Left-extension fill: unsampled position q takes (ml+1, off) from
        # its sampled successor p = q+1 when p's winning candidate also
        # matched one byte left. (The roll wraps position 0's flag to N-1,
        # where the n-pos clamp already kills any match.)
        nx_ml = jnp.roll(ml_f, -1)
        nx_off = jnp.roll(off_f, -1)
        take = (jnp.roll(ext_f, -1) > 0) & (nx_ml > 0) & (ml_f == 0)
        ml_f = jnp.where(take, jnp.minimum(nx_ml + 1, jnp.maximum(n - pos, 0)), ml_f)
        off_f = jnp.where(take, nx_off, off_f)
        return ml_f, off_f
    return opk.reshape(-1) >> 20, opk.reshape(-1) & ((1 << 20) - 1)


LDM_MIN = 16  # long-range matches must cover the 16-byte verification span


def find_matches_long(
    block: jax.Array,
    n: jax.Array,
    *,
    hash_log2: int = 16,
    sample_log: int = 2,
    depth: int = 2,
    win_start: jax.Array | int = 0,
    nwords: int = 4,
) -> tuple[jax.Array, jax.Array]:
    """Sampled whole-block long-range match candidates (LDM).

    Counterpart of the reference's long-distance matcher
    (reference src/ldm_implementation.cu:67-170, include/cuda_zstd_ldm.h:
    rolling-hash table over a large window, min-match 64): positions are
    SAMPLED every 2^sample_log bytes and hashed over 8 bytes, so the sort
    runs over N/2^sample_log rows — reach beyond the windowed matcher's
    2^mf_win_log candidate horizon at ~1/4 of its sort cost. Matches verify
    against 16 carried bytes (hash collisions cannot fabricate a match) and
    merge-extension re-joins same-offset continuations, so the 16-byte cap
    costs little on genuinely long matches.

    Returns (ml, off) full-length arrays (zeros at unsampled positions).
    """
    N = block.shape[0]
    SS = 1 << sample_log
    P = N // SS
    b = block.astype(U32)
    w = (
        b
        | (jnp.roll(b, -1) << U32(8))
        | (jnp.roll(b, -2) << U32(16))
        | (jnp.roll(b, -3) << U32(24))
    )
    pos = jnp.arange(N, dtype=I32)
    plog = max(1, (P - 1).bit_length())
    # 8-byte hash at sampled positions; 4*nwords carried bytes verify and
    # measure the match (lengths cap at 4*nwords; the merge pass extends).
    ws = [jnp.roll(w, -4 * k)[::SS] for k in range(nwords)]
    h2 = (
        ((ws[0] * U32(HASH_PRIME)) ^ (ws[1] * U32(0x85EBCA77)))
        >> U32(32 - hash_log2)
    )
    spos = pos[::SS]
    live = (spos < n - (LDM_MIN + 3)) & (spos >= win_start)
    idx = jnp.arange(P, dtype=U32)
    if hash_log2 + 1 + plog <= 32:
        key = (jnp.where(live, h2, U32(1) << hash_log2) << plog) | idx
        sorted_ops = jax.lax.sort(
            tuple([key] + [x.astype(I32) for x in ws]), num_keys=1, is_stable=False
        )
        sk = (sorted_ops[0] >> plog).astype(I32)
        sp = (sorted_ops[0] & ((1 << plog) - 1)).astype(I32)
        sw = sorted_ops[1:]
    else:
        # Large windows (256 KB+ LDM reach): the packed key would squeeze the
        # hash below ~15 bits and drown the chain in collisions — sort with
        # (hash, idx) as two keys instead.
        key = jnp.where(live, h2, U32(1) << hash_log2)
        sorted_ops = jax.lax.sort(
            tuple([key, idx] + [x.astype(I32) for x in ws]),
            num_keys=2, is_stable=False,
        )
        sk = sorted_ops[0].astype(I32)
        sp = sorted_ops[1].astype(I32)
        sw = sorted_ops[2:]

    edge = jnp.arange(P, dtype=I32)

    def _prev(x, d, fill):
        r = jnp.roll(x, d)
        return jnp.where(edge < d, fill, r)

    best_ml = jnp.zeros(P, I32)
    best_di = jnp.zeros(P, I32)
    for d in range(1, depth + 1):
        same = _prev(sk, d, -1) == sk
        pp = _prev(sp, d, 0)
        ml = jnp.zeros(P, I32)
        alive = same
        for k in range(nwords):
            x = sw[k].astype(U32) ^ _prev(sw[k], d, 0).astype(U32)
            inc = _word_inc(x)
            ml = ml + jnp.where(alive, inc, 0)
            alive = alive & (x == 0)
        ok = ml >= LDM_MIN
        better = ok & (ml > best_ml)
        best_ml = jnp.where(better, ml, best_ml)
        best_di = jnp.where(better, sp - pp, best_di)

    # Back to position order: pack ml (<= 4*nwords: 6 bits at 8) above the
    # index delta.
    packed = (best_ml << plog) | best_di
    _, opk = jax.lax.sort((sp, packed), num_keys=1, is_stable=False)
    s_ml = opk >> plog
    s_off = (opk & ((1 << plog) - 1)) * SS
    s_ml = jnp.minimum(s_ml, jnp.maximum(n - spos, 0))
    # Spread to full position arrays (zeros at unsampled positions).
    full_ml = jnp.zeros((P, SS), I32).at[:, 0].set(s_ml).reshape(-1)
    full_off = jnp.zeros((P, SS), I32).at[:, 0].set(s_off).reshape(-1)
    return full_ml, full_off


def greedy_scan(packed: jax.Array) -> jax.Array:
    """Greedy walk over (S, seg) packed segments as one lax.scan: the plain
    reference for ops/pallas_greedy.py and the CPU path.

    packed: step | matched << 16 | defer << 17 per position.
    Returns (S, seg) uint8 of take | is_lit << 1.
    """
    S, seg = packed.shape
    x_t = packed.T  # (seg, S)

    def body(carry, xs):
        na, me = carry                       # next-allowed, match-end (per segment)
        p, x = xs
        stp = x & 0xFFFF
        m = ((x >> 16) & 1) == 1
        d = ((x >> 17) & 1) == 1
        is_pp = na == p
        take = is_pp & m & ~d
        adv = jnp.where(take, stp, 1)
        new_me = jnp.where(take, p + stp, me)
        new_na = jnp.where(is_pp, p + adv, na)
        is_lit = p >= new_me
        out = take.astype(I32) + jnp.where(is_lit, 2, 0)
        return (new_na, new_me), out.astype(jnp.uint8)

    p_idx = jnp.arange(seg, dtype=I32)
    init = (jnp.zeros(S, I32), jnp.zeros(S, I32))
    _, out_t = jax.lax.scan(body, init, (p_idx, x_t))
    return out_t.T


def greedy_parse(
    step: jax.Array, matched: jax.Array, defer: jax.Array | None = None, seg: int = SEG
) -> tuple[jax.Array, jax.Array]:
    """Exact greedy (optionally 1-step lazy) parse via one walk over
    segment-local position index.

    step[i]: parse advance at i (match length if taken, else 1), already
    truncated so i + step[i] never crosses a `seg` boundary (the walk length
    is `seg`; truncated long matches are re-joined by the same-offset merge
    pass). defer[i]: lazy hint — True when position i+1 has a strictly better
    match, so the parse emits a literal at i instead (reference lazy
    strategy, src/lz77_parallel.cu / host format/lz77.py lazy=1).
    Returns (is_seq (N,), is_lit (N,)) in position order.
    """
    from .pallas_greedy import UNROLL, greedy_walk

    N = step.shape[0]
    d = jnp.zeros_like(step) if defer is None else defer.astype(I32)
    packed = (step | (matched.astype(I32) << 16) | (d << 17)).reshape(N // seg, seg)
    if platform.use_gpu_kernels() and seg % UNROLL == 0:
        out = greedy_walk(packed)
    else:
        out = greedy_scan(packed)
    out = out.reshape(-1)
    return (out & 1) == 1, (out & 2) == 2


def _concat_rows(rows, first, counts, out_len: int):
    """Concatenate rows[w, first[w] : first[w] + counts[w]] over windows w
    into one zero-padded (out_len,) vector with a single gather.

    Output position k belongs to the last window whose exclusive start
    offset is <= k (found by a scatter of window starts and a prefix sum:
    empty windows share their successor's start and drop out)."""
    from .scanops import cumsum_i32

    nwin, W = rows.shape
    start = jnp.cumsum(counts) - counts
    total = start[-1] + counts[-1]
    mark = jnp.zeros((out_len,), I32).at[start].add(1, mode="drop")
    widx = jnp.clip(cumsum_i32(mark) - 1, 0, nwin - 1)
    k = jnp.arange(out_len, dtype=I32)
    src = widx * W + jnp.take(first, widx) + k - jnp.take(start, widx)
    vals = jnp.take(rows.reshape(-1), jnp.clip(src, 0, nwin * W - 1))
    return jnp.where(k < total, vals, 0)


def _concat_windows(e_key_w, e_pk_w, nseq_w, nlit_w, max_seqs: int):
    """Per-window compaction-sort output -> block-wide (lits, starts, pk).

    Each sorted window row holds its sequence rows at [0, nseq_w) (key =
    window-local start, payload ml << 21 | off) and its literal bytes at
    [nseq_w, nseq_w + nlit_w)."""
    nwin, W = e_key_w.shape
    base = (jnp.arange(nwin, dtype=I32) * W)[:, None]
    zero_w = jnp.zeros((nwin,), I32)
    lits = _concat_rows(e_pk_w & 0xFF, nseq_w, nlit_w, nwin * W).astype(jnp.uint8)
    starts = _concat_rows(e_key_w + base, zero_w, nseq_w, max_seqs)
    pk = _concat_rows(e_pk_w, zero_w, nseq_w, max_seqs)
    return lits, starts, pk


def parse_block(
    block: jax.Array,
    n: jax.Array,
    *,
    max_seqs: int,
    hash_log: int = 16,
    depth: int = 2,
    cap: int = 32,
    min_match: int = 4,
    lazy: bool = False,
    block_start: jax.Array | int = 0,
    win_start: jax.Array | int = 0,
    seg_log: int = SEG_LOG,
    of_gate: tuple[int, int] = (99, 99),
    mf_win_log: int = 0,
    optimal: bool = False,
    ldm: bool = False,
    sample_log: int = 0,
    dec_min_ml: int = 0,
) -> BlockSequences:
    """Greedy-parse one (padded) block into sequences. block: (N,) uint8/int32.

    Dictionary mode (reference preloads dictionary content into the LZ77
    window, manager.cu:1699-1775): the compressible payload occupies
    [block_start, n) and [win_start, block_start) holds the tail of the
    dictionary — those positions are match *sources* only. Sequence literal
    positions and lengths are all relative to block_start.
    """
    N = block.shape[0]
    pos = jnp.arange(N, dtype=I32)

    payload_only = (
        ldm
        and isinstance(block_start, int)
        and block_start > 0
        and 0 < mf_win_log < max(1, (N - 1).bit_length())
        and (N - block_start) % (1 << mf_win_log) == 0
    )
    bml2 = boff2 = None
    if payload_only:
        # LDM-window mode: the dict/window prefix is reachable ONLY through
        # the sampled long-range pass, so the windowed matcher runs on the
        # payload slice alone — prefix bytes add ZERO rows to the hot sorts
        # (a 768 KB window would otherwise multiply them 7x).
        fm = find_matches(
            block[block_start:], n - block_start, hash_log=hash_log,
            depth=depth, cap=cap, win_start=0, mf_win_log=mf_win_log,
            sample_log=sample_log, two_band=optimal, min_match=min_match,
        )
        zpad = jnp.zeros((block_start,), I32)
        bml = jnp.concatenate([zpad, fm[0]])
        boff = jnp.concatenate([zpad, fm[1]])
        if optimal:
            bml2 = jnp.concatenate([zpad, fm[2]])
            boff2 = jnp.concatenate([zpad, fm[3]])
    else:
        fm = find_matches(
            block, n, hash_log=hash_log, depth=depth, cap=cap, win_start=win_start,
            mf_win_log=mf_win_log, sample_log=sample_log, two_band=optimal,
            min_match=min_match,
        )
        bml, boff = fm[0], fm[1]
        if optimal:
            bml2, boff2 = fm[2], fm[3]
    if ldm and 0 < mf_win_log < max(1, (N - 1).bit_length()):
        # Long-range supplement: candidates beyond the windowed matcher's
        # horizon (reference LDM, src/ldm_implementation.cu). Taken only when
        # strictly longer than the local match — long offsets cost ~log2(off)
        # extra bits, so equal-length local matches must win (measured: a
        # tie-prefers-LDM rule cost 3.5% ratio on the mixed corpus).
        lml, loff = find_matches_long(block, n, win_start=win_start)
        take_l = lml > bml
        bml = jnp.where(take_l, lml, bml)
        boff = jnp.where(take_l, loff, boff)

    # Truncate matches at segment boundaries so segments parse independently;
    # the merge pass below re-joins same-offset continuations.
    seg = 1 << seg_log
    room = seg - (pos & (seg - 1))
    ml_t = jnp.minimum(bml, room)
    matched = (ml_t >= min_match) & (boff > 0) & (pos < n) & (pos >= block_start)
    if dec_min_ml > min_match:
        # Decode-tuned profile: drop short matches (fewer sequences to
        # execute on the device decoder); same-offset continuations stay
        # exempt — the merge pass folds them into one long sequence.
        prev_off0 = jnp.roll(boff, 1)
        matched = matched & ((ml_t >= dec_min_ml) | (boff == prev_off0))
    defer = None
    if optimal:
        # BTOPT-style exact segment DP over the candidate set (levels 16-22,
        # ops/optimal_parse.py): replaces the greedy/lazy/of_gate heuristics with
        # a bit-cost minimization; the walk then executes its choices
        # (a chosen step < ml_t deliberately shortens the match).
        #
        # TWO-PASS PRICING (counterpart of the reference's measured cost
        # model, cuda_zstd_lz77.h:201-213): pass 1 runs the plain greedy walk
        # over the same candidates and measures the block's ACTUAL symbol
        # economics — OF-code histogram, ML-code histogram, residual-literal
        # entropy — then the DP prices every decision with those bits in
        # 1/16-bit fixed point. (A whole-block byte-entropy estimate alone
        # was measured ratio-NEGATIVE in round 3 — residual literals after
        # matching are not distributed like the block average — which is why
        # the histograms come from the pass-1 PARSE, not the raw block.)
        from .fse_jax import highbit32_jnp, ml_code_jnp
        from .optimal_parse import SCALE, opt_steps

        ofc = highbit32_jnp(jnp.maximum(boff + 3, 1))
        mlv = jnp.where(matched, jnp.minimum(ml_t, 127), 0)
        dp_cap = min(cap, 127)

        # --- pass 1: greedy choices at the same candidate set ---
        step1 = jnp.where(matched, ml_t, 1)
        is_seq1, is_lit1 = greedy_parse(step1, matched, None, seg=seg)
        ch = is_seq1 & (pos < n)
        lit1 = is_lit1 & (pos < n) & (pos >= block_start)
        nch = jnp.maximum(jnp.sum(ch.astype(I32)), 1)

        def _sym_bits(hist, total):
            p = hist.astype(jnp.float32) / total.astype(jnp.float32)
            bits = -jnp.log2(jnp.maximum(p, 1e-9))
            unseen = jnp.log2(total.astype(jnp.float32)) + 2.0
            return jnp.round(
                jnp.where(hist > 0, bits, unseen) * SCALE
            ).astype(I32)

        bins32 = jnp.arange(32, dtype=I32)
        ofh = jnp.sum(
            (jnp.where(ch, ofc, 99)[:, None] == bins32[None, :]).astype(I32),
            axis=0,
        )
        of_bits = _sym_bits(ofh, nch)
        mlc1 = ml_code_jnp(jnp.maximum(ml_t, 3))
        bins53 = jnp.arange(53, dtype=I32)
        mlh = jnp.sum(
            (jnp.where(ch, mlc1, 99)[:, None] == bins53[None, :]).astype(I32),
            axis=0,
        )
        ml_bits_h = _sym_bits(mlh, nch)
        # Literal price: entropy of the PASS-1 RESIDUAL literals.
        nlit1 = jnp.maximum(jnp.sum(lit1.astype(I32)), 1)
        byte_bins = jnp.arange(256, dtype=I32)
        lith = jnp.sum(
            (jnp.where(lit1, block.astype(I32), 999)[:, None] == byte_bins[None, :]).astype(I32),
            axis=0,
        )
        pl_ = lith.astype(jnp.float32) / nlit1.astype(jnp.float32)
        h_lit = -jnp.sum(jnp.where(lith > 0, pl_ * jnp.log2(jnp.maximum(pl_, 1e-9)), 0.0))
        lit_price = jnp.clip(jnp.round(h_lit * SCALE).astype(I32), SCALE // 2, 11 * SCALE)

        # --- per-block cost bank ---
        # lanes [0,32): OF-symbol bits + LL-symbol amortization (each match
        # ends a literal run and pays one LL symbol; ~entropy-of-LL is close
        # to 3 bits on mixed data). lanes [32, 32+cap-mm]: ML-symbol bits +
        # EXACT ML extra bits for that length.
        LL_AMORT = 3 * SCALE
        from ..constants import ML_BASELINE, ML_BITS

        import numpy as _np

        mlcode_l = _np.searchsorted(
            _np.asarray(ML_BASELINE), _np.arange(min_match, dp_cap + 1), side="right"
        ) - 1
        mlx_l = _np.asarray(ML_BITS)[mlcode_l] * SCALE
        bank = jnp.zeros((128,), I32)
        bank = bank.at[:32].set(of_bits + LL_AMORT)
        bank = bank.at[32 : 32 + dp_cap + 1 - min_match].set(
            ml_bits_h[jnp.asarray(mlcode_l, I32)] + jnp.asarray(mlx_l, I32)
        )

        # Second (near-band) candidate: best match at offset < 512. The DP
        # may prefer it at a shorter length when the offset bits win.
        ml2_t = jnp.minimum(bml2, room)
        ok2 = (
            (ml2_t >= min_match) & (boff2 > 0) & (pos < n) & (pos >= block_start)
        )
        mlv2 = jnp.where(ok2, jnp.minimum(ml2_t, 127), 0)
        ofc2 = highbit32_jnp(jnp.maximum(boff2 + 3, 1))
        packed = (
            mlv
            | (jnp.minimum(ofc, 31) << 7)
            | (mlv2 << 12)
            | (jnp.minimum(ofc2, 15) << 19)
        )
        nseg_b = N // seg
        dp = opt_steps(
            packed.reshape(-1, seg), min_match, dp_cap,
            lit_bits=jnp.broadcast_to(lit_price, (nseg_b,)),
            cost_bank=jnp.broadcast_to(bank, (nseg_b, 128)),
        ).reshape(-1)
        matched = dp > 1
        # Which candidate did the DP price for the chosen length? Mirror the
        # kernel's min(): candidate 2 wins when feasible and not costlier.
        def _of_cost(c):
            oh = (c[:, None] == bins32[None, :]).astype(I32)
            return jnp.sum(oh * of_bits[None, :], axis=1) + c * SCALE

        mc1 = _of_cost(jnp.minimum(ofc, 31))
        mc2 = _of_cost(jnp.minimum(ofc2, 31))
        use2 = matched & (mlv2 >= dp) & ((mlv < dp) | (mc2 <= mc1))
        boff = jnp.where(use2, boff2, boff)
        ml_t = jnp.where(matched, dp, ml_t)
        step = jnp.where(matched, dp, 1)
    else:
        if of_gate != (99, 99):
            # Offset-cost gate: a short match at a large offset spends more
            # bits (OF symbol + ~log2(off) extras) than the literals it
            # replaces; libzstd's level-3 strategy leaves those as literals.
            # Same-offset continuity stays exempt (rep0 is nearly free).
            from .fse_jax import highbit32_jnp

            g4, g5 = of_gate
            ofc = highbit32_jnp(jnp.maximum(boff, 1))
            prev_boff = jnp.roll(boff, 1)
            gate = (
                (ml_t >= 6)
                | ((ml_t == 4) & (ofc <= g4))
                | ((ml_t == 5) & (ofc <= g5))
                | (boff == prev_boff)
            )
            matched = matched & gate
        step = jnp.where(matched, ml_t, 1)
        if lazy:
            next_ml = jnp.roll(ml_t, -1).at[-1].set(0)
            next_matched = jnp.roll(matched, -1).at[-1].set(False)
            defer = matched & next_matched & (next_ml > ml_t + 1)

    is_seq, is_lit = greedy_parse(step, matched, defer, seg=seg)
    is_seq = is_seq & (pos < n)
    is_lit = is_lit & (pos < n) & (pos >= block_start)
    nseq = jnp.sum(is_seq.astype(I32))

    # Extraction via ONE compaction-sort shared with the literal compaction:
    # sequences first (position order), then literal bytes, then the rest.
    # (21-bit offsets: LDM-window prefixes push offsets past 1 MB.)
    nlit = jnp.sum(is_lit.astype(I32))
    assert cap < (1 << 10)  # ml field: 10 bits above the 21-bit offset
    pk = jnp.where(is_seq, (ml_t << 21) | boff, block.astype(I32))
    # The extraction window is independent of the match window (pure
    # mechanics, ratio-neutral): shorter sort axes are cheaper per row.
    ew_log = min(mf_win_log, 11) if (
        0 < mf_win_log
        and (1 << min(mf_win_log, 11)) < N
        and N % (1 << min(mf_win_log, 11)) == 0
    ) else 0
    if ew_log:
        # Windowed extraction: the compaction-sort runs along the SAME short
        # 2^ew_log axis as the match-finder sorts, then the per-window
        # sequence rows and literal runs are concatenated (_concat_windows).
        W = 1 << ew_log
        nwin = N // W
        lpos = jax.lax.broadcasted_iota(I32, (nwin, W), 1)
        isq = is_seq.reshape(nwin, W)
        isl = is_lit.reshape(nwin, W)
        selk = jnp.where(isq, lpos, jnp.where(isl, W + lpos, 2 * W + lpos))
        e_key_w, e_pk_w = jax.lax.sort(
            (selk, pk.reshape(nwin, W)), num_keys=1, is_stable=False
        )
        nseq_w = jnp.sum(isq.astype(I32), axis=1)
        nlit_w = jnp.sum(isl.astype(I32), axis=1)
        lits, starts, pk_acc = _concat_windows(
            e_key_w, e_pk_w, nseq_w, nlit_w, max_seqs
        )
        mls = pk_acc >> 21
        offs = pk_acc & ((1 << 21) - 1)
    else:
        # ONE payload operand: the sorted key itself encodes pos (seq rows
        # sort to the front with key == pos, so starts = key[:max_seqs]); the
        # payload only needs (ml<<21|off) on seq rows and the literal byte on
        # lit rows — the row classes are disjoint. Sort cost is ~linear in
        # operand count.
        sel_key = jnp.where(is_seq, pos, jnp.where(is_lit, N + pos, 2 * N + pos))
        e_key, e_pk = _sort_unique(sel_key, pk)
        from .bitpack import dynroll_left

        nseq_pre = jnp.sum(is_seq.astype(I32))
        lits = dynroll_left(e_pk & 0xFF, nseq_pre, N).astype(jnp.uint8)
        starts = e_key[:max_seqs]
        mls = e_pk[:max_seqs] >> 21
        offs = e_pk[:max_seqs] & ((1 << 21) - 1)
    k = jnp.arange(max_seqs, dtype=I32)
    valid = k < nseq
    starts = jnp.where(valid, starts, 0)
    mls = jnp.where(valid, mls, 0)
    offs = jnp.where(valid, offs, 0)
    # Overflow poison (reachable only at min_match 3, where the worst-case
    # sequence count is n/3 > max_seqs): the extraction above TRUNCATES past
    # max_seqs, so a block that parsed into more sequences falls back to
    # all-literals — the assembler then emits a Raw block (never corrupt
    # output, tiny ratio loss on a pathological block).
    overflow = nseq > max_seqs

    ends = starts + mls
    prev_end = jnp.roll(ends, 1).at[0].set(jnp.asarray(block_start, I32) + 0)
    lls = jnp.where(valid, starts - prev_end, 0)

    # Merge contiguous same-offset sequences (recovers matches beyond `cap`
    # and across segment boundaries). Valid rows tile [block_start, end) as
    # ll+ml runs, so a head's merged length ends where the NEXT head's match
    # begins (its start minus its literal run) — no prefix sum needed; the
    # last head ends at the last valid row's match end.
    prev_off = jnp.roll(offs, 1).at[0].set(0)
    cont = valid & (k > 0) & (lls == 0) & (offs == prev_off) & (offs > 0)
    head = valid & ~cont
    nseq2 = jnp.sum(head.astype(I32))
    end_last = jnp.max(jnp.where(valid, starts + mls, 0))
    # Key is unique (heads keep k < max_seqs, non-heads get max_seqs + k);
    # non-head payloads land at the back and are discarded by the valid2 mask.
    mkey = jnp.where(head, k, max_seqs + k)
    _, m_ll, m_off, m_start = _sort_unique(mkey, lls, offs, starts)
    k2 = jnp.arange(max_seqs, dtype=I32)
    valid2 = k2 < nseq2
    next_begin = jnp.where(
        k2 == nseq2 - 1,
        end_last,
        jnp.roll(m_start, -1) - jnp.roll(m_ll, -1),
    )
    ll2 = jnp.where(valid2, m_ll, 0)
    off2 = jnp.where(valid2, m_off, 0)
    starts2 = jnp.where(valid2, m_start, 0)
    ml2 = jnp.where(valid2, next_begin - m_start, 0)

    # Offset-base values with FULL repcode usage (rep0/rep1/rep2) via an exact
    # sequential history walk (ops/pallas_rep.py; the host rule is
    # format/sequences.py encode_offset). Initial history is unknown — blocks
    # are compressed independently while rep state carries across blocks in a
    # frame (RFC 8878 §3.1.1.5) — so matches only fire on entries established
    # in-block; the first sequence always spells its offset.
    packed_rep = jnp.where(
        valid2, off2 | ((ll2 > 0).astype(I32) << 21) | (1 << 22), 0
    )
    from .pallas_rep import rep_codes

    ob = rep_codes(packed_rep)

    if min_match < 4:
        nseq2 = jnp.where(overflow, 0, nseq2)
        if isinstance(block_start, int):
            pay = jnp.roll(block, -block_start).astype(jnp.uint8)
        else:
            from .bitpack import dynroll_left

            pay = dynroll_left(block.astype(I32), block_start, N).astype(jnp.uint8)
        lits = jnp.where(overflow, pay, lits)
        nlit = jnp.where(overflow, jnp.maximum(n - block_start, 0), nlit)
        zero_if = lambda a: jnp.where(overflow, 0, a)
        ll2, ml2, ob, off2, starts2 = map(zero_if, (ll2, ml2, ob, off2, starts2))
    return BlockSequences(ll2, ml2, ob, off2, starts2, nseq2, lits, nlit)
