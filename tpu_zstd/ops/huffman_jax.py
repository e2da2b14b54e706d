"""Data-parallel Huffman literals encoder (RFC 8878 §4.2, 4-stream format).

Counterpart of the reference's Huffman subsystem (reference
src/cuda_zstd_huffman.cu: `analyze_frequencies_kernel` :88, host tree build
:1878-1905, `parallel_huffman_encode_kernel` :1132, table serialization :189)
— but note the reference COMPRESSOR never emits Huffman literals (Raw only,
manager.cu:4433-4435); this encoder therefore exceeds reference parity.

All stages are jittable and batch over blocks:
- histogram via sort + searchsorted (no scatter)
- length-limited code lengths via a vectorized theta-shift + exact Kraft
  repair (a parallel stand-in for package-merge; blocks where the repair
  cannot reach Kraft equality fall back to Raw literals)
- canonical code assignment (longest codes smallest, natural order within a
  length) as closed-form vector ops
- weight serialization: direct 4-bit, or FSE-compressed 2-state stream
  (weights_fse_payload) when smaller or when >128 explicit weights
- 4 independent backward bitstreams + jump table, deposited in parallel
  (ops/bitpack.py sort-based deposit)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .bitpack import deposit_bits

I32 = jnp.int32
U32 = jnp.uint32
F32 = jnp.float32

MAX_BITS = 11
TSIZE = 1 << MAX_BITS  # Kraft budget at max_bits granularity
# Accel frames keep the full 11-bit codes (an 8-bit cap cost ~5.6%
# compressed size on the bench corpus).
ACCEL_MAX_BITS = 11


def huff_payload_cap(block_size: int) -> int:
    """Buffer capacity for the worst-case 4-stream payload of one block.

    Rounded up to 4096 bytes (1024 u32 words)."""
    part = block_size // 4 + 4
    num_words = (part * MAX_BITS) // 8 // 4 + 4
    cap = 6 + 4 * (num_words * 4) + 160  # jump + streams + weights header
    return -(-cap // 4096) * 4096


def _floor_log2(v: jax.Array) -> jax.Array:
    v = v.astype(U32)
    out = jnp.zeros(v.shape, dtype=I32)
    for shift in (16, 8, 4, 2, 1):
        m = v >= (U32(1) << U32(shift))
        out = out + jnp.where(m, shift, 0)
        v = jnp.where(m, v >> U32(shift), v)
    return out


def literal_histogram(lits: jax.Array, nlit: jax.Array) -> jax.Array:
    """(256,) counts of lits[:nlit] — nibble one-hot contraction
    (ops/fse_tables_jax.histogram_matmul)."""
    from .fse_tables_jax import histogram_matmul

    N = lits.shape[0]
    pos = jnp.arange(N, dtype=I32)
    return histogram_matmul(lits.astype(I32), pos < nlit, 256)


def build_lengths(cnt: jax.Array, nlit: jax.Array, max_bits: int = MAX_BITS) -> tuple[jax.Array, jax.Array]:
    """Length-limited (<=11) code lengths with exact Kraft equality.

    Returns (lengths[256] — 0 for absent symbols, ok flag). ok is False when
    the repair could not reach equality or <2 symbols are present.
    """
    present = cnt > 0
    nsym = jnp.sum(present.astype(I32))
    tsize = 1 << max_bits

    # Initial lengths ~ ceil(-log2 p), via integer ratio against the budget
    # (int32-safe: cnt <= 2^20 literals, * 2^11 < 2^31).
    ratio = cnt.astype(I32) * tsize // jnp.maximum(nlit, 1)
    l0 = max_bits - _floor_log2(jnp.maximum(ratio, 1))
    l0 = jnp.clip(l0, 1, max_bits)

    # Smallest uniform shift theta that fits the Kraft budget.
    def kraft(l):
        return jnp.sum(jnp.where(present, (1 << (max_bits - l)).astype(I32), 0))

    K_by_theta = jnp.stack([kraft(jnp.clip(l0 + t, 1, max_bits)) for t in range(max_bits + 1)])
    fits = K_by_theta <= tsize
    theta = jnp.argmax(fits).astype(I32)  # first fitting shift
    lengths = jnp.clip(l0 + theta, 1, max_bits)
    lengths = jnp.where(present, lengths, 0)
    safe_l = jnp.where(present, lengths, max_bits)
    D = tsize - jnp.sum(jnp.where(present, (1 << (max_bits - safe_l)).astype(I32), 0))

    # Exact repair: hand out the remaining budget by promoting symbols
    # (l -> l-1 costs 2^(11-l) budget, saves cnt bits); two passes over cost
    # sizes, and within a level promote the highest-count symbols first.
    # Count order is one global precedence matrix (strict count-rank order),
    # so per-level ranking is a single bf16 matvec instead of two sorts.
    sym_idx = jnp.arange(256, dtype=I32)
    _, order = jax.lax.sort((-cnt, sym_idx), num_keys=1, is_stable=True)
    _, rg = jax.lax.sort((order, sym_idx), num_keys=1, is_stable=True)
    prec = (rg[:, None] > rg[None, :]).astype(jnp.bfloat16)  # prec[s,t]: t before s
    for _ in range(2):
        for l in range(2, max_bits + 1):
            g = 1 << (max_bits - l)
            cand = present & (lengths == l)
            k = jnp.minimum(jnp.sum(cand.astype(I32)), D // g)
            rank = (prec @ cand.astype(jnp.bfloat16)).astype(I32)  # <= 255: exact
            dec = cand & (rank < k)
            lengths = jnp.where(dec, l - 1, lengths)
            D = D - k * g
    ok = (D == 0) & (nsym >= 2)
    return lengths, ok


def canonical_codes(lengths: jax.Array) -> jax.Array:
    """Canonical code values from lengths (mirrors format/huffman.assign_codes)."""
    sym_ar = jnp.arange(256, dtype=I32)
    nb_per_rank = jnp.stack(
        [jnp.sum((lengths == l).astype(I32)) for l in range(MAX_BITS + 2)]
    )
    # val_per_rank: walk from max_bits down (python loop over static lengths).
    vals = [jnp.zeros((), I32) for _ in range(MAX_BITS + 2)]
    min_v = jnp.zeros((), I32)
    for nbits in range(MAX_BITS, 0, -1):
        vals[nbits] = min_v
        min_v = (min_v + nb_per_rank[nbits]) >> 1
    val_per_rank = jnp.stack(vals)  # (MAX_BITS+2,)
    # rank within (length, natural symbol order)
    onehot_l = (lengths[:, None] == jnp.arange(MAX_BITS + 2, dtype=I32)[None, :]).astype(I32)
    rank_within = jnp.cumsum(onehot_l, axis=0) - onehot_l  # exclusive count per length
    my_rank = jnp.sum(rank_within * onehot_l, axis=1)
    my_base = jnp.sum(val_per_rank[None, :] * onehot_l, axis=1)
    return jnp.where(lengths > 0, my_base + my_rank, 0)


def weights_header(lengths: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Direct 4-bit weight serialization (RFC §4.2.1.2).

    Returns (header[129] uint8, header_len, ok). ok False when the explicit
    weight count exceeds 128 (FSE-weight encoding not emitted on-device yet).
    """
    sym_ar = jnp.arange(256, dtype=I32)
    table_log = jnp.max(lengths)
    weights = jnp.where(lengths > 0, table_log + 1 - lengths, 0)
    last_present = jnp.max(jnp.where(lengths > 0, sym_ar, -1))
    num = last_present  # explicit weights = weights[:last_present]
    ok = (num >= 1) & (num <= 128)
    wexp = jnp.where(sym_ar < num, weights, 0)  # zero beyond explicit range
    hi = wexp[0::2]
    lo = wexp[1::2]
    packed = ((hi << 4) | lo).astype(jnp.uint8)  # (128,)
    hdr = jnp.concatenate([jnp.zeros(1, jnp.uint8), packed])
    hdr = hdr.at[0].set((127 + num).astype(jnp.uint8))
    hdr_len = 1 + (num + 1) // 2
    return hdr, hdr_len, ok


WEIGHT_CAP = 160  # payload byte capacity for the FSE weight header (must be < 128 used)


def weights_fse_payload(lengths: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """FSE-compressed Huffman weights (RFC 8878 §4.2.1.1, headerByte < 128).

    The reference decodes this format (reference src/cuda_zstd_huffman.cu:270
    `decode_huffman_weights_fse`) but its compressor never emits it; emitting
    it lifts the direct-representation limit of 128 explicit weights, so
    blocks whose literals use symbols above 128 (any binary data) can take
    Huffman literals at all.

    Returns (payload[WEIGHT_CAP] uint8, payload_len, ok). The payload is
    NCount header + interleaved 2-state bitstream; the caller prepends the
    headerByte (= payload_len) and must check ok (>= 2 distinct weights and
    payload_len < 128).
    """
    from .bitpack import deposit_bits, dynroll, place, words_to_bytes
    from .fse_jax import _state_chain3_cf
    from .fse_tables_jax import TL, build_cf_tables, histogram_codes, ncount_fields, normalize_64

    NW = 256
    sym_ar = jnp.arange(NW, dtype=I32)
    table_log = jnp.max(lengths)
    weights = jnp.where(lengths > 0, table_log + 1 - lengths, 0)
    last_present = jnp.max(jnp.where(lengths > 0, sym_ar, -1))
    num = last_present  # explicit weights = weights[:last_present]
    wexp = jnp.where(sym_ar < num, weights, 0)

    cnt = histogram_codes(wexp, num, 13)
    npres = jnp.sum((cnt > 0).astype(I32))
    norm = normalize_64(cnt, num)
    nc_vals, nc_lens, nc_bytes = ncount_fields(norm)
    st_t, dnb_t, dfs_t, init = build_cf_tables(norm)

    # Reversed explicit weights r[t] = wexp[num-1-t]; split into the two
    # interleaved chains (A = even t, B = odd t — stream assignment to the
    # libzstd s1/s2 labels depends on parity only at flush time).
    r = dynroll(jnp.flip(wexp), (num - NW) % NW, NW)
    rA = r[0::2]
    rB = r[1::2]
    nA = (num + 1) // 2
    nB = num // 2
    rAB = jnp.stack([rA, rB])
    n2 = jnp.stack([nA, nB])
    pre2, fin2, nb2 = _state_chain3_cf(
        jnp.stack([st_t, st_t]),
        jnp.stack([dnb_t, dnb_t]),
        jnp.stack([dfs_t, dfs_t]),
        jnp.stack([init, init]),
        jnp.full((2,), TL, I32),
        jnp.zeros((2,), bool),
        rAB,
        n2,
        NW // 2,
    )
    preA, preB = pre2[0], pre2[1]
    finA, finB = fin2[0], fin2[1]
    nbA, nbB = nb2[0], nb2[1]
    vA = (64 + preA) & ((1 << nbA.astype(U32)).astype(I32) - 1)
    vB = (64 + preB) & ((1 << nbB.astype(U32)).astype(I32) - 1)
    # Interleave to t order (A0,B0,A1,B1,...): field at t uses chain sub-index
    # t//2; fields live for 2 <= t < num.
    nb_t = jnp.stack([nbA, nbB], axis=1).reshape(-1)
    v_t = jnp.stack([vA, vB], axis=1).reshape(-1)
    t_ar = jnp.arange(NW, dtype=I32)
    live = (t_ar >= 2) & (t_ar < num)
    lens_t = jnp.where(live, nb_t, 0)

    # Tail: libzstd flushes s2 then s1; with odd num s2 is the B chain, with
    # even num it is the A chain. 6 bits each (table_log TL), then sentinel.
    odd = (num & 1) == 1
    t1 = jnp.where(odd, finB, finA)
    t2 = jnp.where(odd, finA, finB)
    has = (num >= 2).astype(I32)
    all_vals = jnp.concatenate(
        [v_t, jnp.stack([t1, t2, jnp.ones((), I32)])]
    ).astype(U32)
    all_lens = jnp.concatenate([lens_t, jnp.stack([has * 6, has * 6, has * 1])])

    words, total_bits = deposit_bits(all_vals, all_lens, WEIGHT_CAP // 4)
    stream_bytes = (total_bits + 7) >> 3

    stream = words_to_bytes(words)
    out = place(_nc_desc_bytes(nc_vals, nc_lens), nc_bytes, jnp.zeros((), I32), WEIGHT_CAP, 1)
    out = out + place(stream, stream_bytes, nc_bytes, WEIGHT_CAP, 64)
    payload_len = nc_bytes + stream_bytes
    ok = (npres >= 2) & (num >= 2) & (payload_len < 128)
    return out, payload_len, ok


def _nc_desc_bytes(nc_vals: jax.Array, nc_lens: jax.Array) -> jax.Array:
    """NCount field deposit -> byte array (weights alphabet, small)."""
    from .bitpack import deposit_bits, words_to_bytes

    words = deposit_bits(nc_vals, nc_lens, 16)[0]
    return words_to_bytes(words)


def _lut256(table: jax.Array, idx: jax.Array) -> jax.Array:
    """Gather-free 256-entry lookup: two-level 16x16 one-hot contraction.

    Precision.HIGHEST is required: at default precision a float32 matmul may
    run in reduced precision (TF32 on the GPU), which corrupts table values
    wider than ~11 bits; at HIGHEST the 16-bit packed entries are exact.
    """
    t = table.astype(F32).reshape(16, 16)
    hi = idx >> 4
    lo = idx & 15
    oh_hi = (hi[:, None] == jnp.arange(16, dtype=I32)[None, :]).astype(F32)
    rows = jnp.matmul(oh_hi, t, precision=jax.lax.Precision.HIGHEST)  # (N, 16)
    oh_lo = (lo[:, None] == jnp.arange(16, dtype=I32)[None, :]).astype(F32)
    return jnp.sum(rows * oh_lo, axis=1).astype(I32)


def encode_literals_4stream(
    lits: jax.Array,
    nlit: jax.Array,
    lengths: jax.Array,
    codes: jax.Array,
    out_cap: int,
    ckpt_every: int = 0,
) -> tuple:
    """4-stream Huffman payload: jump table + 4 backward bitstreams.

    lits: (N,) uint8 (first nlit valid). Returns (payload[out_cap+8] uint8,
    payload_len, ok). Streams encode their symbols in reverse position order
    (decoders read forward). Requires nlit >= 16 (callers gate on that).

    Each stream is aligned to position 0 with a static-roll shift (streams are
    contiguous slices of the reversed literal order), adjacent same-stream
    symbols merge into one field (two <=11-bit codes always fit 32 bits), and
    each stream's fields pack via `deposit_bits_tree` (elementwise pairwise
    concatenation). The four packed streams
    then compose at their byte bases with `shift_words`. Code+length ride one
    packed 16-bit LUT value.
    """
    from .bitpack import deposit_bits_tree, dynroll, shift_words, words_to_bytes

    N = lits.shape[0]
    seg = (nlit + 3) // 4
    P = N // 4       # static per-stream symbol capacity (pow2 pair count)

    packed_tbl = (lengths << 12) | codes
    pk = _lut256(packed_tbl, lits.astype(I32))
    pkf = jnp.flip(pk)  # pkf[j] = packed code of lit[N-1-j]

    starts = jnp.stack([seg * 0, seg, seg * 2, seg * 3])
    ends = jnp.stack([seg, seg * 2, seg * 3, nlit])

    j = jnp.arange(P, dtype=I32)
    v2s, l2s, cks = [], [], []
    for s in range(4):
        # Stream s reversed symbols start at flip-index N - ends[s]:
        # dynroll right by ends[s] puts them at 0 (mod N when nlit == N).
        pks = dynroll(pkf, ends[s] % N, N)[:P]
        n_s = ends[s] - starts[s]
        l_s = jnp.where(j < n_s, pks >> 12, 0)
        c_s = jnp.where(j < n_s, pks & 0xFFF, 0)
        if ckpt_every:
            # Decoder checkpoints (ops/decode_jax.py decode_huffman_device):
            # the decoder's unread-bit cursor before FORWARD symbol k equals
            # the exclusive prefix of reversed-order code lengths at reversed
            # index n_s - k (total stream bits == full prefix sum).
            K = ckpt_every
            NCL = P // K
            cume = jnp.cumsum(l_s) - l_s
            c_ar = jnp.arange(1, NCL, dtype=I32)
            ti = n_s - c_ar * K
            ck = jnp.where(ti >= 1, jnp.take(cume, jnp.clip(ti, 0, P - 1)), 0)
            cks.append(ck)
        c0, c1 = c_s[0::2], c_s[1::2]
        l0, l1 = l_s[0::2], l_s[1::2]
        v2s.append((c0 | (c1 << l0)).astype(U32))  # <= 22 bits
        l2s.append(l0 + l1)

    num_words = out_cap // 4
    NW_S = (P * MAX_BITS) // 32 + 2  # per-stream word capacity
    sw4, sb4 = jax.vmap(
        lambda v, l: deposit_bits_tree(v, l, NW_S, max_field_bits=2 * MAX_BITS)
    )(jnp.stack(v2s), jnp.stack(l2s))

    stream_bits = sb4                              # (4,) data bits per stream
    stream_bytes = (stream_bits + 1 + 7) >> 3      # + sentinel bit
    byte_base = jnp.cumsum(stream_bytes) - stream_bytes

    # Sentinel bit at each stream's data end (elementwise one-hot, no scatter).
    jw = jnp.arange(NW_S, dtype=I32)
    sent = jnp.where(
        jw[None, :] == (stream_bits >> 5)[:, None],
        (U32(1) << (stream_bits & 31).astype(U32)[:, None]),
        U32(0),
    )
    words = jnp.sum(
        jax.vmap(lambda w, b: shift_words(w, b * 8, num_words))(sw4 + sent, byte_base),
        axis=0,
    )

    jump = jnp.stack(
        [
            (stream_bytes[0] & 0xFF), (stream_bytes[0] >> 8) & 0xFF,
            (stream_bytes[1] & 0xFF), (stream_bytes[1] >> 8) & 0xFF,
            (stream_bytes[2] & 0xFF), (stream_bytes[2] >> 8) & 0xFF,
        ]
    ).astype(jnp.uint8)
    ok = jnp.all(stream_bytes <= 0xFFFF) & (nlit >= 16)

    out = jnp.concatenate([jump, words_to_bytes(words), jnp.zeros(2, jnp.uint8)])
    payload_len = 6 + jnp.sum(stream_bytes)
    if ckpt_every:
        return out, payload_len, ok, jnp.stack(cks)
    return out, payload_len, ok


def compress_literals_huffman(
    lits: jax.Array, nlit: jax.Array, out_cap: int, ckpt_every: int = 0
) -> tuple:
    """Full Huffman literals payload: weights header + 4-stream body.

    Returns (payload[out_cap + 8] uint8, payload_len, ok) — plus lit decode
    checkpoints (4, P//ckpt_every - 1) when ckpt_every > 0. Callers compare
    against the Raw representation and pick the smaller.
    """
    from .bitpack import place

    hist = literal_histogram(lits, nlit)
    # Accel (inference-profile) frames cap code length at 8 so the lane
    # decoder's two taa banks cover the whole table; see ACCEL_MAX_BITS.
    lengths, ok_l = build_lengths(
        hist, nlit, ACCEL_MAX_BITS if ckpt_every else MAX_BITS
    )
    codes = canonical_codes(lengths)
    whdr, wlen, ok_w = weights_header(lengths)
    fpay, flen, ok_f = weights_fse_payload(lengths)
    enc = encode_literals_4stream(lits, nlit, lengths, codes, out_cap, ckpt_every)
    if ckpt_every:
        body, blen, ok_s, lit_ck = enc
    else:
        body, blen, ok_s = enc

    # Weights representation: FSE-compressed (headerByte < 128 = its size)
    # when it is valid and smaller, or when direct is impossible (>128
    # explicit weights); else direct 4-bit.
    use_fse = ok_f & ((~ok_w) | (1 + flen < wlen))
    HCAP = max(129, WEIGHT_CAP + 1)
    hdr_f = jnp.concatenate([jnp.zeros(1, jnp.uint8), fpay])
    hdr_f = hdr_f.at[0].set(flen.astype(jnp.uint8))
    pad_to = lambda a: jnp.pad(a, (0, HCAP - a.shape[0]))
    hdr_arr = jnp.where(use_fse, pad_to(hdr_f), pad_to(whdr))
    hdr_len = jnp.where(use_fse, 1 + flen, wlen)

    cap2 = out_cap + 4096  # 4096-aligned (out_cap is)
    out = place(hdr_arr, hdr_len, jnp.zeros((), I32), cap2, 1)
    out = out + place(body, blen, hdr_len, cap2, 256)
    ok = ok_l & (ok_w | ok_f) & ok_s
    if ckpt_every:
        return out, hdr_len + blen, ok, lit_ck
    return out, hdr_len + blen, ok
