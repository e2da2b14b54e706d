"""Data-parallel decompression: FSE sequence decode + sequence execution.

Counterpart of the reference's decompression stack (reference
src/cuda_zstd_manager.cu:3194-3780 `decompress`, :4292 `decompress_block`,
src/cuda_zstd_fse.cu:3839 `k_decode_sequences_interleaved`,
src/cuda_zstd_sequence.cu:459 `execute_sequences` 3-pass executor):

- FSE sequence decode is a strict bit-serial chain (state values depend on
  consumed bit counts), so it runs as ONE dynamic-length while_loop whose
  body is vectorized across every block in the batch — the batch dimension,
  not the chain, provides the parallelism (the reference's 8-stream batch
  pool plays the same role, manager.cu:5540).
- Repcode resolution (RFC 8878 §3.1.1.5) is folded into the same loop (the
  reference resolves repcodes in its sequential Pass 1, sequence.cu:209).
- Sequence execution is fully parallel: per-position source maps built from
  diff-arrays + cumsums, match chains resolved by pointer doubling (log2 N
  gather rounds), literals applied with one final gather. This replaces the
  reference's sequential Pass-3 copy kernel (sequence.cu:347) entirely.

Host-side framing/section parsing lives in api/decompress.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import LL_BASELINE, LL_BITS, ML_BASELINE, ML_BITS

I32 = jnp.int32
U32 = jnp.uint32

MAX_TABLE_LOG = 9  # RFC limits: LL<=9, OF<=8, ML<=9
TSIZE_MAX = 1 << MAX_TABLE_LOG


class SeqTables(NamedTuple):
    """Dense per-block decode tables, padded to TSIZE_MAX states.

    Arrays are (B, 3, TSIZE_MAX): axis 1 = (LL, OF, ML)."""

    symbol: jax.Array
    nb_bits: jax.Array
    new_state: jax.Array
    table_log: jax.Array  # (B, 3)


def _read_bits(words: jax.Array, bits_left: jax.Array, n: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Vectorized backward bitstream read over u32 LE words.

    words: (B, SW) uint32 (LE bytes packed); bits_left: (B,) bit cursor;
    n: (B,) <= 25. Returns (values, new_bits_left): bits [bits_left-n, bits_left).
    """
    nl = bits_left - n
    w = jnp.clip(nl >> 5, 0, words.shape[1] - 2)
    sh = (jnp.maximum(nl, 0) & 31).astype(U32)
    B = words.shape[0]
    rows = jnp.arange(B, dtype=I32)
    w0 = words[rows, w]
    w1 = words[rows, w + 1]
    v = (w0 >> sh) | ((w1 << U32(1)) << (U32(31) - sh))
    mask = jnp.where(n >= 32, U32(0xFFFFFFFF), (U32(1) << jnp.minimum(n, 31).astype(U32)) - U32(1))
    return (v & mask).astype(I32), nl


def _read_wide(streams, bits_left, n):
    """Read up to 31 bits as two <=16-bit reads (hi bits first)."""
    n1 = jnp.maximum(n - 16, 0)
    hi, bits_left = _read_bits(streams, bits_left, n1)
    n2 = jnp.minimum(n, 16)
    lo, bits_left = _read_bits(streams, bits_left, n2)
    return (hi << jnp.minimum(n, 16)) | lo, bits_left


def _lookup(state: jax.Array, table: jax.Array) -> jax.Array:
    """Batched exact table lookup: state (B, K, N) int32 indices into
    table (B, K, S) int32 -> (B, K, N) int32."""
    return jnp.take_along_axis(table, state, axis=2, mode="clip")


def _lookup_const(idx: jax.Array, table: jax.Array) -> jax.Array:
    """Lookup into one shared constant table: idx (R,), table (S,) int32."""
    return jnp.take(table, idx, mode="clip")


def _pack_words(streams: jax.Array) -> jax.Array:
    """(B, S) uint8 LE byte streams -> (B, ceil(S/4) + 1) uint32 LE words.

    The trailing zero word lets a two-word read at the stream's top word
    stay inside the window fetch even when S fills its last word exactly."""
    S = streams.shape[1]
    pad = (-S) % 4
    sb = jnp.pad(streams, ((0, 0), (0, pad + 4))).astype(U32)
    n = (S + pad) // 4 + 1
    return (
        sb[:, 0::4][:, :n]
        | (sb[:, 1::4][:, :n] << 8)
        | (sb[:, 2::4][:, :n] << 16)
        | (sb[:, 3::4][:, :n] << 24)
    )


# LL/ML value tables packed as base | bits << 17 (max < 2^22) so the scan
# body resolves baseline AND extra-bit count with ONE lookup per code.
_LL_PACKED = (LL_BASELINE.astype(np.int64) | (LL_BITS.astype(np.int64) << 17)).astype(np.int32)
_ML_PACKED = (ML_BASELINE.astype(np.int64) | (ML_BITS.astype(np.int64) << 17)).astype(np.int32)

_SEQ_WIN = 8   # words per bitstream window (covers 2 decode steps: <= 178 bits)
_SEQ_PAIR = 2  # decode steps per window fetch


def _decode_seqs_core(
    words: jax.Array,       # (B, SW) u32 packed streams
    total_bits: jax.Array,  # (B,)
    tables: SeqTables,
    nseq: jax.Array,        # (B,)
    rep_rows: jax.Array,    # (R, 3) initial rep triple per chunk row
    ck_bits: jax.Array | None,    # (B, NC-1) or None when NC == 1
    ck_states: jax.Array | None,  # (B, NC-1) packed ll | of<<10 | ml<<20
    stride: int,
    NC: int,
):
    """Shared chunk-row FSE sequence decode scan (NC=1 == whole-block serial).

    Every table access (FSE decode tables, LL/ML value tables) is an exact
    integer gather; the bitstream is read through one 8-word window fetch
    per TWO decode steps (<= 178 bits).

    Returns (ll, ml, off) each (stride, R) plus the final carry rep (R, 3).
    """
    B, SW = words.shape
    R = B * NC
    assert stride % _SEQ_PAIR == 0
    words_flat = words.reshape(-1)

    tl = tables.table_log
    bl0 = total_bits
    st_ll0, bl0 = _read_bits(words, bl0, tl[:, 0])
    st_of0, bl0 = _read_bits(words, bl0, tl[:, 1])
    st_ml0, bl0 = _read_bits(words, bl0, tl[:, 2])

    packed_tab = (
        jnp.clip(tables.symbol, 0, 63)
        | (jnp.clip(tables.nb_bits, 0, 15) << 6)
        | (tables.new_state << 10)
    )  # (B, 3, TSIZE_MAX) — value < 2^19

    if NC == 1:
        bits_left = bl0
        st_ll, st_of, st_ml = st_ll0, st_of0, st_ml0
        cix = jnp.zeros((R,), I32)
        nseq_r = nseq
        word_base = jnp.arange(B, dtype=I32) * SW
    else:
        blk = jnp.repeat(jnp.arange(B, dtype=I32), NC)
        cix = jnp.tile(jnp.arange(NC, dtype=I32), B)
        first = cix == 0
        ckb = jnp.pad(ck_bits, ((0, 0), (0, max(0, NC - 1 - ck_bits.shape[1]))))[:, : NC - 1]
        cks = jnp.pad(ck_states, ((0, 0), (0, max(0, NC - 1 - ck_states.shape[1]))))[:, : NC - 1]
        ckb_r = jnp.pad(ckb, ((0, 0), (1, 0))).reshape(-1)
        cks_r = jnp.pad(cks, ((0, 0), (1, 0))).reshape(-1)
        bits_left = jnp.where(first, bl0[blk], ckb_r.astype(I32))
        st_ll = jnp.where(first, st_ll0[blk], (cks_r & 0x3FF).astype(I32))
        st_of = jnp.where(first, st_of0[blk], ((cks_r >> 10) & 0x3FF).astype(I32))
        st_ml = jnp.where(first, st_ml0[blk], ((cks_r >> 20) & 0x3FF).astype(I32))
        nseq_r = nseq[blk]
        word_base = blk * SW

    ll_tab = jnp.asarray(_LL_PACKED)
    ml_tab = jnp.asarray(_ML_PACKED)
    WIN = _SEQ_WIN

    def tab3(s_ll, s_of, s_ml):
        """3 FSE-table lookups as ONE batched gather (B,3,NC)."""
        st3 = jnp.stack([s_ll, s_of, s_ml]).reshape(3, B, NC).transpose(1, 0, 2)
        v = _lookup(st3, packed_tab)  # (B, 3, NC)
        return v[:, 0].reshape(R), v[:, 1].reshape(R), v[:, 2].reshape(R)

    def _fetch_window(bits_left):
        top_w = jnp.clip((bits_left - 1) >> 5, 0, SW - 1)
        base_w = jnp.clip(top_w - (WIN - 2), 0, max(SW - WIN, 0))
        idx = word_base[:, None] + jnp.minimum(
            base_w[:, None] + jnp.arange(WIN, dtype=I32)[None, :], SW - 1
        )
        win = jnp.take(words_flat, idx)
        return win, base_w * 32

    def _read_local(win, base_bit, bits_left, n):
        nl = bits_left - n
        rel = jnp.maximum(nl - base_bit, 0)
        r = jnp.clip(rel >> 5, 0, WIN - 2)
        sh = (rel & 31).astype(U32)
        w0 = jnp.zeros_like(bits_left).astype(U32)
        w1 = jnp.zeros_like(bits_left).astype(U32)
        for k in range(WIN - 1):
            w0 = jnp.where(r == k, win[:, k], w0)
            w1 = jnp.where(r == k, win[:, k + 1], w1)
        v = (w0 >> sh) | ((w1 << U32(1)) << (U32(31) - sh))
        mask = jnp.where(
            n >= 32, U32(0xFFFFFFFF), (U32(1) << jnp.minimum(n, 31).astype(U32)) - U32(1)
        )
        return (v & mask).astype(I32), nl

    def _read_local_wide(win, base_bit, bits_left, n):
        n1 = jnp.maximum(n - 16, 0)
        hi, bits_left = _read_local(win, base_bit, bits_left, n1)
        n2 = jnp.minimum(n, 16)
        lo, bits_left = _read_local(win, base_bit, bits_left, n2)
        return (hi << jnp.minimum(n, 16)) | lo, bits_left

    def pair_body(carry, u):
        (bits_left, st_ll, st_of, st_ml, rep) = carry
        win, base_bit = _fetch_window(bits_left)
        outs = []
        for h in range(_SEQ_PAIR):
            t = u * _SEQ_PAIR + h
            j = cix * stride + t
            active = j < nseq_r
            p_ll, p_of, p_ml = tab3(st_ll, st_of, st_ml)
            ofc, llc, mlc = p_of & 63, p_ll & 63, p_ml & 63
            mlv_p = _lookup_const(mlc, ml_tab)
            llv_p = _lookup_const(llc, ll_tab)
            ofx, bl = _read_local_wide(win, base_bit, bits_left, jnp.where(active, ofc, 0))
            ofv = jnp.where(ofc > 0, (1 << jnp.minimum(ofc, 30)) + ofx, 1)
            mlx, bl = _read_local(win, base_bit, bl, jnp.where(active, mlv_p >> 17, 0))
            ml = (mlv_p & 0x1FFFF) + mlx
            llx, bl = _read_local(win, base_bit, bl, jnp.where(active, llv_p >> 17, 0))
            ll = (llv_p & 0x1FFFF) + llx
            r0, r1, r2 = rep[:, 0], rep[:, 1], rep[:, 2]
            idx = ofv - 1 + (ll == 0).astype(I32)
            off_rep = jnp.where(
                idx == 0, r0,
                jnp.where(idx == 1, r1, jnp.where(idx == 2, r2, jnp.maximum(r0 - 1, 1))),
            )
            is_lit_off = ofv > 3
            off = jnp.where(is_lit_off, ofv - 3, off_rep)
            n1 = jnp.where(is_lit_off, r0, jnp.where(idx == 0, r1, r0))
            n2 = jnp.where(is_lit_off, r1, jnp.where(idx <= 1, r2, r1))
            rep_new = jnp.stack([off, n1, n2], axis=1)
            rep = jnp.where(active[:, None], rep_new, rep)
            upd = active & (j < nseq_r - 1)
            v, bl = _read_local(win, base_bit, bl, jnp.where(upd, (p_ll >> 6) & 15, 0))
            st_ll = jnp.where(upd, (p_ll >> 10) + v, st_ll)
            v, bl = _read_local(win, base_bit, bl, jnp.where(upd, (p_ml >> 6) & 15, 0))
            st_ml = jnp.where(upd, (p_ml >> 10) + v, st_ml)
            v, bl = _read_local(win, base_bit, bl, jnp.where(upd, (p_of >> 6) & 15, 0))
            st_of = jnp.where(upd, (p_of >> 10) + v, st_of)
            bits_left = jnp.where(active, bl, bits_left)
            outs.append((
                jnp.where(active, ll, 0),
                jnp.where(active, ml, 0),
                jnp.where(active, off, 0),
            ))
        ys = tuple(jnp.stack([outs[0][f], outs[1][f]]) for f in range(3))
        return (bits_left, st_ll, st_of, st_ml, rep), ys

    init = (bits_left, st_ll, st_of, st_ml, rep_rows)
    carry, (o_ll, o_ml, o_off) = jax.lax.scan(
        pair_body, init, jnp.arange(stride // _SEQ_PAIR, dtype=I32), unroll=2
    )
    # ys: (stride//2, 2, R) -> (stride, R) in step order
    o_ll = o_ll.reshape(stride, R)
    o_ml = o_ml.reshape(stride, R)
    o_off = o_off.reshape(stride, R)
    return o_ll, o_ml, o_off, carry[4]


@functools.partial(jax.jit, static_argnums=(5,))
def decode_sequences_device(
    streams: jax.Array,      # (B, S) uint8 sequence bitstreams
    total_bits: jax.Array,   # (B,) data bits (sentinel stripped)
    tables: SeqTables,
    nseq: jax.Array,         # (B,)
    rep_init: jax.Array,     # (B, 3) initial repeat offsets
    max_seqs: int,
):
    """Decode interleaved FSE sequences for a batch of blocks (serial chain).

    One bit-serial chain per block, vectorized across the batch; the scan
    length is bucketed by max(nseq) via a batch-level lax.switch (see
    _decode_seqs_core).

    Returns (ll, ml, off, rep_final): (B, max_seqs) resolved values.
    """
    B = streams.shape[0]
    words = _pack_words(streams)

    bmax = jnp.max(nseq)
    buckets = [b for b in (1024, 4096, 16384, 24576, 32768) if b < max_seqs] + [max_seqs]
    bidx = jnp.int32(0)
    for b in buckets[:-1]:
        bidx = bidx + (bmax > b).astype(jnp.int32)

    def mk(msb):
        msb2 = -(-msb // _SEQ_PAIR) * _SEQ_PAIR

        def branch(_):
            o_ll, o_ml, o_off, rep_fin = _decode_seqs_core(
                words, total_bits, tables, nseq, rep_init, None, None, msb2, 1
            )
            padw = ((0, 0), (0, max_seqs - msb2))
            return (
                jnp.pad(o_ll.T, padw),
                jnp.pad(o_ml.T, padw),
                jnp.pad(o_off.T, padw),
                rep_fin,
            )

        return branch

    return jax.lax.switch(bidx, [mk(b) for b in buckets], None)


@functools.partial(jax.jit, static_argnums=(7, 8, 9))
def decode_sequences_device_chunked(
    streams: jax.Array,     # (B, S) uint8 sequence bitstreams
    total_bits: jax.Array,  # (B,) data bits (sentinel stripped)
    tables: SeqTables,
    nseq: jax.Array,        # (B,)
    ck_bits: jax.Array,     # (B, NC-?) checkpoint bit cursors (chunk c -> c-1)
    ck_states: jax.Array,   # (B, NC-?) packed ll | of<<10 | ml<<20
    ck_rep: jax.Array,      # (B, NC-?, 3) exact rep triple before the chunk
    stride: int,            # sequences per chunk (accel metadata stride)
    num_chunks: int,        # static chunk count (>= ceil(max nseq / stride))
    max_seqs: int,
):
    """Chunk-parallel FSE sequence decode from encoder-published checkpoints.

    With decode-acceleration metadata (format/accel.py) every chunk of
    `stride` sequences knows its starting bit cursor, FSE states AND the full
    repeat-offset triple, so the scan runs only `stride` steps over
    B*num_chunks independent rows — the counterpart of the reference's
    speculative chunk-parallel FSE decode (reference
    src/cuda_zstd_fse.cu:2674-3283), but exact instead of speculative.
    Returns (ll, ml, off, rep_final) shaped like the serial decoder
    ((B, max_seqs); rep_final is the initial rep — single-shot frames only).
    """
    B = streams.shape[0]
    NC = num_chunks
    words = _pack_words(streams)

    cix = jnp.tile(jnp.arange(NC, dtype=I32), B)
    first = cix == 0
    ckr = jnp.pad(
        ck_rep,
        ((0, 0), (0, max(0, NC - 1 - ck_rep.shape[1])), (0, 0)),
        constant_values=1,
    )[:, : NC - 1]
    ckr_r = jnp.pad(ckr, ((0, 0), (1, 0), (0, 0)), constant_values=1).reshape(-1, 3)
    rep0 = jnp.where(
        first[:, None], jnp.asarray([[1, 4, 8]], I32), ckr_r.astype(I32)
    )

    o_ll, o_ml, o_off, _ = _decode_seqs_core(
        words, total_bits, tables, nseq, rep0, ck_bits, ck_states, stride, NC
    )

    def resh(a):  # (stride, R) -> (B, NC*stride) -> (B, max_seqs)
        full = a.T.reshape(B, NC, stride).reshape(B, NC * stride)
        if NC * stride >= max_seqs:
            return full[:, :max_seqs]
        return jnp.pad(full, ((0, 0), (0, max_seqs - NC * stride)))

    rep_fin = jnp.tile(jnp.asarray([1, 4, 8], I32)[None, :], (B, 1))
    return resh(o_ll), resh(o_ml), resh(o_off), rep_fin



HUF_TSIZE = 2048  # 1 << HUF_MAX_BITS (11) — literal decode-table capacity


@functools.partial(jax.jit, static_argnums=(5, 6))
def decode_huffman_device(
    streams: jax.Array,      # (R0, SW) uint8 — R0 = B*4 stream rows
    total_bits: jax.Array,   # (R0,) data bits per stream (sentinel stripped)
    dtable: jax.Array,       # (B, HUF_TSIZE) int32 packed (symbol << 4 | nb_bits)
    table_log: jax.Array,    # (B,)
    nsym: jax.Array,         # (R0,) symbols to decode per stream
    stride: int,             # literal symbols per chunk (accel metadata stride)
    num_chunks: int,         # static chunk count (>= ceil(max nsym / stride))
    ck_bits: jax.Array,      # (R0, NC-?) checkpoint bit cursors (chunk c -> c-1)
):
    """Chunk-parallel 4-stream Huffman literal decode on device.

    Counterpart of the reference's GPU 4-stream decoder (reference
    src/cuda_zstd_huffman.cu:1676 `huffman_decode_rfc8878_kernel`, :2204 host
    driver, :1572 jump-table start-bit finder) — but chunked by EXACT
    encoder-published bit cursors (format/accel.py lit_ck records) instead of
    speculative start-bit probing: every chunk of `stride` symbols starts at
    a known cursor, so the bit-serial prefix-decode chain runs only `stride`
    steps over B*4*num_chunks independent rows.

    Decode step (RFC 8878 §4.2.2): peek table_log bits (zero-padded past the
    stream start, like libzstd's shifted-container lookup), look up
    (symbol, nb_bits), consume nb_bits. Returns (R0, num_chunks*stride) uint8
    symbols in forward order (entries >= nsym are zero).
    """
    R0 = streams.shape[0]
    B = dtable.shape[0]
    NC = num_chunks
    R = R0 * NC

    words = _pack_words(streams)
    SW = words.shape[1]
    words_flat = words.reshape(-1)

    row = jnp.repeat(jnp.arange(R0, dtype=I32), NC)       # (R,) stream row
    cix = jnp.tile(jnp.arange(NC, dtype=I32), B * 4)      # (R,)
    first = cix == 0
    ckb = jnp.pad(ck_bits, ((0, 0), (0, max(0, NC - 1 - ck_bits.shape[1]))))[:, : NC - 1]
    ckb_r = jnp.pad(ckb, ((0, 0), (1, 0))).reshape(-1)    # record c-1 at cix=c
    bits_left = jnp.where(first, total_bits[row], ckb_r.astype(I32))

    blk = row >> 2                                         # (R,) block of row
    tl_r = table_log[blk]
    dt_flat = dtable.reshape(-1)
    tab_base = blk * HUF_TSIZE
    nsym_r = nsym[row]
    word_base = row * SW

    WIN = 5  # 8 x <=11-bit steps span <= 88 bits; 5 words always cover them

    def _fetch_window(bits_left):
        top_w = jnp.clip((bits_left - 1) >> 5, 0, SW - 1)
        base_w = jnp.clip(top_w - 3, 0, max(SW - WIN, 0))
        idx = word_base[:, None] + jnp.minimum(
            base_w[:, None] + jnp.arange(WIN, dtype=I32)[None, :], SW - 1
        )
        win = jnp.take(words_flat, idx)
        return win, base_w * 32

    def _peek_local(win, base_bit, bits_left, n):
        """Peek n bits below the cursor, zero-filled past the stream start
        (value << shortfall when bits_left < n — matches
        format/bitstream.py BackwardBitReader.peek_padded)."""
        have = jnp.clip(bits_left, 0, n)
        nl = bits_left - have
        rel = jnp.maximum(nl - base_bit, 0)
        r = jnp.clip(rel >> 5, 0, WIN - 2)
        sh = (rel & 31).astype(U32)
        w0 = jnp.zeros_like(bits_left).astype(U32)
        w1 = jnp.zeros_like(bits_left).astype(U32)
        for k in range(WIN - 1):
            w0 = jnp.where(r == k, win[:, k], w0)
            w1 = jnp.where(r == k, win[:, k + 1], w1)
        v = (w0 >> sh) | ((w1 << U32(1)) << (U32(31) - sh))
        raw = (v & ((U32(1) << have.astype(U32)) - U32(1))).astype(I32)
        return raw << (n - have)

    # G symbols share one 5-word window fetch: each step consumes <= 11 bits,
    # so 8 steps span <= 88 bits and the lowest peek stays >= 40 bits above
    # the window base — window gathers drop from 3/symbol to 5/8 symbols.
    G = 8
    assert stride % G == 0, "literal stride must be a multiple of 8"

    def body(bits_left, t0):
        win, base_bit = _fetch_window(bits_left)
        outs = []
        for g in range(G):
            j = cix * stride + t0 * G + g
            active = j < nsym_r
            idx = _peek_local(win, base_bit, bits_left, tl_r)
            e = jnp.take(dt_flat, tab_base + jnp.clip(idx, 0, HUF_TSIZE - 1))
            sym = e >> 4
            nb = e & 15
            bits_left = jnp.where(active, bits_left - nb, bits_left)
            outs.append(jnp.where(active, sym, 0))
        return bits_left, jnp.stack(outs)

    _, syms = jax.lax.scan(
        body, bits_left, jnp.arange(stride // G, dtype=I32), unroll=2
    )
    # (T, G, R) -> (R, T*G) -> (R0, NC*stride) forward symbol order.
    syms = jnp.transpose(syms, (2, 0, 1)).reshape(R0 * NC, stride)
    return syms.reshape(R0, NC * stride).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnums=(2,))
def assemble_literals_4stream(
    syms: jax.Array,   # (B*4, SEGCAP) uint8 decoded stream symbols
    regen: jax.Array,  # (B,) regenerated literal counts
    out_cap: int,
):
    """Concatenate per-stream symbols into front-compacted (B, out_cap) lits.

    Stream s of block b holds seg = ceil(regen/4) symbols (the 4th the
    remainder); output position p belongs to stream p // seg at offset
    p % seg — one flat gather, no scatters.
    """
    B4, SEGCAP = syms.shape
    B = B4 // 4
    seg = (regen + 3) >> 2
    p = jnp.arange(out_cap, dtype=I32)[None, :]
    seg_b = jnp.maximum(seg, 1)[:, None]
    s = jnp.minimum(p // seg_b, 3)
    j = p - s * seg_b
    rows = (jnp.arange(B, dtype=I32)[:, None] * 4 + s)
    flat_idx = rows * SEGCAP + jnp.clip(j, 0, SEGCAP - 1)
    out = jnp.take(syms.reshape(-1), flat_idx.reshape(-1)).reshape(B, out_cap)
    return jnp.where(p < regen[:, None], out, 0).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnums=(7, 8))
def execute_sequences_device(
    lits: jax.Array,     # (B, L) uint8 literal bytes (front-compacted)
    nlit: jax.Array,     # (B,) total literal count
    ll: jax.Array,       # (B, MS)
    ml: jax.Array,       # (B, MS)
    off: jax.Array,      # (B, MS) resolved offsets
    nseq: jax.Array,     # (B,)
    window: jax.Array,   # (B, W) uint8 decoded history (dictionary / prior blocks)
    out_size: int,
    win_size: int,
    lit_src: tuple | None = None,
):
    """Regenerate block contents (RFC 8878 §3.1.1.4) fully in parallel.

    Returns (out (B, out_size) uint8, out_len (B,)). Matches may reference the
    window (positions before the block) and freshly-written output (overlap
    copies) — both resolved by pointer doubling over the source map.

    lit_src = (syms (B*4, SEGC) uint8, regen (B,)): gather literal bytes
    straight from 4-stream Huffman decoder rows.
    """
    B, MS = ll.shape
    N = out_size
    W = win_size
    k = jnp.arange(MS, dtype=I32)
    valid = k < nseq[:, None]
    llv = jnp.where(valid, ll, 0)
    mlv = jnp.where(valid, ml, 0)

    adv = llv + mlv
    from .scanops import cummax_i32, cumsum_i32

    out_start = cumsum_i32(adv) - adv                  # seq output start
    lit_start = cumsum_i32(llv) - llv                  # seq literal start
    match_start = out_start + llv
    total_seq_out = out_start[:, -1] + adv[:, -1]
    total_lits_used = lit_start[:, -1] + llv[:, -1]

    # is_match per output position via diff array.
    pos = jnp.arange(N, dtype=I32)
    ms_idx = jnp.where(valid & (mlv > 0), match_start, N)
    me_idx = jnp.where(valid & (mlv > 0), match_start + mlv, N)
    diff = jnp.zeros((B, N + 1), I32)
    rows = jnp.arange(B, dtype=I32)[:, None]
    diff = diff.at[rows, ms_idx].add(jnp.where(valid & (mlv > 0), 1, 0), mode="drop")
    diff = diff.at[rows, me_idx].add(jnp.where(valid & (mlv > 0), -1, 0), mode="drop")
    in_match = cumsum_i32(diff[:, :N]) > 0

    # Offset per match position: scatter per-seq offsets at match starts, then
    # index by match-run id.
    seq_of_run = jnp.zeros((B, MS + 1), I32)
    run_rank = cumsum_i32((valid & (mlv > 0)).astype(I32)) - 1
    sidx = jnp.where(valid & (mlv > 0), run_rank, MS)
    seq_of_run = seq_of_run.at[rows, sidx].set(jnp.where(valid, off, 0), mode="drop")
    is_mstart = jnp.zeros((B, N + 1), I32).at[rows, ms_idx].add(
        jnp.where(valid & (mlv > 0), 1, 0), mode="drop"
    )[:, :N]
    run_id = cumsum_i32(is_mstart) - 1
    rb_runs = (jnp.arange(B, dtype=I32) * (MS + 1))[:, None]
    off_at = jnp.take(
        seq_of_run.reshape(-1), (jnp.clip(run_id, 0, MS) + rb_runs).reshape(-1)
    ).reshape(B, N)

    # Literal index per non-match position: j minus match bytes before j.
    match_before = cumsum_i32(in_match.astype(I32)) - in_match.astype(I32)
    lit_idx = pos[None, :] - match_before

    # Source map: literal positions (including tail literals after the last
    # sequence) -> -(lit_idx+1); match at j -> window-inclusive (W + j) - off.
    # Chains through SAME-OFFSET runs are PERIODIC: within a maximal run of
    # match positions sharing one offset (one self-overlapping match, or a
    # string of consecutive sequences that keep extending the same periodic
    # region — the quasi-RLE case that otherwise needs log2(run/off) doubling
    # rounds), every chain step stays in the run until it drops below the run
    # start, so the landing position has the closed form
    # base + (j - base) % off with base = run_start - off. One hop replaces
    # the whole chain (the reference's sequential executor never sees this
    # problem; a parallel one lives or dies by it).
    prev_match = jnp.pad(in_match, ((0, 0), (1, 0)))[:, :N]
    prev_off = jnp.pad(off_at, ((0, 0), (1, 0)), constant_values=-1)[:, :N]
    new_run = in_match & (~prev_match | (off_at != prev_off))
    run_start = cummax_i32(jnp.where(new_run, pos[None, :], 0))
    safe_off = jnp.maximum(off_at, 1)
    base = run_start - safe_off
    hop = jnp.where(
        in_match, base + (pos[None, :] - base) % safe_off, pos[None, :] - off_at
    )
    # lit_src mode: the literal index space is sized by the output (indices
    # translate to stream-row positions at the final gather).
    L = lits.shape[1] if lit_src is None else N
    src = jnp.where(in_match, W + hop, -lit_idx - 1)
    # Window references resolve immediately: encode window byte w in [0, W)
    # as -(L + w) - 1 so the final gather splits the two terminal spaces.
    src = jnp.where(
        (src >= 0) & (src < W), -(L + src) - 1, jnp.where(src >= 0, src - W, src)
    )

    # Pointer doubling: chase match chains to literal/window sources. With the
    # run collapse above, real chains are shallow (depth <= ~100 on a
    # Silesia-like mix -> <= 8 rounds); exit as soon as every source is
    # terminal. Gathers run as FLAT 1-D takes.
    row_base = (jnp.arange(B, dtype=I32) * N)[:, None]

    def _flat_take(v2d, idx2d, width):
        flat_idx = (jnp.clip(idx2d, 0, width - 1) + row_base).reshape(-1)
        return jnp.take(v2d.reshape(-1), flat_idx).reshape(B, N)

    def _unresolved(src):
        return jnp.any(src >= 0)

    def _chase(src):
        chased = _flat_take(src, src, N)
        return jnp.where(src >= 0, chased, src)

    src = jax.lax.while_loop(_unresolved, _chase, src)

    # All sources now terminal (negative). Decode the two spaces.
    term = -src - 1  # literal index or L + window index
    from_window = term >= L
    if lit_src is not None:
        syms, regen = lit_src
        SEGC = syms.shape[1]
        lidx = jnp.clip(term, 0, L - 1)
        seg_b = jnp.maximum((regen.astype(I32) + 3) >> 2, 1)[:, None]
        s = jnp.minimum(lidx // seg_b, 3)
        jj = jnp.clip(lidx - s * seg_b, 0, SEGC - 1)
        srow = jnp.arange(B, dtype=I32)[:, None] * 4 + s
        lit_gather = jnp.take(
            syms.reshape(-1), (srow * SEGC + jj).reshape(-1)
        ).reshape(B, N)
    else:
        row_base_l = (jnp.arange(B, dtype=I32) * L)[:, None]
        lit_gather = jnp.take(
            lits.reshape(-1), (jnp.clip(term, 0, L - 1) + row_base_l).reshape(-1)
        ).reshape(B, N)
    if W > 0:
        row_base_w = (jnp.arange(B, dtype=I32) * W)[:, None]
        win_gather = jnp.take(
            window.reshape(-1),
            (jnp.clip(term - L, 0, max(W - 1, 0)) + row_base_w).reshape(-1),
        ).reshape(B, N)
    else:
        win_gather = jnp.zeros((B, N), jnp.uint8)
    out = jnp.where(from_window, win_gather, lit_gather)
    out_len = total_seq_out + (nlit - total_lits_used)
    return out, out_len
