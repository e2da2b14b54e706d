"""Data-parallel FSE (tANS) sequence-section encoder (RFC 8878 §3.1.1.3.2), v2.

The ANS state chain is inherently sequential: state_t = T[sym_t, state_{t-1}].
The reference breaks it with a sequential per-chunk state pre-pass on the GPU
(reference src/cuda_zstd_fse_chunk_kernel.cuh:22-70, and the interleaved
single-thread encoder at src/cuda_zstd_fse_encoding_kernel.cu:33). This
formulation exploits the tiny state space of the predefined tables
(table_log <= 6, i.e. <= 64 states):

  Phase A (parallel over chunks): evolve ALL `table_size` possible entry
          states through each chunk's symbols simultaneously — each chunk's
          composed transition function as a (chunks, states) matrix.
  Phase B (tiny scan): thread the real entry state through the chunk functions.
  Phase C (parallel over chunks): re-walk each chunk from its known entry
          state, recording per-step pre-transition states.

Small-table lookups inside the scans use one-hot multiply-reduce in bfloat16
(every value involved is <= 255, which bfloat16 holds exactly, and only one
term of each sum is non-zero); lookups into tables with larger values are
gathers. Bit emission is fully parallel: per-sequence
fields packed into 3 bit-fields, prefix-summed offsets, scatter deposit
(ops/bitpack.py). Everything is jittable with static shapes and vmaps over
blocks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (
    LL_BITS,
    LL_CODE_TABLE,
    LL_DEFAULT_LOG,
    LL_DEFAULT_NORM,
    LL_DELTA_CODE,
    ML_BITS,
    ML_CODE_TABLE,
    ML_DEFAULT_LOG,
    ML_DEFAULT_NORM,
    ML_DELTA_CODE,
    OF_DEFAULT_LOG,
    OF_DEFAULT_NORM,
)
from ..format.fse import build_ctable
from .bitpack import deposit_bits

I32 = jnp.int32
U32 = jnp.uint32
# One-hot contraction dtype: every table value contracted here is <= 255,
# which bfloat16 represents exactly (8 mantissa bits).
F32 = jnp.bfloat16

CHUNK = 64  # sequences per chunk in the state pre-pass (2*CHUNK serial steps)


# --- Encode tables (numpy precompute; tiny, built once at import) -------------------


class EncTables:
    """Dense (symbol, state) -> (next_state, nb_bits) transition tables.

    Stored as NUMPY so the module never pins device buffers at import;
    jnp.asarray at use-sites (inside traces) inlines them as literals.
    """

    def __init__(self, norm: np.ndarray, table_log: int):
        ct = build_ctable(norm, table_log)
        ts = 1 << table_log
        nsym = len(norm)
        u = np.arange(ts, dtype=np.int64)
        value = ts + u  # zstd state "value" range [ts, 2*ts)
        dnb = ct.delta_nb_bits.astype(np.int64)
        dfs = ct.delta_find_state.astype(np.int64)
        nb = (value[None, :] + dnb[:, None]) >> 16  # (nsym, ts)
        idx = (value[None, :] >> nb) + dfs[:, None]
        nxt = ct.state_table.astype(np.int64)[idx] - ts
        # Init state per symbol (FSE_initCState2 semantics).
        nb0 = (dnb + (1 << 15)) >> 16
        v0 = (nb0 << 16) - dnb
        init = ct.state_table.astype(np.int64)[(v0 >> nb0) + dfs] - ts

        self.table_log = table_log
        self.table_size = ts
        self.num_symbols = nsym
        self.next2d = nxt.astype(np.int32)       # (nsym, ts)
        self.nb2d = nb.astype(np.int32)          # (nsym, ts)
        self.init_state = init.astype(np.int32)  # (nsym,)
        # Closed-form params (see fse_tables_jax.build_cf_tables).
        self.dnb = dnb.astype(np.int32)                        # (nsym,)
        self.dfs = dfs.astype(np.int32)                        # (nsym,)
        self.state_table = ct.state_table.astype(np.int32)     # (ts,) in [ts, 2ts)


_PREDEF_ENC = (
    EncTables(LL_DEFAULT_NORM, LL_DEFAULT_LOG),
    EncTables(OF_DEFAULT_NORM, OF_DEFAULT_LOG),
    EncTables(ML_DEFAULT_NORM, ML_DEFAULT_LOG),
)


def predefined_enc_tables() -> tuple[EncTables, EncTables, EncTables]:
    """(LL, OF, ML) encode tables for the RFC 8878 predefined distributions."""
    return _PREDEF_ENC


# --- One-hot lookup helpers (gather-free small-table indexing) ----------------------


def pick_rows(table2d: jax.Array, sym: jax.Array) -> jax.Array:
    """rows[l] = table2d[sym[l]] via one-hot contraction. table2d: (S, K)."""
    S = table2d.shape[0]
    onehot = (sym[..., None] == jnp.arange(S, dtype=sym.dtype)).astype(F32)
    return onehot @ table2d.astype(F32)  # (..., K) float32 (exact for < 2^24)


def pick_cols(rows: jax.Array, idx: jax.Array) -> jax.Array:
    """out[l] = rows[l, idx[l]] via one-hot multiply-reduce. rows: (..., K)."""
    K = rows.shape[-1]
    onehot = (idx[..., None] == jnp.arange(K, dtype=idx.dtype)).astype(F32)
    return jnp.sum(rows * onehot, axis=-1)


def lookup2d(table2d: np.ndarray, sym: jax.Array, idx: jax.Array) -> jax.Array:
    """out[l] = table2d[sym[l], idx[l]], gather-free, int32."""
    rows = pick_rows(jnp.asarray(table2d), sym)
    return pick_cols(rows, idx).astype(I32)


# --- Code mapping (value -> code) ---------------------------------------------------


def highbit32_jnp(v: jax.Array) -> jax.Array:
    """floor(log2(v)) for v >= 1, elementwise (int32 in/out)."""
    v = v.astype(U32)
    out = jnp.zeros(v.shape, dtype=I32)
    for shift in (16, 8, 4, 2, 1):
        m = v >= (U32(1) << U32(shift))
        out = out + jnp.where(m, shift, 0)
        v = jnp.where(m, v >> U32(shift), v)
    return out


def _small_lut(table: np.ndarray, idx: jax.Array) -> jax.Array:
    """Lookup from a tiny (<=128) table via one-hot contraction."""
    t = jnp.asarray(table.astype(np.int32))
    onehot = (idx[..., None] == jnp.arange(t.shape[0], dtype=idx.dtype)).astype(F32)
    return (onehot @ t.astype(F32)).astype(I32)


def ll_code_jnp(ll: jax.Array) -> jax.Array:
    small = ll < 64
    return jnp.where(
        small,
        _small_lut(LL_CODE_TABLE, jnp.minimum(ll, 63)),
        LL_DELTA_CODE + highbit32_jnp(jnp.maximum(ll, 1)),
    )


def ml_code_jnp(ml: jax.Array) -> jax.Array:
    base = ml - 3
    small = base < 128
    return jnp.where(
        small,
        _small_lut(ML_CODE_TABLE, jnp.minimum(base, 127)),
        ML_DELTA_CODE + highbit32_jnp(jnp.maximum(base, 1)),
    )


def of_code_jnp(ob: jax.Array) -> jax.Array:
    return highbit32_jnp(jnp.maximum(ob, 1))


# --- State chains -------------------------------------------------------------------


def _state_chain_rt(
    next2d: jax.Array, init_table: jax.Array, rsym: jax.Array, nseq: jax.Array, max_seqs: int
):
    """States of one FSE stream processed in encoder order (runtime tables).

    next2d: (nsym, ts) traced transition table; init_table: (nsym,) traced.
    rsym[t] = symbol of sequence (nseq-1-t)  (t=0 is the init symbol).
    Transitions consume rsym[t] for t in [1, nseq).

    Returns (pre_states[max_seqs], final_state):
      pre_states[t] = state BEFORE consuming rsym[t]   (valid for 1 <= t < nseq)
      final_state   = state after the last transition (flushed to the stream).
    """
    ts = next2d.shape[1]
    nc = max_seqs // CHUNK

    nsym = init_table.shape[0]
    oh0 = (rsym[0] == jnp.arange(nsym, dtype=I32)).astype(F32)
    init = jnp.sum(oh0 * init_table.astype(F32)).astype(I32)
    # Step s consumes rsym[s+1]; lay steps out as (chunks, CHUNK).
    st_sym = jnp.roll(rsym, -1).reshape(nc, CHUNK)
    t_idx = jnp.arange(max_seqs, dtype=I32).reshape(nc, CHUNK)
    st_valid = (t_idx + 1) < nseq

    # Phase A: per-chunk composed transition over all `ts` entry states.
    def stepA(states, inp):
        sym, valid = inp  # (nc,), (nc,)
        rows = pick_rows(next2d, sym)  # (nc, ts): full transition row per chunk
        onehot = (states[..., None] == jnp.arange(ts, dtype=I32)).astype(F32)
        nxt = jnp.sum(rows[:, None, :] * onehot, axis=-1).astype(I32)  # (nc, ts)
        return jnp.where(valid[:, None], nxt, states), None

    all_states0 = jnp.broadcast_to(jnp.arange(ts, dtype=I32)[None, :], (nc, ts))
    chunk_fn, _ = jax.lax.scan(stepA, all_states0, (st_sym.T, st_valid.T))

    # Phase B: thread the real entry state through chunk functions.
    def stepB(state, fn_row):
        nxt = pick_cols(fn_row.astype(F32), state).astype(I32)
        return nxt, state

    final_state, entries = jax.lax.scan(stepB, init, chunk_fn)

    # Phase C: re-walk each chunk, recording pre-transition states.
    def stepC(states, inp):
        sym, valid = inp
        rows = pick_rows(next2d, sym)
        nxt = pick_cols(rows, states).astype(I32)
        return jnp.where(valid, nxt, states), states

    _, pre_seq = jax.lax.scan(stepC, entries, (st_sym.T, st_valid.T))
    # pre_seq is (CHUNK, nc): state before step s = c*CHUNK + i. Re-index to
    # pre_states[t] = state before consuming rsym[t] (t = s+1).
    pre_by_step = pre_seq.T.reshape(-1)
    pre_states = jnp.roll(pre_by_step, 1)
    return pre_states, final_state


def _state_chain(tables: EncTables, rsym: jax.Array, nseq: jax.Array, max_seqs: int):
    """Static-table (EncTables) wrapper over _state_chain_rt."""
    return _state_chain_rt(
        jnp.asarray(tables.next2d), jnp.asarray(tables.init_state), rsym, nseq, max_seqs
    )


def _state_chain3_cf(
    st3: jax.Array,
    dnb3: jax.Array,
    dfs3: jax.Array,
    init3: jax.Array,
    tl3: jax.Array,
    rle3: jax.Array,
    rsym3: jax.Array,
    nseq: jax.Array,
    max_seqs: int,
):
    """Closed-form triple state chain: LL/OF/ML through one set of scans.

    Replaces the dense (nsym, ts) transition/nb tables of _state_chain3 with
    the libzstd symbolTT closed forms (fse_tables_jax.build_cf_tables):

        value  = ts + state
        nb     = (value + dnb[sym]) >> 16          (pure arithmetic)
        state' = st[(value >> nb) + dfs[sym]] - ts (ONE shared ts-entry table)

    so the only table contraction per step is a TS-wide one-hot against st3,
    and the per-step bit counts fall out of Phase C for free (no separate
    nb-table lookup afterwards).

    st3: (K, TS) state tables (values in [ts, 2ts)); dnb3/dfs3/init3: (K, S);
    tl3: (K,) table logs; rle3: (K,) bool RLE-stream mask (forced to state 0 /
    nb 0); rsym3: (K, max_seqs) symbols in encoder order.

    Returns (pre (K, max_seqs), fin (K,), nb (K, max_seqs)) where nb[., t] is
    the state-bit count of the transition consuming rsym[., t] (valid for
    1 <= t < nseq; garbage elsewhere — callers mask).
    """
    K, S = dnb3.shape
    TS_ = st3.shape[1]
    nc = max_seqs // CHUNK
    ts3 = (1 << tl3).astype(I32)  # (K,)

    # st3 packed 4 byte-entries per i32 word: a TS-wide lookup becomes a
    # 1-of-(TS/4) word select + byte shift (~4x less elementwise work than a TS-wide
    # one-hot contraction; entries are < 128 so bytes never carry a sign).
    NWRD = TS_ // 4
    st_pack = sum(
        (st3[:, b::4] << (8 * b)) for b in range(4)
    )  # (K, NWRD) i32; word j holds entries 4j..4j+3

    # Init state from the first symbol, and per-step symbol params for ALL
    # steps: exact integer gathers (dnb exceeds 2^18).
    init = jnp.take_along_axis(init3, rsym3[:, :1], axis=1, mode="clip")[:, 0].astype(I32)
    init = jnp.where(rle3, 0, init)
    st_sym = jnp.roll(rsym3, -1, axis=1)  # step s consumes rsym[s+1]
    dnb_steps = jnp.take_along_axis(dnb3, st_sym, axis=1, mode="clip").astype(I32)
    dfs_steps = jnp.take_along_axis(dfs3, st_sym, axis=1, mode="clip").astype(I32)

    t_idx = jnp.arange(max_seqs, dtype=I32).reshape(nc, CHUNK)
    nseq_k = jnp.broadcast_to(jnp.asarray(nseq, I32).reshape(-1), (K,))
    valid = ((t_idx + 1)[None] < nseq_k[:, None, None]) & ~rle3[:, None, None]

    def xs_of(a):  # (K, max_seqs) -> (CHUNK, K, nc)
        return a.reshape(K, nc, CHUNK).transpose(2, 0, 1)

    xs = (xs_of(dnb_steps), xs_of(dfs_steps), valid.transpose(2, 0, 1))

    def trans(states, dnb_, dfs_, ts_b, nd):
        """One closed-form transition; states/dnb_/dfs_ broadcastable, ts_b =
        ts3 reshaped to match, nd = extra dims after K. Returns (next, nb)."""
        value = ts_b + states
        nb = (value + dnb_) >> 16
        idx = jnp.clip((value >> jnp.clip(nb, 0, 31)) + dfs_, 0, TS_ - 1)
        w = idx >> 2
        acc = jnp.zeros_like(idx)
        for j in range(NWRD):
            wj = st_pack[:, j].reshape((K,) + (1,) * nd)
            acc = acc + jnp.where(w == j, wj, 0)
        nxt = ((acc >> ((idx & 3) << 3)) & 0xFF) - ts_b
        return nxt, nb

    # Phases A+B: per-chunk ENTRY states by exact fixpoint iteration.
    #
    # (v2 evolved ALL TS_ entry states through every chunk and composed the
    # chunk functions with a log-depth one-hot scan — O(max_seqs * TS_) work,
    # ANS encode transitions
    # contract hard: one step's image has at most freq(sym) states, so a
    # 64-symbol chunk map is almost always a CONSTANT function of its entry.
    # Iterating e[c] <- F[c-1](e[c-1]) from any initial guess therefore
    # reaches the unique fixpoint — the true entry vector — in ~2 passes of
    # O(max_seqs) work each; the while_loop bound of nc+1 passes makes the
    # worst (adversarial, non-contracting) case exact as well, degenerating
    # to sequential chunk chaining. Convergence is checked on real chunks
    # only: chunks past nseq are identity maps whose entries are garbage the
    # callers mask anyway (and would otherwise take one pass per chunk to
    # flush).)
    def chunk_finals(e):  # e (K, nc) entries -> finals after each chunk
        def step(states, inp):
            dnb_, dfs_, v = inp
            nxt, _ = trans(states, dnb_, dfs_, ts3[:, None], 1)
            return jnp.where(v, nxt, states), None

        f, _ = jax.lax.scan(step, e, xs)
        return f

    c_idx = jnp.arange(nc, dtype=I32)
    real = valid.any(axis=2)  # (K, nc) chunk has any live step
    c_last = jnp.max(jnp.where(real, c_idx[None, :], 0), axis=1)  # (K,)

    def fix_cond(carry):
        it, _, done = carry
        return (~done) & (it < nc + 1)

    def fix_body(carry):
        it, e, _ = carry
        f = chunk_finals(e)
        e_new = jnp.concatenate([init[:, None], f[:, :-1]], axis=1)
        done = jnp.all(jnp.where(real, e_new == e, True))
        return it + 1, e_new, done

    e0 = jnp.broadcast_to(init[:, None], (K, nc))
    _, entries, _ = jax.lax.while_loop(
        fix_cond, fix_body, (jnp.zeros((), I32), e0, jnp.zeros((), bool))
    )

    # Phase C: re-walk each chunk from its entry state, recording the
    # pre-transition state AND the transition's bit count. The scan's final
    # carry is the per-chunk final-state vector; the flush state `fin` is the
    # last REAL chunk's final.
    def stepC(states, inp):  # states (K, nc)
        dnb_, dfs_, v = inp
        nxt, nb = trans(states, dnb_, dfs_, ts3[:, None], 1)
        return jnp.where(v, nxt, states), (states, jnp.where(v, nb, 0))

    finals, (pre_seq, nb_seq) = jax.lax.scan(stepC, entries, xs)
    fin = jnp.sum(jnp.where(c_idx[None, :] == c_last[:, None], finals, 0), axis=1)
    fin = jnp.where(rle3, 0, fin)
    # (CHUNK, K, nc): value at step s = c*CHUNK + i -> roll to t = s+1.
    pre = jnp.roll(pre_seq.transpose(1, 2, 0).reshape(K, -1), 1, axis=1)
    nb = jnp.roll(nb_seq.transpose(1, 2, 0).reshape(K, -1), 1, axis=1)
    pre = jnp.where(rle3[:, None], 0, pre)
    return pre, fin, nb


# --- Sequence section encode ---------------------------------------------------------


def encode_sequences_predefined(
    ll: jax.Array,
    ml: jax.Array,
    ob: jax.Array,
    nseq: jax.Array,
    max_seqs: int,
    out_bytes_cap: int,
) -> tuple[jax.Array, jax.Array]:
    """Encode one block's sequences with the predefined FSE tables (mode 0).

    ll/ml/ob: (max_seqs,) int32 (entries >= nseq are ignored)
    Returns (section_bytes[out_bytes_cap + 8] uint8, section_len int32).
    Emission order mirrors format/sequences.py:encode_sequences_bitstream
    (validated against stock libzstd).
    """
    tl, to, tm = predefined_enc_tables()
    ms = max_seqs
    ll = ll.astype(I32)
    ml = ml.astype(I32)
    ob = ob.astype(I32)

    # Reverse to encoder order ONCE: r_x[t] = x[nseq-1-t]. flip is static;
    # the dynamic shift uses log2 static rolls (vmapped jnp.roll with a traced
    # shift would lower to a gather).
    from .bitpack import dynroll

    def rev(x):
        return dynroll(jnp.flip(x), (nseq - ms) % ms, ms)

    r_ll = rev(ll)
    r_ml = rev(ml)
    r_ob = rev(ob)
    r_llc = ll_code_jnp(r_ll)
    r_mlc = ml_code_jnp(r_ml)
    r_ofc = of_code_jnp(r_ob)
    r_llb = _small_lut(LL_BITS, r_llc)
    r_mlb = _small_lut(ML_BITS, r_mlc)
    r_ofb = r_ofc

    pre_ll, fin_ll = _state_chain(tl, r_llc, nseq, ms)
    pre_of, fin_of = _state_chain(to, r_ofc, nseq, ms)
    pre_ml, fin_ml = _state_chain(tm, r_mlc, nseq, ms)

    # Per-step state bit counts and (pre-masked) values; valid for 1 <= t < nseq.
    def state_bits(tables: EncTables, pre, rsym):
        nb = lookup2d(tables.nb2d, rsym, pre)
        val = (tables.table_size + pre) & ((1 << nb.astype(U32)).astype(I32) - 1)
        return nb, val

    nb_ll, v_ll = state_bits(tl, pre_ll, r_llc)
    nb_of, v_of = state_bits(to, pre_of, r_ofc)
    nb_ml, v_ml = state_bits(tm, pre_ml, r_mlc)

    t_ar = jnp.arange(ms, dtype=I32)
    is_step = (t_ar >= 1) & (t_ar < nseq)
    is_seq = t_ar < nseq

    # Three packed fields per t (write order: OF,ML,LL state bits; LL,ML,OF extra):
    mask = lambda v, b: v & ((U32(1) << b.astype(U32)) - U32(1)).astype(I32)
    f1 = v_of | (v_ml << nb_of) | (v_ll << (nb_of + nb_ml))
    l1 = jnp.where(is_step, nb_of + nb_ml + nb_ll, 0)
    f2 = mask(r_ll, r_llb) | (mask(r_ml - 3, r_mlb) << r_llb)
    l2 = jnp.where(is_seq, r_llb + r_mlb, 0)
    f3 = mask(r_ob, r_ofb)
    l3 = jnp.where(is_seq, r_ofb, 0)

    lens = jnp.stack([l1, l2, l3], axis=1).reshape(-1)
    vals = jnp.stack([f1, f2, f3], axis=1).reshape(-1)

    # Tail: flush ML, OF, LL states (table_log bits each) + sentinel 1-bit.
    has = (nseq > 0).astype(I32)
    tail_val = (
        fin_ml
        | (fin_of << tm.table_log)
        | (fin_ll << (tm.table_log + to.table_log))
        | (1 << (tm.table_log + to.table_log + tl.table_log))
    )
    tail_len = has * (tm.table_log + to.table_log + tl.table_log + 1)

    all_lens = jnp.concatenate([lens, tail_len[None]])
    all_vals = jnp.concatenate([vals, tail_val[None]]).astype(U32)

    num_words = out_bytes_cap // 4
    words, total_bits = deposit_bits(all_vals, all_lens, num_words)
    stream_bytes = (total_bits + 7) >> 3

    # Section header: nbSeq varint + mode byte (predefined = 0x00).
    b0 = jnp.where(
        nseq < 128, nseq, jnp.where(nseq < 0x7F00, (nseq >> 8) + 0x80, 255)
    )
    b1 = jnp.where(nseq < 0x7F00, nseq & 0xFF, (nseq - 0x7F00) & 0xFF)
    b2 = ((nseq - 0x7F00) >> 8) & 0xFF
    hdr_len = jnp.where(nseq < 128, 1, jnp.where(nseq < 0x7F00, 2, 3)) + has
    hdr = jnp.zeros(4, dtype=jnp.uint8)
    hdr = hdr.at[0].set(b0.astype(jnp.uint8))
    hdr = hdr.at[1].set(jnp.where(nseq < 128, 0, b1).astype(jnp.uint8))
    hdr = hdr.at[2].set(jnp.where(nseq < 0x7F00, 0, b2).astype(jnp.uint8))
    # (mode byte 0x00 is already zero at position hdr_len-1)

    # Assemble: header at 0, stream bytes rolled to hdr_len (select-based
    # placement — no scatters under vmap).
    from .bitpack import place, words_to_bytes

    stream = words_to_bytes(words)
    out_len_cap = out_bytes_cap + 8
    out = place(hdr, hdr_len, jnp.zeros((), I32), out_len_cap, 1)
    out = out + place(stream, has * stream_bytes, hdr_len, out_len_cap, 4)
    section_len = hdr_len + has * stream_bytes
    return out, section_len


_REP_SRC_TABLE = np.asarray(
    [
        [0, 1, 2],  # inactive / rep0: identity
        [1, 0, 2],  # rep1 read: [r1, r0, r2]
        [2, 0, 1],  # rep2 read: [r2, r0, r1]
        [3, 0, 1],  # insert (literal offset or the r0-1 case): [off, r0, r1]
    ],
    np.int32,
)


def _rep_prefix(
    ob: jax.Array, ll: jax.Array, off: jax.Array, nseq: jax.Array, ms: int
) -> jax.Array:
    """Decoder repcode triple BEFORE each decode step (RFC 8878 §3.1.1.5).

    Every sequence's rep update is either a slot permutation (rep0/1/2 reads)
    or a front insert of a value the encoder already knows (the resolved
    offset — covering both literal offsets and the ll==0 r0-1 case), so the
    prefix over decode steps is an associative composition of tiny
    {permutation | insert} ops: log2(ms) rounds instead of a serial chain.
    Used for decode-acceleration checkpoints (format/accel.py) — chunk
    decoders seed the EXACT triple, making chunk-parallel decode correct for
    arbitrary repcode usage (the reference resolves repcodes in a sequential
    pre-pass instead, reference src/cuda_zstd_sequence.cu:209).

    ob/ll/off are decode-order (ofv value, literal length, resolved offset).
    Returns (ms, 3) int32.
    """
    t = jnp.arange(ms, dtype=I32)
    act = t < nseq
    ob = ob.astype(I32)
    idx = ob - 1 + (ll.astype(I32) == 0).astype(I32)
    is_insert = (ob > 3) | ((ob <= 3) & (idx == 3))
    case = jnp.where(act, jnp.where(is_insert, 3, jnp.clip(idx, 0, 2)), 0)
    src = jnp.asarray(_REP_SRC_TABLE)[case]  # (ms, 3)
    const = jnp.broadcast_to(off.astype(I32)[:, None], (ms, 3))

    def combine(a, b):  # a happens first; result = b after a
        a_src, a_const = a
        b_src, b_const = b
        sel = jnp.clip(b_src, 0, 2)
        g_src = jnp.take_along_axis(a_src, sel, axis=-1)
        g_const = jnp.take_along_axis(a_const, sel, axis=-1)
        return (
            jnp.where(b_src == 3, 3, g_src),
            jnp.where(b_src == 3, b_const, g_const),
        )

    ps, pc = jax.lax.associative_scan(combine, (src, const), axis=0)
    init = jnp.asarray([1, 4, 8], I32)
    rep_after = jnp.where(ps == 3, pc, init[jnp.clip(ps, 0, 2)])
    return jnp.concatenate([init[None, :], rep_after[:-1]], axis=0)


def prepare_sequences_auto(
    ll: jax.Array, ml: jax.Array, ob: jax.Array, nseq: jax.Array, max_seqs: int,
    off: jax.Array | None = None,
) -> dict:
    """Bucket-independent half of the auto sequence encoder.

    Reverses to encoder order, maps codes, and builds per-stream tables
    (RLE / custom-FSE / predefined — ops/fse_tables_jax.py). Everything here
    runs at full max_seqs width so the caller's nseq-bucket switch only has to
    contain the state chains + deposit (smaller compiled graph, no duplicated
    table builds per bucket).
    """
    from .fse_tables_jax import stream_specs, choose_stream_tables
    from .bitpack import dynroll

    spec_ll, spec_of, spec_ml = stream_specs()
    ms = max_seqs
    ll = ll.astype(I32)
    ml = ml.astype(I32)
    ob = ob.astype(I32)

    # Reverse all columns in ONE stacked flip+roll (same shift).
    stacked = jnp.stack([ll, ml, ob])
    rev3 = dynroll(jnp.flip(stacked, axis=-1), (nseq - ms) % ms, ms)
    r_ll, r_ml, r_ob = rev3[0], rev3[1], rev3[2]
    rep_pre = _rep_prefix(ob, ll, off, nseq, ms) if off is not None else None
    r_llc = ll_code_jnp(r_ll)
    r_mlc = ml_code_jnp(r_ml)
    r_ofc = of_code_jnp(r_ob)

    t_ll = choose_stream_tables(r_llc, nseq, spec_ll)
    t_of = choose_stream_tables(r_ofc, nseq, spec_of)
    t_ml = choose_stream_tables(r_mlc, nseq, spec_ml)

    # Stack the three streams (alphabets padded to the largest) so the state
    # chains and nb lookups run in ONE set of scans/contractions.
    S = max(spec_ll.nsym, spec_of.nsym, spec_ml.nsym)

    def padS(a):
        return jnp.pad(a, [(0, S - a.shape[0])] + [(0, 0)] * (a.ndim - 1))

    return {
        "r_ll": r_ll,
        "r_ml": r_ml,
        "r_ob": r_ob,
        "rep_pre": rep_pre,
        "rsym3": jnp.stack([r_llc, r_ofc, r_mlc]),
        "r_llb": _small_lut(LL_BITS, r_llc),
        "r_mlb": _small_lut(ML_BITS, r_mlc),
        "st3": jnp.stack([t["st"] for t in (t_ll, t_of, t_ml)]),
        "dnb3": jnp.stack([padS(t["dnb"]) for t in (t_ll, t_of, t_ml)]),
        "dfs3": jnp.stack([padS(t["dfs"]) for t in (t_ll, t_of, t_ml)]),
        "init3": jnp.stack([padS(t["init"]) for t in (t_ll, t_of, t_ml)]),
        "tl3": jnp.stack([t["table_log"] for t in (t_ll, t_of, t_ml)]),
        "mode3": jnp.stack([t["mode"] for t in (t_ll, t_of, t_ml)]),
        "desc_ll": t_ll["desc"],
        "desc_of": t_of["desc"],
        "desc_ml": t_ml["desc"],
        "dlen3": jnp.stack([t["desc_len"] for t in (t_ll, t_of, t_ml)]),
    }


def encode_prepared(
    prep: dict, nseq: jax.Array, msb: int, out_bytes_cap: int, ckpt_every: int = 0,
):
    """Bucket-sized half: state chains, bit fields, deposit, section assembly.

    msb must be >= nseq (the caller picks the bucket); prep arrays are sliced
    to msb (reversed order puts all live entries in the prefix).

    Returns (section_bytes, section_len) — plus (ckpt_bits (msb//ckpt_every,),
    ckpt_states packed ll|of<<10|ml<<20) when ckpt_every > 0 (decoder
    checkpoints for chunk-parallel decode; entry c-1 describes decode step
    (c)*ckpt_every, zero where that step >= nseq).
    """
    rsym3 = prep["rsym3"][:, :msb]

    from ..constants import SEQ_RLE

    rle3 = prep["mode3"] == SEQ_RLE
    pre3, fin3, nb3_steps = _state_chain3_cf(
        prep["st3"], prep["dnb3"], prep["dfs3"], prep["init3"],
        prep["tl3"], rle3, rsym3, nseq, msb,
    )
    fin_ll, fin_of, fin_ml = fin3[0], fin3[1], fin3[2]

    ts3 = (1 << prep["tl3"]).astype(I32)
    v3 = (ts3[:, None] + pre3) & ((1 << nb3_steps.astype(U32)).astype(I32) - 1)
    nb_ll, nb_of, nb_ml = nb3_steps[0], nb3_steps[1], nb3_steps[2]
    v_ll, v_of, v_ml = v3[0], v3[1], v3[2]

    r_ll = prep["r_ll"][:msb]
    r_ml = prep["r_ml"][:msb]
    r_ob = prep["r_ob"][:msb]
    r_llb = prep["r_llb"][:msb]
    r_mlb = prep["r_mlb"][:msb]
    r_ofb = rsym3[1]

    t_ar = jnp.arange(msb, dtype=I32)
    is_step = (t_ar >= 1) & (t_ar < nseq)
    is_seq = t_ar < nseq

    mask = lambda v, b: v & ((U32(1) << b.astype(U32)) - U32(1)).astype(I32)
    f1 = v_of | (v_ml << nb_of) | (v_ll << (nb_of + nb_ml))
    l1 = jnp.where(is_step, nb_of + nb_ml + nb_ll, 0)
    f2 = mask(r_ll, r_llb) | (mask(r_ml - 3, r_mlb) << r_llb)
    l2 = jnp.where(is_seq, r_llb + r_mlb, 0)
    f3 = mask(r_ob, r_ofb)
    l3 = jnp.where(is_seq, r_ofb, 0)

    lens = jnp.stack([l1, l2, l3], axis=1).reshape(-1)
    vals = jnp.stack([f1, f2, f3], axis=1).reshape(-1)

    if ckpt_every:
        # Decoder checkpoints (chunk-parallel decode, ops/decode_jax.py
        # decode_sequences_device_chunked): at decode step j = c*ckpt_every
        # the decoder's unread-bit cursor is the inclusive prefix of the
        # per-step field bits up to encoder step nseq-1-j, and its three FSE
        # states equal the encoder's pre-transition states at step nseq-j
        # (the encoder walks the same state sequence backward).
        C = ckpt_every
        NC = msb // C
        cum3 = jnp.cumsum(l1 + l2 + l3)
        c_ar = jnp.arange(1, NC + 1, dtype=I32)
        t_c = nseq - c_ar * C  # encoder step of checkpoint c
        ck_valid = t_c >= 1
        ti = jnp.clip(t_c, 1, msb - 1)
        ck_bits = jnp.where(ck_valid, jnp.take(cum3, ti - 1), 0)
        st3_at = jnp.take(pre3, ti, axis=1)  # (3, NC)
        ck_states = jnp.where(
            ck_valid,
            st3_at[0] | (st3_at[1] << 10) | (st3_at[2] << 20),
            0,
        )
        # Exact decoder rep triple before decode step c*C (prepare's
        # associative rep-prefix scan) — chunk decoders seed all three slots,
        # so any rep0/rep1/rep2/ll==0 usage decodes correctly chunk-parallel.
        j_idx = jnp.clip(c_ar * C, 0, prep["rep_pre"].shape[0] - 1)
        ck_rep = jnp.where(
            ck_valid[:, None], jnp.take(prep["rep_pre"], j_idx, axis=0), 1
        )
    else:
        ck_bits = ck_states = ck_rep = None

    has = (nseq > 0).astype(I32)
    tl_l, tl_o, tl_m = prep["tl3"][0], prep["tl3"][1], prep["tl3"][2]
    tail_val = (
        fin_ml
        | (fin_of << tl_m)
        | (fin_ll << (tl_m + tl_o))
        | (1 << (tl_m + tl_o + tl_l))
    )
    tail_len = has * (tl_m + tl_o + tl_l + 1)

    all_lens = jnp.concatenate([lens, tail_len[None]])
    all_vals = jnp.concatenate([vals, tail_val[None]]).astype(U32)

    num_words = out_bytes_cap // 4
    words, total_bits = deposit_bits(all_vals, all_lens, num_words)
    stream_bytes = (total_bits + 7) >> 3

    # nbSeq varint.
    b0 = jnp.where(nseq < 128, nseq, jnp.where(nseq < 0x7F00, (nseq >> 8) + 0x80, 255))
    b1 = jnp.where(nseq < 0x7F00, nseq & 0xFF, (nseq - 0x7F00) & 0xFF)
    b2 = ((nseq - 0x7F00) >> 8) & 0xFF
    nb_len = jnp.where(nseq < 128, 1, jnp.where(nseq < 0x7F00, 2, 3))
    nbseq_hdr = jnp.zeros(4, dtype=jnp.uint8)
    nbseq_hdr = nbseq_hdr.at[0].set(b0.astype(jnp.uint8))
    nbseq_hdr = nbseq_hdr.at[1].set(jnp.where(nseq < 128, 0, b1).astype(jnp.uint8))
    nbseq_hdr = nbseq_hdr.at[2].set(jnp.where(nseq < 0x7F00, 0, b2).astype(jnp.uint8))

    m3 = prep["mode3"]
    mode_byte = ((m3[0] << 6) | (m3[1] << 4) | (m3[2] << 2)).astype(jnp.uint8)

    d_ll = has * prep["dlen3"][0]
    d_of = has * prep["dlen3"][1]
    d_ml = has * prep["dlen3"][2]
    hdr_total = nb_len + has + d_ll + d_of + d_ml

    from .bitpack import place, words_to_bytes

    stream = words_to_bytes(words)
    CAP = out_bytes_cap + 8
    zero = jnp.zeros((), I32)
    out = place(nbseq_hdr, nb_len, zero, CAP, 1)
    out = out + place(mode_byte[None], has, nb_len, CAP, 4)
    out = out + place(prep["desc_ll"], d_ll, nb_len + has, CAP, 4)
    out = out + place(prep["desc_of"], d_of, nb_len + has + d_ll, CAP, 512)
    out = out + place(prep["desc_ml"], d_ml, nb_len + has + d_ll + d_of, CAP, 1024)
    out = out + place(stream, has * stream_bytes, hdr_total, CAP, 2048)
    section_len = hdr_total + has * stream_bytes
    if ckpt_every:
        return out, section_len, ck_bits, ck_states, ck_rep
    return out, section_len


def encode_sequences_auto(
    ll: jax.Array,
    ml: jax.Array,
    ob: jax.Array,
    nseq: jax.Array,
    max_seqs: int,
    out_bytes_cap: int,
) -> tuple[jax.Array, jax.Array]:
    """Encode one block's sequences with per-stream mode selection.

    Each of the LL/OF/ML streams independently picks RLE (single symbol),
    per-block custom FSE tables (ops/fse_tables_jax.py — the reference only
    ships this as unreached Tier-2/3 paths, manager.cu:4864-4974), or the
    predefined tables, by expected-bit estimate. Emission layout mirrors
    encode_sequences_predefined with a wider section header:
    nbseq | mode byte | [LL desc] [OF desc] [ML desc] | bitstream.
    """
    prep = prepare_sequences_auto(ll, ml, ob, nseq, max_seqs)
    return encode_prepared(prep, nseq, max_seqs, out_bytes_cap)
