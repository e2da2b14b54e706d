"""Device-side per-block FSE table construction (RFC 8878 §4.1).

The reference builds custom sequence tables on the GPU (reference
src/cuda_zstd_fse.cu:543 `count_frequencies_kernel`, :721 normalization with
correction, :1022 `FSE_buildCTable_Host`, and the NCount header writer used by
`compress_sequences`); its shipped compressor only EMITS predefined tables
(Tier 1, manager.cu:4939). Measured on our corpus, per-block custom tables
shrink the sequence section ~30% — the single largest ratio lever — so this
module builds them on-device:

- histograms via sort + searchsorted (no scatter)
- normalization to a FIXED table_log of 6 (64 states): largest-remainder with
  exact vectorized repair (sort + cumsum of slack, no data-dependent loops).
  64 states keeps the state-chain pre-pass cost identical to the predefined
  tables while capturing ~98% of the measured custom-table gain (the gain is
  from matching the support of the distribution, not table resolution).
- no low-probability (-1) entries: a -1 and a +1 normalized count both occupy
  one state and cost table_log bits per occurrence, so plain 1 is equivalent.
- symbol spread with the RFC step (ts/2 + ts/8 + 3 = 43): positions form a
  STATIC permutation (no skip states without -1 entries), inverted at trace
  time; the state table falls out of one 64-element sort.
- dense (symbol, state) -> (next_state, nb_bits) tables via the same
  delta_nb_bits / delta_find_state closed forms as format/fse.py:build_ctable,
  evaluated as vector ops; lookups one-hot (values < 256 -> bf16-exact).
- NCount header serialization as a parallel bit-field deposit: field widths
  depend only on the prefix sums of the normalized counts (threshold schedule
  = floor-log2 of the remaining budget), zero-runs attach their repeat
  descriptors to the run head as at-most-two extra fields.

Everything is per block (vmapped by the caller) with static shapes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (
    LL_DEFAULT_LOG,
    LL_DEFAULT_NORM,
    ML_DEFAULT_LOG,
    ML_DEFAULT_NORM,
    OF_DEFAULT_LOG,
    OF_DEFAULT_NORM,
    SEQ_FSE,
    SEQ_PREDEFINED,
    SEQ_RLE,
)

I32 = jnp.int32
U32 = jnp.uint32
BF = jnp.bfloat16

TL = 6                  # fixed custom table log (64 states)
TS = 1 << TL
STEP = (TS >> 1) + (TS >> 3) + 3  # 43, coprime with 64

NSYM_LL = 36
NSYM_OF = 32            # codes up to 31 (offsets < 2^32); predefined covers 29
NSYM_ML = 53

# Static inverse of the spread permutation: SPREAD_INV[p] = rank placed at p.
_pos = (np.arange(TS) * STEP) & (TS - 1)
SPREAD_INV = np.zeros(TS, dtype=np.int32)
SPREAD_INV[_pos] = np.arange(TS, dtype=np.int32)

# Fixed-point log2 (Q8) for values 0..64 (index 0 unused).
LOG2_Q8 = np.round(np.log2(np.maximum(np.arange(TS + 1), 1)) * 256).astype(np.int32)


def _floor_log2(v: jax.Array) -> jax.Array:
    v = v.astype(U32)
    out = jnp.zeros(v.shape, dtype=I32)
    for shift in (4, 2, 1):  # values here are <= 127
        m = v >= (U32(1) << U32(shift))
        out = out + jnp.where(m, shift, 0)
        v = jnp.where(m, v >> U32(shift), v)
    return out


def histogram_matmul(vals: jax.Array, live: jax.Array, nbins: int) -> jax.Array:
    """(nbins,) counts of vals where live — two nibble one-hots + one matrix
    contraction.

    hist[hi*LO + lo] = sum_i oh_hi[i,hi] * oh_lo[i,lo] is a (HI+1, N) @
    (N, LO) matmul, so only N*(HI+1+LO) one-hot compares are built instead
    of N*nbins (8-16x less for byte/code alphabets). bf16 0/1 operands
    accumulated in f32 are exact for counts < 2^24. (The reference counts
    with a scatter, src/cuda_zstd_fse.cu:543; which is faster on the GPU is
    not measured.)"""
    lo_log = 4 if nbins > 64 else 3
    LO = 1 << lo_log
    HI = -(-nbins // LO)
    v = jnp.where(live, vals.astype(I32), HI * LO)  # dedicated exclude row
    hi = v >> lo_log
    lo = v & (LO - 1)
    oh_hi = (hi[:, None] == jnp.arange(HI + 1, dtype=I32)[None, :]).astype(BF)
    oh_lo = (lo[:, None] == jnp.arange(LO, dtype=I32)[None, :]).astype(BF)
    m = jax.lax.dot_general(
        oh_hi, oh_lo, (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # (HI+1, LO)
    return m[:HI].reshape(-1)[:nbins].astype(I32)


def histogram_codes(codes: jax.Array, nvalid: jax.Array, nsym: int) -> jax.Array:
    """(nsym,) counts of codes[:nvalid]."""
    n = codes.shape[0]
    pos = jnp.arange(n, dtype=I32)
    return histogram_matmul(codes, pos < nvalid, nsym)


def normalize_64(cnt: jax.Array, total: jax.Array) -> jax.Array:
    """Normalize counts to sum exactly TS (present symbols >= 1, no -1s).

    Largest-remainder with exact repair; requires >= 2 present symbols and
    total >= 1 (callers gate on npresent — RLE mode covers single-symbol).
    """
    nsym = cnt.shape[0]
    idx = jnp.arange(nsym, dtype=I32)
    present = cnt > 0
    tot = jnp.maximum(total, 1)
    num = cnt * TS
    fl = num // tot
    frac = num - fl * tot
    base = jnp.where(present, jnp.maximum(fl, 1), 0)
    deficit = TS - jnp.sum(base)

    # deficit > 0: +1 to the `deficit` largest remainders (present first).
    key_add = jnp.where(present, -frac, tot + 1)
    _, order = jax.lax.sort((key_add, idx), num_keys=1, is_stable=True)
    _, rank = jax.lax.sort((order, idx), num_keys=1, is_stable=True)
    base_up = base + ((deficit > 0) & present & (rank < deficit)).astype(I32)

    # deficit < 0: remove `need` from the largest bases (slack = base - 1).
    need = jnp.maximum(-deficit, 0)
    slack = jnp.maximum(base - 1, 0)
    keys = jnp.where(present, -base, 1)
    _, s_slack, s_idx = jax.lax.sort((keys, slack, idx), num_keys=1, is_stable=True)
    cum_ex = jnp.cumsum(s_slack) - s_slack
    take_sorted = jnp.clip(need - cum_ex, 0, s_slack)
    _, take = jax.lax.sort((s_idx, take_sorted), num_keys=1, is_stable=True)
    base_down = base - take

    return jnp.where(deficit > 0, base_up, base_down).astype(I32)


def ncount_fields(norm: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Bit fields of the NCount header for `norm` (table_log TL, no -1s).

    Returns (vals (1+3*nsym,) u32, lens (1+3*nsym,) i32, total_bytes).
    Field order matches format/fse.py:write_ncount byte-exactly.
    """
    nsym = norm.shape[0]
    idx = jnp.arange(nsym, dtype=I32)
    nz = norm > 0
    last_nz = jnp.max(jnp.where(nz, idx, -1))

    cum_ex = jnp.cumsum(norm) - norm
    remaining = TS + 1 - cum_ex
    nbb = jnp.minimum(_floor_log2(jnp.clip(remaining, 1, 127)) + 1, TL + 1)
    thr = (1 << (nbb - 1)).astype(I32)
    max_v = 2 * thr - 1 - remaining
    enc = norm + 1
    enc2 = enc + jnp.where(enc >= thr, max_v, 0)
    cwidth = jnp.where(enc2 < max_v, nbb - 1, nbb)

    # Zero-run heads: first zero of a run strictly before the last nonzero.
    prev_nz = jnp.roll(nz, 1).at[0].set(True)
    zero_head = (~nz) & prev_nz & (idx < last_nz)
    emit_cnt = (nz & (idx <= last_nz)) | zero_head
    cwidth = jnp.where(emit_cnt, cwidth, 0)
    cval = jnp.where(emit_cnt, enc2, 0).astype(U32)

    # Next nonzero index after s (suffix min of nonzero positions).
    nzpos = jnp.where(nz, idx, nsym + 64)
    sufmin = jnp.flip(jax.lax.cummin(jnp.flip(nzpos)))
    next_nz = jnp.concatenate([sufmin[1:], jnp.full((1,), nsym + 64, I32)])

    # Repeat descriptor on the head: e extra zeros -> 0xFFFF x (e//24),
    # '3' 2-bit x ((e%24)//3), final 2-bit (e%24)%3. Split into <=2 fields.
    e = jnp.where(zero_head, next_nz - idx - 1, 0)
    b16 = e // 24
    rem = e - b16 * 24
    b3 = rem // 3
    r2 = (rem - b3 * 3).astype(U32)
    ones_run = 16 * b16 + 2 * b3
    tbits = ones_run + 2
    lo_fits = tbits <= 32
    ones_lo = jnp.minimum(ones_run, 30).astype(U32)  # when lo_fits, ones_run <= 30
    lo_val = jnp.where(
        lo_fits, (r2 << ones_lo) | ((U32(1) << ones_lo) - U32(1)), U32(0xFFFFFFFF)
    )
    lo_len = jnp.where(zero_head, jnp.minimum(tbits, 32), 0)
    ones_hi = jnp.clip(ones_run - 32, 0, 16).astype(U32)
    hi_val = (r2 << ones_hi) | ((U32(1) << ones_hi) - U32(1))
    hi_len = jnp.where(zero_head & ~lo_fits, tbits - 32, 0)

    vals = jnp.stack([cval, lo_val, hi_val], axis=1).reshape(-1)
    lens = jnp.stack([cwidth, lo_len, hi_len], axis=1).reshape(-1)
    hdr_val = jnp.full((1,), TL - 5, U32)  # accuracy_log - 5
    hdr_len = jnp.full((1,), 4, I32)
    vals = jnp.concatenate([hdr_val, vals])
    lens = jnp.concatenate([hdr_len, lens])
    total_bytes = (jnp.sum(lens) + 7) // 8
    return vals, lens, total_bytes


def _lut_state(state_table: jax.Array, idx: jax.Array) -> jax.Array:
    """state_table[idx] via one-hot contraction (values < 256 -> bf16 exact)."""
    oh = (idx[..., None] == jnp.arange(TS, dtype=I32)).astype(BF)
    return (oh @ state_table.astype(BF)).astype(I32)


def build_cf_tables(norm: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Closed-form encode-table parameters from normalized counts.

    The FSE encoder transition is fully determined by two per-symbol scalars
    and ONE shared ts-entry table (libzstd's symbolTT closed forms, mirrored
    by format/fse.py:build_ctable):

        value  = ts + state
        nb     = (value + dnb[sym]) >> 16
        state' = state_table[(value >> nb) + dfs[sym]] - ts

    Returns (state_table (TS,) values in [TS, 2*TS), dnb (nsym,),
    dfs (nsym,), init (nsym,) states in [0, TS)).
    """
    cum = jnp.cumsum(norm)
    ranks = jnp.arange(TS, dtype=I32)
    sym_of_rank = jnp.sum((ranks[:, None] >= cum[None, :]).astype(I32), axis=1)
    sym_state = sym_of_rank[jnp.asarray(SPREAD_INV)]  # static gather
    _, st_u = jax.lax.sort((sym_state, ranks), num_keys=1, is_stable=True)
    state_table = TS + st_u  # (TS,) values in [TS, 2*TS)

    cum_ex = cum - norm
    mbo = TL - _floor_log2(jnp.maximum(norm - 1, 1))
    dnb = jnp.where(norm > 0, (mbo << 16) - (norm << mbo), ((TL + 1) << 16) - TS)
    dfs = jnp.where(norm > 0, cum_ex - norm, 0)

    nb0 = (dnb + (1 << 15)) >> 16
    v0 = (nb0 << 16) - dnb
    i0 = jnp.clip((v0 >> nb0) + dfs, 0, TS - 1)
    init = _lut_state(state_table, i0) - TS
    return state_table, dnb, dfs, init


def build_dense_tables(norm: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Dense encode tables from normalized counts (no -1s, sum TS).

    Returns (next2d (nsym, TS), nb2d (nsym, TS), init (nsym,)) matching
    ops/fse_jax.py:EncTables semantics (states in [0, TS)).
    """
    state_table, dnb, dfs, init = build_cf_tables(norm)
    value = TS + jnp.arange(TS, dtype=I32)  # (TS,)
    nb2d = (value[None, :] + dnb[:, None]) >> 16
    idx2d = jnp.clip((value[None, :] >> nb2d) + dfs[:, None], 0, TS - 1)
    next2d = _lut_state(state_table, idx2d) - TS
    return next2d, nb2d, init


# --- Predefined dense tables padded to the custom alphabet shapes -------------------


def _pad_pred(et_next: np.ndarray, et_nb: np.ndarray, et_init: np.ndarray, nsym: int):
    s, ts = et_next.shape
    nxt = np.zeros((nsym, TS), dtype=np.int32)
    nb = np.zeros((nsym, TS), dtype=np.int32)
    init = np.zeros(nsym, dtype=np.int32)
    nxt[:s, :ts] = et_next
    nb[:s, :ts] = et_nb
    init[:s] = et_init
    return nxt, nb, init


def _pred_cost_q8(norm: np.ndarray, table_log: int, nsym: int) -> np.ndarray:
    """Per-symbol expected FSE bit cost (Q8) under a predefined table; symbols
    outside the table get a poison cost (predefined invalid there)."""
    cost = np.full(nsym, 1 << 20, dtype=np.int32)
    eff = np.where(norm == -1, 1, norm).astype(np.int64)
    for s in range(len(norm)):
        if eff[s] > 0:
            cost[s] = table_log * 256 - int(round(np.log2(eff[s]) * 256)) + (
                0 if (1 << table_log) == TS else 0
            )
    return cost


class StreamSpec:
    """Static per-stream data: alphabet size + padded predefined tables."""

    def __init__(self, nsym: int, pred_norm: np.ndarray, pred_log: int, enc):
        self.nsym = nsym
        self.pred_log = pred_log
        self.pred_next, self.pred_nb, self.pred_init = _pad_pred(
            enc.next2d, enc.nb2d, enc.init_state, nsym
        )
        # Closed-form predefined params padded to (nsym,) / (TS,).
        self.pred_dnb = np.zeros(nsym, dtype=np.int32)
        self.pred_dnb[: len(enc.dnb)] = enc.dnb
        self.pred_dfs = np.zeros(nsym, dtype=np.int32)
        self.pred_dfs[: len(enc.dfs)] = enc.dfs
        ts = enc.table_size
        self.pred_st = np.full(TS, ts, dtype=np.int32)
        self.pred_st[:ts] = enc.state_table
        self.pred_cost_q8 = _pred_cost_q8(pred_norm, pred_log, nsym)
        self.pred_valid_mask = np.zeros(nsym, dtype=bool)
        self.pred_valid_mask[: len(pred_norm)] = np.asarray(pred_norm) != 0


def _stream_specs():
    from .fse_jax import predefined_enc_tables

    tl, to, tm = predefined_enc_tables()
    return (
        StreamSpec(NSYM_LL, LL_DEFAULT_NORM, LL_DEFAULT_LOG, tl),
        StreamSpec(NSYM_OF, OF_DEFAULT_NORM, OF_DEFAULT_LOG, to),
        StreamSpec(NSYM_ML, ML_DEFAULT_NORM, ML_DEFAULT_LOG, tm),
    )


_SPECS = None


def stream_specs():
    global _SPECS
    if _SPECS is None:
        _SPECS = _stream_specs()
    return _SPECS


def choose_stream_tables(codes: jax.Array, nvalid: jax.Array, spec: StreamSpec):
    """Pick RLE / custom-FSE / predefined for one stream and build its tables.

    codes: (M,) i32 (first nvalid valid). Returns a dict with
    mode, table_log, st (TS,), dnb (nsym,), dfs (nsym,), init (nsym,)
    (closed-form params, see build_cf_tables),
    desc (bytes of RLE symbol or NCount header as (DESC_CAP,) u8), desc_len.
    """
    nsym = spec.nsym
    cnt = histogram_codes(codes, nvalid, nsym)
    npresent = jnp.sum((cnt > 0).astype(I32))
    norm = normalize_64(cnt, nvalid)
    nc_vals, nc_lens, nc_bytes = ncount_fields(norm)

    # Expected-bit estimates (Q8 fixed point).
    log2_norm = jnp.asarray(LOG2_Q8)[jnp.clip(norm, 0, TS)]
    est_custom = jnp.sum(cnt * (TL * 256 - log2_norm)) // 256 + nc_bytes * 8
    est_pred = jnp.sum(cnt * jnp.asarray(spec.pred_cost_q8)) // 256
    pred_ok = jnp.sum(jnp.where(jnp.asarray(spec.pred_valid_mask), 0, cnt)) == 0

    use_rle = npresent <= 1
    use_custom = ~use_rle & ((~pred_ok) | (est_custom < est_pred))

    cus_st, cus_dnb, cus_dfs, cus_init = build_cf_tables(norm)

    mode = jnp.where(use_rle, SEQ_RLE, jnp.where(use_custom, SEQ_FSE, SEQ_PREDEFINED))
    table_log = jnp.where(use_rle, 0, jnp.where(use_custom, TL, spec.pred_log))

    sel3 = lambda c, p: jnp.where(use_rle, jnp.zeros_like(c), jnp.where(use_custom, c, p))
    st = sel3(cus_st, jnp.asarray(spec.pred_st))
    dnb = sel3(cus_dnb, jnp.asarray(spec.pred_dnb))
    dfs = sel3(cus_dfs, jnp.asarray(spec.pred_dfs))
    init = sel3(cus_init, jnp.asarray(spec.pred_init))

    # Description bytes: RLE -> 1 byte (the symbol); custom -> NCount header.
    from .bitpack import deposit_bits, words_to_bytes

    DESC_CAP = desc_cap(nsym)
    words = deposit_bits(nc_vals, nc_lens, DESC_CAP // 4)[0]
    nc_bytes_arr = words_to_bytes(words)
    rle_sym = jnp.max(jnp.where(jnp.arange(codes.shape[0], dtype=I32) < nvalid, codes, 0))
    desc = jnp.where(
        use_rle,
        jnp.zeros(DESC_CAP, jnp.uint8).at[0].set(rle_sym.astype(jnp.uint8)),
        jnp.where(use_custom, nc_bytes_arr, jnp.zeros(DESC_CAP, jnp.uint8)),
    )
    desc_len = jnp.where(use_rle, 1, jnp.where(use_custom, nc_bytes, 0))
    return {
        "mode": mode,
        "table_log": table_log,
        "st": st,
        "dnb": dnb,
        "dfs": dfs,
        "init": init,
        "desc": desc,
        "desc_len": desc_len,
    }


def desc_cap(nsym: int) -> int:
    """Static byte capacity of one stream's table description."""
    # 4 + nsym * (7 + 34 + 16) bits, rounded up to a multiple of 4 bytes.
    bits = 4 + nsym * 57
    return -(-bits // 32) * 4
