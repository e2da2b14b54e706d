"""Segment-local optimal parse (BTOPT-style DP) for levels 16-22.

Data-parallel re-design of the reference's optimal-parse kernels (reference
src/cuda_zstd_lz77.cu:627 `optimal_parse_kernel`, :897 v2, bit-cost model at
include/cuda_zstd_lz77.h:201-213 `calculate_match_cost`/`calculate_literal_cost`).

Cost model (round 4): prices are measured per block in 1/16-bit fixed point
(SCALE) from a cheap greedy pre-pass — literal entropy, OF-symbol code bits
by offset class, ML-symbol code bits by length — fed in as a per-block cost
bank (one 128-lane take_along_axis row per block: OF-symbol costs at lanes
[0, 32), per-length match costs at lanes [32, 32 + cap - mm]). The earlier
flat model (6-bit literals / 11-bit match base) mispriced text blocks by
1-2 bits per decision and left L16-22 ratio parity at 85-87%.

Exactness: within a segment the DP is exact over the candidate set (per
position, the single best (ml, off) from find_matches, takeable at ANY length
min_match..ml — shortening a match to line up with a cheaper future match is
what greedy cannot do). Matches are truncated at segment boundaries like the
greedy path; the same-offset merge pass re-joins them.

    cost[p] = min( LIT + cost[p+1],
                   min_{l in [mm, ml_p]} mc_p + MLC[l] + cost[p+l] )

The DP runs as one backward lax.scan over the segment axis, elementwise
over every segment of the batch (a hand-written kernel for it is an open
ROADMAP item). Packed input per position:
    ml | ofc << 7 | ml2 << 12 | ofc2 << 19
(ml, ml2 <= 127; ofc <= 31 and ofc2 <= 15 are offset codes of the best and
the best near-band candidate). Output: chosen step per position
(1 = literal, else match length), i32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

I32 = jnp.int32
LANES = 128  # cost-bank row width

SCALE = 16          # fixed-point cost unit: 1/16 bit
LIT_BITS = 6        # default per-literal price when no bank is supplied
MATCH_BASE = 11     # flat LL+ML+OF symbol price (fallback bank)
BIG = 1 << 28


def _mlx(l: int) -> int:
    """Match-length extra bits for length l (RFC 8878 ML code table shape)."""
    if l <= 34:
        return 0
    if l <= 38:
        return 1
    if l <= 46:
        return 2
    if l <= 62:
        return 3
    return 4


def default_cost_bank(mm: int, cap: int):
    """Flat-model bank row (128,): OF-symbol cost at lanes [0, 32) and
    per-length match cost at lanes [32, 32 + cap - mm] (both exclude the
    offset extra bits, added per position from the packed ofc)."""
    import numpy as np

    bank = np.zeros(LANES, np.int32)
    bank[:32] = (MATCH_BASE - 4) * SCALE  # symbol cost w/o length part
    for l in range(mm, cap + 1):
        bank[32 + l - mm] = 4 * SCALE + _mlx(l) * SCALE
    return bank


def _opt_scan(packed: jax.Array, lit_bits: jax.Array, bank: jax.Array,
              mm: int, cap: int) -> jax.Array:
    """lax.scan reference DP (backend-independent): packed (S, seg) -> steps."""
    S, seg = packed.shape
    x = packed.T  # (seg, S)
    ml = x & 127
    ofc = (x >> 7) & 31
    ml2 = (x >> 12) & 127
    ofc2 = (x >> 19) & 15
    of_sym = jnp.take_along_axis(bank, ofc.T, axis=1).T
    mc = of_sym + ofc * SCALE
    of_sym2 = jnp.take_along_axis(bank, ofc2.T, axis=1).T
    mc2 = of_sym2 + ofc2 * SCALE
    mlc = [bank[:, 32 + l - mm] for l in range(mm, cap + 1)]

    def step(window, inp):
        # window[j] = cost[p + 1 + j] for j in [0, cap]
        ml_p, mc_p, ml2_p, mc2_p = inp
        best = lit_bits + window[0]
        chosen = jnp.ones((S,), I32)
        for li, l in enumerate(range(mm, cap + 1)):
            c = jnp.where(ml_p >= l, mc_p + mlc[li] + window[l - 1], BIG)
            c2 = jnp.where(ml2_p >= l, mc2_p + mlc[li] + window[l - 1], BIG)
            c = jnp.minimum(c, c2)
            take = c < best
            best = jnp.where(take, c, best)
            chosen = jnp.where(take, l, chosen)
        new_window = jnp.concatenate([best[None], window[:-1]], axis=0)
        return new_window, chosen

    w0 = jnp.zeros((cap + 1, S), I32)
    _, steps = jax.lax.scan(step, w0, (ml[::-1], mc[::-1], ml2[::-1], mc2[::-1]))
    return steps[::-1].T  # (S, seg)


def opt_steps(packed: jax.Array, mm: int, cap: int,
              lit_bits: jax.Array | None = None,
              cost_bank: jax.Array | None = None) -> jax.Array:
    """DP over (S, seg) packed segments -> (S, seg) chosen steps
    (1 = literal, else take the match at that length).

    lit_bits: per-segment-row literal price in SCALE units (1/16 bit) —
    e.g. measured literal entropy plus amortized LL-symbol cost. Scalar rows
    broadcast. cost_bank: per-row (128,) cost bank (see default_cost_bank);
    rows belonging to one block share one bank.
    """
    import numpy as np

    S = packed.shape[0]
    if lit_bits is None:
        lit_bits = jnp.full((S,), LIT_BITS * SCALE, I32)
    else:
        lit_bits = jnp.broadcast_to(lit_bits.astype(I32), (S,))
    if cost_bank is None:
        cost_bank = jnp.broadcast_to(
            jnp.asarray(default_cost_bank(mm, cap)), (S, LANES)
        )
    else:
        cost_bank = jnp.broadcast_to(cost_bank.astype(I32), (S, LANES))
    return _opt_scan(packed, lit_bits, cost_bank, mm, cap)
