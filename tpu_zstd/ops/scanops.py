"""Blocked exact prefix sums.

Long cumsums are reformulated as 128-wide triangular matmuls (float32 at
Precision.HIGHEST, exact for values below 2^24) plus a short carry cumsum —
the blocked scan the reference's prefix sums get from CUB device primitives
(reference src/cuda_zstd_utils.cu:50 `parallel_scan`). The form dates from
a machine whose `jnp.cumsum` lowering was slow; whether it beats XLA's own
GPU cumsum is not measured.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

I32 = jnp.int32
F32 = jnp.float32

_BLK = 128
# M[i, j] = 1 for i <= j: row-vector @ M gives inclusive prefix sums.
_TRI = np.triu(np.ones((_BLK, _BLK), dtype=np.float32))


def cumsum_i32(x: jax.Array) -> jax.Array:
    """Inclusive prefix sum along the last axis (int32 in/out).

    Exact for |running sums| < 2^24 (f32 integer range) — callers in this
    package sum counts/lengths bounded by the 128 KB block size. Last axis
    must be a multiple of 128 for the fast path; other sizes fall back to
    jnp.cumsum.
    """
    L = x.shape[-1]
    if L % _BLK != 0 or L < 2 * _BLK:
        return jnp.cumsum(x, axis=-1)
    lead = x.shape[:-1]
    xf = x.astype(F32).reshape(*lead, L // _BLK, _BLK)
    blk = jnp.matmul(xf, jnp.asarray(_TRI), precision=jax.lax.Precision.HIGHEST)
    sums = blk[..., -1]                       # (..., L/128) block totals
    if L // _BLK >= 2 * _BLK:                 # recurse on long carry chains
        inc = cumsum_i32(sums.astype(I32)).astype(F32)
    else:
        inc = jnp.cumsum(sums, axis=-1)
    carry = inc - sums                        # exclusive carry per block
    return (blk + carry[..., None]).reshape(*lead, L).astype(I32)


def cummax_i32(x: jax.Array) -> jax.Array:
    """Inclusive prefix max along the last axis (int32 in/out).

    Same blocked structure as cumsum_i32 (XLA's lax.cummax shares the slow
    reduce-window lowering): 7 shift-max steps inside 128-wide blocks, a
    short carry cummax over block maxima, then one combine.
    """
    L = x.shape[-1]
    if L % _BLK != 0 or L < 2 * _BLK:
        return jax.lax.cummax(x, axis=x.ndim - 1)
    lead = x.shape[:-1]
    xb = x.reshape(*lead, L // _BLK, _BLK)
    loc = xb
    for s in (1, 2, 4, 8, 16, 32, 64):
        sh = jnp.concatenate(
            [jnp.full((*loc.shape[:-1], s), jnp.iinfo(jnp.int32).min, I32), loc[..., :-s]],
            axis=-1,
        )
        loc = jnp.maximum(loc, sh)
    tops = loc[..., -1]                       # block maxima
    if L // _BLK >= 2 * _BLK:
        inc = cummax_i32(tops)
    else:
        inc = jax.lax.cummax(tops, axis=tops.ndim - 1)
    prev = jnp.concatenate(
        [jnp.full((*inc.shape[:-1], 1), jnp.iinfo(jnp.int32).min, I32), inc[..., :-1]],
        axis=-1,
    )
    return jnp.maximum(loc, prev[..., None]).reshape(*lead, L)
