"""Chunk-parallel FSE state chains vs a serial numpy walk.

fse_jax._state_chain3_cf (chunked fixpoint passes) must be bit-identical to
walking each stream's ANS encoder states one symbol at a time — on the valid
region (steps 1..nseq-1 per block) and in the flush states. Counterpart of
the reference's sequential chunk state pre-pass
(reference src/cuda_zstd_fse_chunk_kernel.cuh:22-70).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_zstd.constants import SEQ_RLE
from tpu_zstd.ops.fse_jax import _state_chain3_cf, prepare_sequences_auto


def _serial_chain(st, dnb, dfs, init, tl, rle, rsym, n):
    """One block's three streams walked serially: (pre, fin, nb)."""
    K, ms = rsym.shape
    pre = np.zeros((K, ms), np.int64)
    nbs = np.zeros((K, ms), np.int64)
    fin = np.zeros(K, np.int64)
    for k in range(K):
        if rle[k]:
            continue
        ts = 1 << int(tl[k])
        state = int(init[k, rsym[k, 0]])
        for t in range(1, n):
            sym = int(rsym[k, t])
            value = ts + state
            nb = (value + int(dnb[k, sym])) >> 16
            idx = min((value >> nb) + int(dfs[k, sym]), st.shape[1] - 1)
            pre[k, t], nbs[k, t] = state, nb
            state = int(st[k, idx]) - ts
        fin[k] = state
    return pre, fin, nbs


def _mk_prep(rng, msb, B):
    cols = []
    nseqs = []
    for _ in range(B):
        n = int(rng.integers(1, msb))
        ll = np.zeros(msb, np.int32)
        ml = np.zeros(msb, np.int32)
        ob = np.zeros(msb, np.int32)
        ll[:n] = rng.integers(0, 40, n)
        ml[:n] = rng.integers(3, 80, n)
        ob[:n] = rng.integers(1, 6000, n)
        cols.append((ll, ml, ob, n))
        nseqs.append(n)
    stacked = [jnp.asarray(np.stack([c[i] for c in cols])) for i in range(3)]
    nseq = jnp.asarray(nseqs, jnp.int32)
    # One jitted program per shape, not one eager dispatch per op.
    prep = jax.jit(jax.vmap(lambda a, b, c, n: prepare_sequences_auto(a, b, c, n, msb)))(
        *stacked, nseq
    )
    return prep, nseq, nseqs


@pytest.mark.parametrize("msb,B", [(256, 4), (1024, 2), (16896, 1), (32768, 1)])
def test_chain_matches_cf(msb, B):
    """Bucket widths from the smallest to the 128 KB block's 32768."""
    rng = np.random.default_rng(msb)
    prep, nseq, nseqs = _mk_prep(rng, msb, B)
    rle3 = prep["mode3"] == SEQ_RLE
    ref = jax.jit(jax.vmap(
        lambda st, dnb, dfs, init, tl, rl, rs, n: _state_chain3_cf(
            st, dnb, dfs, init, tl, rl, rs, n, msb
        )
    ))(
        prep["st3"], prep["dnb3"], prep["dfs3"], prep["init3"], prep["tl3"],
        rle3, prep["rsym3"], nseq,
    )
    p = jax.device_get(prep)
    r = jax.device_get(ref)
    rle = np.asarray(rle3)
    for b in range(B):
        n = nseqs[b]
        pre, fin, nbs = _serial_chain(
            p["st3"][b], p["dnb3"][b], p["dfs3"][b], p["init3"][b], p["tl3"][b],
            rle[b], p["rsym3"][b], n,
        )
        np.testing.assert_array_equal(r[0][b][:, 1:n], pre[:, 1:n])
        np.testing.assert_array_equal(r[1][b], fin)
        np.testing.assert_array_equal(r[2][b][:, 1:n], nbs[:, 1:n])
