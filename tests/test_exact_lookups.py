"""Table lookups must be exact on any backend.

A float32 matrix product may run in TF32 on the GPU, which holds integers
exactly only up to 2^11, while the decode and FSE tables hold values up to
2^22. So the encode and decode stages must contain no float32 dot_general
unless it asks for Precision.HIGHEST, and the gather lookups that replaced
the one-hot contractions must return every table value exactly.
"""

from __future__ import annotations

import functools

import jax
import jax.extend.core as jex_core
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_zstd.ops import decode_jax as D
from tpu_zstd.ops import pipeline as P


def _subjaxprs(v):
    if isinstance(v, jex_core.ClosedJaxpr):
        yield v.jaxpr
    elif isinstance(v, jex_core.Jaxpr):
        yield v
    elif isinstance(v, (tuple, list)):
        for x in v:
            yield from _subjaxprs(x)


def _f32_dots(jaxpr) -> list[str]:
    """Every float32 dot_general in the jaxpr (recursively) whose precision
    is not HIGHEST on both operands."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            dtypes = {v.aval.dtype for v in eqn.invars}
            prec = eqn.params.get("precision")
            precs = prec if isinstance(prec, tuple) else (prec,)
            highest = prec is not None and all(
                p == jax.lax.Precision.HIGHEST for p in precs
            )
            if jnp.dtype(jnp.float32) in dtypes and not highest:
                found.append(str(eqn)[:200])
        for v in eqn.params.values():
            for sub in _subjaxprs(v):
                found += _f32_dots(sub)
    return found


def _jaxpr(fn, *args):
    return jax.make_jaxpr(fn)(*args).jaxpr


def test_detector_sees_a_default_precision_f32_dot():
    a = jnp.ones((4, 4), jnp.float32)
    assert _f32_dots(_jaxpr(lambda x, y: x @ y, a, a))
    assert not _f32_dots(
        _jaxpr(lambda x, y: jnp.matmul(x, y, precision=jax.lax.Precision.HIGHEST), a, a)
    )


@pytest.mark.parametrize("optimal", [False, True])
def test_encode_stages_have_no_inexact_f32_dot(optimal):
    cfg = P.PipelineConfig(
        block_size=4096, hash_log=12, depth=4, cap=16, ckpt_every=64,
        optimal=optimal, min_match=3 if optimal else 4, mf_win_log=10,
    )
    B = 2
    blocks = jnp.zeros((B, cfg.block_size), jnp.uint8)
    lens = jnp.full((B,), cfg.block_size, jnp.int32)
    seqs, _ = jax.eval_shape(functools.partial(P._parse_prep_stage, cfg=cfg), blocks, lens)
    found = _f32_dots(_jaxpr(functools.partial(P._parse_prep_stage, cfg=cfg), blocks, lens))
    seqs = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), seqs)
    found += _f32_dots(_jaxpr(
        lambda b, l, s: P._encode_stage(b, l, s, cfg, 512), blocks, lens, seqs
    ))
    found += _f32_dots(_jaxpr(functools.partial(P.compress_blocks, cfg=cfg), blocks, lens))
    assert not found, found


def test_decode_stages_have_no_inexact_f32_dot():
    B, S, MS, NC, C = 2, 256, 512, 4, 64
    tables = D.SeqTables(*(jnp.zeros((B, 3, D.TSIZE_MAX), jnp.int32) for _ in range(3)),
                         jnp.full((B, 3), 6, jnp.int32))
    streams = jnp.zeros((B, S), jnp.uint8)
    i32 = lambda *shape: jnp.zeros(shape, jnp.int32)  # noqa: E731
    found = _f32_dots(_jaxpr(
        lambda s, t, tb, n, r: D.decode_sequences_device(s, t, tb, n, r, MS),
        streams, i32(B), tables, i32(B), i32(B, 3),
    ))
    found += _f32_dots(_jaxpr(
        lambda s, t, tb, n, a, b, c: D.decode_sequences_device_chunked(
            s, t, tb, n, a, b, c, C, NC, MS),
        streams, i32(B), tables, i32(B), i32(B, NC - 1), i32(B, NC - 1), i32(B, NC - 1, 3),
    ))
    found += _f32_dots(_jaxpr(
        lambda s, t, d, tl, n, ck: D.decode_huffman_device(s, t, d, tl, n, 64, NC, ck),
        jnp.zeros((4 * B, S), jnp.uint8), i32(4 * B), i32(B, D.HUF_TSIZE), i32(B),
        i32(4 * B), i32(4 * B, NC - 1),
    ))
    found += _f32_dots(_jaxpr(
        lambda li, nl, ll, ml, off, n, w: D.execute_sequences_device(
            li, nl, ll, ml, off, n, w, 1024, 256),
        jnp.zeros((B, 1024), jnp.uint8), i32(B), i32(B, MS), i32(B, MS), i32(B, MS),
        i32(B), jnp.zeros((B, 256), jnp.uint8),
    ))
    assert not found, found


@pytest.mark.parametrize("top", [(1 << 11) + 1, (1 << 19) + 3, (1 << 22) - 1])
def test_gather_lookups_exact(top):
    rng = np.random.default_rng(top)
    B, K, S, N = 3, 3, 512, 700
    table = rng.integers(top - 4096, top + 1, (B, K, S)).astype(np.int32)
    state = rng.integers(0, S, (B, K, N)).astype(np.int32)
    got = np.asarray(jax.jit(D._lookup)(jnp.asarray(state), jnp.asarray(table)))
    np.testing.assert_array_equal(got, np.take_along_axis(table, state, axis=2))
    const = table[0, 0, :64]
    idx = state[0, 0] % 64
    got_c = np.asarray(jax.jit(D._lookup_const)(jnp.asarray(idx), jnp.asarray(const)))
    np.testing.assert_array_equal(got_c, const[idx])


def test_fse_chain_symbol_params_exact():
    """dnb values (up to ~2^18.6 at the pipeline's table_log 6) reach the
    state chain unrounded: the chunked chain must match a serial walk over
    the exact integers."""
    from tpu_zstd.ops.fse_jax import _state_chain3_cf

    ts_log, ms = 6, 128
    ts = 1 << ts_log
    K, S = 3, 53
    rng = np.random.default_rng(9)
    st = np.tile(np.arange(ts, 2 * ts, dtype=np.int32)[rng.permutation(ts)], (K, 1))
    # zstd's deltaNbBits: (max bits out << 16) - min state
    dnb = ((rng.integers(1, ts_log + 1, (K, S)) << 16)
           - rng.integers(ts, 2 * ts, (K, S))).astype(np.int32)
    assert dnb.max() > (1 << 18)
    dfs = rng.integers(-ts, ts, (K, S)).astype(np.int32)
    init = rng.integers(0, ts, (K, S)).astype(np.int32)
    rsym = rng.integers(0, S, (K, ms)).astype(np.int32)
    n = ms - 5
    pre, fin, nb = _state_chain3_cf(
        jnp.asarray(st), jnp.asarray(dnb), jnp.asarray(dfs), jnp.asarray(init),
        jnp.full((K,), ts_log, jnp.int32), jnp.zeros((K,), bool), jnp.asarray(rsym),
        jnp.int32(n), ms,
    )
    pre, fin, nb = np.asarray(pre), np.asarray(fin), np.asarray(nb)
    for k in range(K):
        state = int(init[k, rsym[k, 0]])
        for t in range(1, n):
            sym = int(rsym[k, t])
            value = ts + state
            nbt = (value + int(dnb[k, sym])) >> 16
            idx = min(max((value >> nbt) + int(dfs[k, sym]), 0), ts - 1)
            assert pre[k, t] == state and nb[k, t] == nbt, (k, t)
            state = int(st[k, idx]) - ts
        assert fin[k] == state
