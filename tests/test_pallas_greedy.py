"""Greedy-parse walk: the Pallas kernel (Triton route, run by the Pallas
interpreter here) and lz77_jax.greedy_scan vs an independent scan."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_zstd import platform
from tpu_zstd.ops import pallas_greedy
from tpu_zstd.ops.lz77_jax import greedy_parse, greedy_scan
from tpu_zstd.ops.pallas_greedy import greedy_segments, greedy_walk

I32 = jnp.int32


def _scan_reference(step, matched, defer, seg):
    """The lax.scan path of greedy_parse (backend-independent)."""
    N = step.shape[0]
    nseg = N // seg
    st = step.reshape(nseg, seg).T
    mt = matched.reshape(nseg, seg).T
    df = defer.reshape(nseg, seg).T

    import jax

    def body(carry, xs):
        na, me = carry
        p, (stp, m, d) = xs
        is_pp = na == p
        take = is_pp & m & ~d
        adv = jnp.where(take, stp, 1)
        new_me = jnp.where(take, p + stp, me)
        new_na = jnp.where(is_pp, p + adv, na)
        is_lit = p >= new_me
        return (new_na, new_me), (take, is_lit)

    p_idx = jnp.arange(seg, dtype=I32)
    init = (jnp.zeros(nseg, I32), jnp.zeros(nseg, I32))
    _, (is_seq_t, is_lit_t) = jax.lax.scan(body, init, (p_idx, (st, mt, df)))
    return np.asarray(is_seq_t.T.reshape(-1)), np.asarray(is_lit_t.T.reshape(-1))


def _case(seed, seg, nseg):
    N = seg * nseg
    rng = np.random.default_rng(seed)
    step = rng.integers(1, seg + 1, N).astype(np.int32)
    matched = (rng.random(N) < 0.3) & (step >= 4)
    defer = (rng.random(N) < 0.1) & matched
    # truncate at segment boundaries like parse_block does
    pos = np.arange(N)
    step = np.minimum(step, seg - (pos % seg))
    packed = step | (matched.astype(np.int32) << 16) | (defer.astype(np.int32) << 17)
    return step, matched, defer, jnp.asarray(packed.reshape(nseg, seg))


@pytest.mark.parametrize("seg,nseg", [(512, 4), (1024, 8), (64, 300)])
def test_kernel_matches_scan(rng, seg, nseg):
    """Partial and whole tiles of segments (300 is not a multiple of the
    128-segment tile); kernel, greedy_scan and the independent scan agree."""
    step, matched, defer, packed = _case(42, seg, nseg)
    ref_seq, ref_lit = _scan_reference(
        jnp.asarray(step), jnp.asarray(matched), jnp.asarray(defer), seg
    )
    for out in (greedy_segments(packed, interpret=True), greedy_scan(packed)):
        out = np.asarray(out).reshape(-1)
        np.testing.assert_array_equal((out & 1) == 1, ref_seq)
        np.testing.assert_array_equal((out & 2) == 2, ref_lit)


def test_vmap_collapse(monkeypatch):
    """Under vmap the kernel runs once over the batch's folded segments."""
    calls = []

    def kernel(packed, interpret=False):
        calls.append(packed.shape)
        return greedy_segments(packed, interpret=True)

    monkeypatch.setattr(pallas_greedy, "greedy_segments", kernel)
    seg, nseg, B = 512, 2, 3
    N = seg * nseg
    rng = np.random.default_rng(7)
    step = rng.integers(1, 5, (B, N)).astype(np.int32)
    pos = np.arange(N)
    step = np.minimum(step, seg - (pos % seg))
    matched = (rng.random((B, N)) < 0.5) & (step >= 4)
    packed = jnp.asarray(step | (matched.astype(np.int32) << 16)).reshape(B, nseg, seg)
    batched = jax.vmap(greedy_walk)(packed)
    assert (B * nseg, seg) in calls
    single = jnp.stack([greedy_scan(packed[b]) for b in range(B)])
    np.testing.assert_array_equal(np.asarray(batched), np.asarray(single))


@pytest.mark.parametrize("gpu", [False, True])
def test_greedy_parse_choice(monkeypatch, gpu):
    """greedy_parse takes the kernel only where the platform module says so;
    both choices give the same parse."""
    calls = []

    def kernel(packed, interpret=False):
        calls.append(packed.shape)
        return greedy_segments(packed, interpret=True)

    monkeypatch.setattr(platform, "use_gpu_kernels", lambda: gpu)
    monkeypatch.setattr(pallas_greedy, "greedy_segments", kernel)
    step, matched, defer, _ = _case(3, 256, 4)
    got = greedy_parse(jnp.asarray(step), jnp.asarray(matched), jnp.asarray(defer), seg=256)
    want = _scan_reference(jnp.asarray(step), jnp.asarray(matched), jnp.asarray(defer), 256)
    np.testing.assert_array_equal(np.asarray(got[0]), want[0])
    np.testing.assert_array_equal(np.asarray(got[1]), want[1])
    assert ((4, 256) in calls) if gpu else not calls
