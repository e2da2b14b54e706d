"""Repcode walk: the lax.scan reference vs the host oracle (unknown-init
variant), and the Pallas kernel (Triton route, run by the Pallas
interpreter here) vs the scan."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_zstd import platform
from tpu_zstd.ops import pallas_rep
from tpu_zstd.ops.pallas_rep import rep_codes, rep_codes_blocks, rep_codes_scan

I32 = jnp.int32


def _oracle(offs, lls):
    """Host walk with UNKNOWN initial history (value, known) pairs."""
    rep = [(0, False), (0, False), (0, False)]

    def known_eq(e, v):
        return e[1] and e[0] == v

    obs = []
    for off, ll in zip(offs, lls):
        off = int(off)
        if ll > 0:
            if known_eq(rep[0], off):
                ob = 1
            elif known_eq(rep[1], off):
                ob, rep = 2, [rep[1], rep[0], rep[2]]
            elif known_eq(rep[2], off):
                ob, rep = 3, [rep[2], rep[0], rep[1]]
            else:
                ob, rep = off + 3, [(off, True), rep[0], rep[1]]
        else:
            if known_eq(rep[1], off):
                ob, rep = 1, [rep[1], rep[0], rep[2]]
            elif known_eq(rep[2], off):
                ob, rep = 2, [rep[2], rep[0], rep[1]]
            elif rep[0][1] and off == rep[0][0] - 1 and off != 0:
                ob, rep = 3, [(off, True), rep[0], rep[1]]
            else:
                ob, rep = off + 3, [(off, True), rep[0], rep[1]]
        obs.append(ob)
    return np.array(obs)


def _pack(offs, lls, valid):
    return jnp.asarray(
        np.where(valid, offs | ((lls > 0) << 21) | (1 << 22), 0), I32
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scan_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    n = 256
    # Few distinct offsets -> lots of rep hits; mixed ll==0 rows.
    offs = rng.choice([5, 9, 17, 400, 401], n).astype(np.int64)
    lls = rng.integers(0, 3, n)
    valid = np.ones(n, bool)
    got = np.asarray(rep_codes_scan(_pack(offs, lls, valid)))
    want = _oracle(offs, lls)
    np.testing.assert_array_equal(got, want)
    assert (want <= 3).sum() > 20  # the case actually exercises repcodes


@pytest.mark.parametrize(
    "S,rows,prefix",
    [(3, 1024, False), (37, 200, True), (32, 64, True), (1, 7, False)],
)
def test_kernel_matches_scan(S, rows, prefix):
    """Whole and partial tiles of blocks, row counts off the unroll, valid
    rows as a prefix (the pipeline's case) or scattered."""
    rng = np.random.default_rng(7 + S)
    offs = rng.choice([4, 8, 100, 101, 7], (S, rows)).astype(np.int64)
    lls = rng.integers(0, 2, (S, rows))
    if prefix:
        valid = np.arange(rows)[None, :] < rng.integers(0, rows + 1, (S, 1))
    else:
        valid = rng.random((S, rows)) < 0.9
    packed = _pack(offs, lls, valid)
    got = np.asarray(rep_codes_blocks(packed, interpret=True))
    want = np.asarray(jax.vmap(rep_codes_scan)(packed))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gpu", [False, True])
def test_rep_codes_choice_under_vmap(monkeypatch, gpu):
    """rep_codes takes the kernel only where the platform module says so,
    and under vmap the kernel takes the whole batch in one call."""
    calls = []

    def kernel(packed, interpret=False):
        calls.append(packed.shape)
        return rep_codes_blocks(packed, interpret=True)

    monkeypatch.setattr(platform, "use_gpu_kernels", lambda: gpu)
    monkeypatch.setattr(pallas_rep, "rep_codes_blocks", kernel)
    rng = np.random.default_rng(5)
    packed = _pack(
        rng.choice([3, 9, 27], (5, 96)).astype(np.int64),
        rng.integers(0, 2, (5, 96)), np.ones((5, 96), bool),
    )
    got = np.asarray(jax.vmap(rep_codes)(packed))
    np.testing.assert_array_equal(got, np.asarray(jax.vmap(rep_codes_scan)(packed)))
    assert ((5, 96) in calls) if gpu else not calls


def test_updates_agree_with_rfc_resolution():
    """Resolving our emitted ob stream with the RFC decoder recovers offsets."""
    rng = np.random.default_rng(3)
    n = 200
    offs = rng.choice([6, 12, 30, 31], n).astype(np.int64)
    lls = rng.integers(0, 3, n)
    obs = _oracle(offs, lls)
    from tpu_zstd.format.sequences import resolve_offset

    rep = [1, 4, 8]
    for ob, off, ll in zip(obs, offs, lls):
        got, rep = resolve_offset(int(ob), int(ll), rep)
        assert got == off
