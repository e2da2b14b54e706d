"""Device sequence executor vs the host format-layer executor.

The reference executes sequences with a sequential per-block kernel
(reference src/cuda_zstd_sequence.cu:347); ops/decode_jax.py's
execute_sequences_device resolves every output byte in parallel by pointer
doubling. These tests require bit-identity with the sequential host
executor (format/sequences.execute_sequences) on randomized sequence sets
covering overlap copies (off < ml), window references, tail literals, and
zero-sequence blocks.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tpu_zstd.format.sequences import Sequences, execute_sequences
from tpu_zstd.ops.decode_jax import execute_sequences_device


def _host_rows(lits, nlit, ll, ml, off, nseq, window, W):
    """Per-row host execution; offsets are spelled out (off_base = off + 3)."""
    outs = []
    for b in range(len(nseq)):
        n = int(nseq[b])
        seqs = Sequences(
            ll[b, :n].astype(np.uint32), ml[b, :n].astype(np.uint32),
            (off[b, :n] + 3).astype(np.uint32), 0,
        )
        win = window[b, :W].tobytes() if W else b""
        out, _ = execute_sequences(lits[b, : nlit[b]].tobytes(), seqs, [1, 4, 8], window=win)
        outs.append(out)
    return outs


def _check(args_np, W, N):
    args = tuple(jnp.asarray(x) for x in args_np)
    got_out, got_len = execute_sequences_device(*args, out_size=N, win_size=W)
    want = _host_rows(*args_np, W)
    got_out, got_len = np.asarray(got_out), np.asarray(got_len)
    for b, w in enumerate(want):
        assert int(got_len[b]) == len(w), f"row {b} length"
        assert got_out[b, : len(w)].tobytes() == w, f"row {b}"


def _random_case(rng, B, N, W, MS, L):
    """Build valid (lits, nlit, ll, ml, off, nseq, window) filling <= N out."""
    ll = np.zeros((B, MS), np.int32)
    ml = np.zeros((B, MS), np.int32)
    off = np.ones((B, MS), np.int32)
    nseq = np.zeros(B, np.int32)
    nlit = np.zeros(B, np.int32)
    lits = np.zeros((B, L), np.uint8)
    window = rng.integers(0, 256, (B, max(W, 1)), dtype=np.uint8)
    for b in range(B):
        ns = int(rng.integers(0, MS + 1))
        out_pos = 0
        lit_pos = 0
        s = 0
        for _ in range(ns):
            llv = int(rng.integers(0, 20))
            mlv = int(rng.integers(3, 40))
            if out_pos + llv + mlv > N - 20 or lit_pos + llv > L - 30:
                break
            # offset may reach back into the window
            max_off = out_pos + llv + (W if W > 0 else 0)
            if max_off < 1:
                continue
            ofv = int(rng.integers(1, max_off + 1))
            ll[b, s], ml[b, s], off[b, s] = llv, mlv, ofv
            out_pos += llv + mlv
            lit_pos += llv
            s += 1
        nseq[b] = s
        tail = int(rng.integers(0, min(20, L - lit_pos)))
        nlit[b] = lit_pos + tail
        lits[b, : nlit[b]] = rng.integers(0, 256, nlit[b], dtype=np.uint8)
    return lits, nlit, ll, ml, off, nseq, window


@pytest.mark.parametrize("W", [0, 256])
def test_matches_xla_executor(rng, W):
    B, N, MS, L = 5, 2048, 48, 1024
    _check(_random_case(rng, B, N, W, MS, L), W, N)


def test_overlap_rle_and_empty(rng):
    # off=1 RLE expansion, off<ml overlap doubling, and an all-literal block.
    B, N, MS, L, W = 8, 1024, 8, 512, 0
    ll = np.zeros((B, MS), np.int32)
    ml = np.zeros((B, MS), np.int32)
    off = np.ones((B, MS), np.int32)
    nseq = np.zeros(B, np.int32)
    nlit = np.zeros(B, np.int32)
    lits = np.zeros((B, L), np.uint8)
    # row 0: 4 literals then 500-byte off=1 RLE
    lits[0, :4] = [1, 2, 3, 4]
    ll[0, 0], ml[0, 0], off[0, 0], nseq[0], nlit[0] = 4, 500, 1, 1, 4
    # row 1: off=3 overlap over 301 bytes
    lits[1, :3] = [9, 8, 7]
    ll[1, 0], ml[1, 0], off[1, 0], nseq[1], nlit[1] = 3, 301, 3, 1, 3
    # row 2: literals only
    nlit[2] = 100
    lits[2, :100] = np.arange(100, dtype=np.uint8)
    # row 3: chained same-offset runs (consecutive seqs keep one period)
    lits[3, :2] = [5, 6]
    ll[3, 0], ml[3, 0], off[3, 0] = 2, 64, 2
    ll[3, 1], ml[3, 1], off[3, 1] = 0, 64, 2
    nseq[3], nlit[3] = 2, 2
    window = np.zeros((B, 1), np.uint8)
    _check((lits, nlit, ll, ml, off, nseq, window), W, N)
