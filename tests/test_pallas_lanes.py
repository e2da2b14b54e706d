"""Chunk-parallel XLA decoders (literals and sequences) vs host decode.

Builds real decode-accelerated frames through the device pipeline (CPU
backend), stages them the way api/decompress.py does, and checks the
chunk-parallel decoders of ops/decode_jax.py (decode_huffman_device,
decode_sequences_device_chunked) byte for byte against the host format
decoder.
"""

from __future__ import annotations

import numpy as np
import pytest

from tpu_zstd.api import decompress as D
from tpu_zstd.api.manager import _bucket
from tpu_zstd.format.frame import parse_frame_header
from tpu_zstd.format.accel import parse_accel_tail


def _mixed_data(n: int, seed: int = 7) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"the quick brown fox ", b"jumps over ", b"lazy dogs and cats ",
             b"0123456789abcdef", b"zstd zstd zstd "]
    parts = []
    total = 0
    while total < n:
        w = words[int(rng.integers(len(words)))]
        parts.append(w)
        total += len(w)
    blob = b"".join(parts)[:n]
    return blob


def _compress_accel(data: bytes):
    """Compress one block via the device pipeline (CPU backend) with accel."""
    from dataclasses import replace

    from tpu_zstd.api.config import CompressionConfig
    from tpu_zstd.api.manager import compress_items_tpu

    cfg = replace(CompressionConfig.from_level(3), decode_accel=True)
    return compress_items_tpu([data], cfg)[0]


@pytest.mark.timeout(600)
def test_huffman_lanes_interpret():
    import jax

    data = _mixed_data(40000)
    frame = _compress_accel(data)
    meta, frame_end = parse_accel_tail(frame)
    if meta is None or meta.lit_stride <= 0:
        pytest.skip("no accel literal metadata emitted by host compressor")
    hdr = parse_frame_header(frame)
    pos = hdr.header_size
    bh = int.from_bytes(frame[pos : pos + 3], "little")
    btype = (bh >> 1) & 3
    if btype != 2:
        pytest.skip("block not compressed")
    body = frame[pos + 3 : pos + 3 + (bh >> 3)]
    parsed = D._parse_litdev(body)
    if parsed is None:
        pytest.skip("literals not 4-stream compressed")
    litdev, consumed, regen = parsed
    CL = meta.lit_stride
    lck = meta.blocks[0][4]
    streams, tbits, nsym, packed, tl_b, _ = litdev
    NCL = _bucket(max(-(-max(nsym) // CL), 1), lo=1)
    sw = max(len(x) for x in streams)
    lstreams = np.zeros((4, sw), np.uint8)
    lck_a = np.zeros((4, max(NCL - 1, 1)), np.int32)
    for r in range(4):
        lstreams[r, : len(streams[r])] = np.frombuffer(streams[r], np.uint8)
        n = min(lck.shape[1], NCL - 1)
        lck_a[r, :n] = lck[r, :n].astype(np.int64).astype(np.int32)
    import jax.numpy as jnp

    from tpu_zstd.ops.decode_jax import decode_huffman_device

    syms = decode_huffman_device(
        jnp.asarray(lstreams), jnp.asarray(np.asarray(tbits, np.int32)),
        jnp.asarray(packed.astype(np.int32)[None]), jnp.asarray([tl_b], np.int32),
        jnp.asarray(np.asarray(nsym, np.int32)), CL, NCL, jnp.asarray(lck_a),
    )
    syms = np.asarray(jax.device_get(syms))
    seg = (regen + 3) // 4
    # Reference: host literal decode.
    from tpu_zstd.format.frame import decode_literals_section

    lits = decode_literals_section(body, None).data
    segs = [lits[i * seg : (i + 1) * seg] for i in range(3)] + [lits[3 * seg :]]
    for s in range(4):
        got = syms[s, : len(segs[s])].tobytes()
        assert got == segs[s], f"stream {s} mismatch"


@pytest.mark.timeout(600)
def test_sequences_lanes_interpret():
    import jax
    import jax.numpy as jnp

    data = _mixed_data(50000, seed=3)
    frame = _compress_accel(data)
    meta, _ = parse_accel_tail(frame)
    if meta is None or meta.stride <= 0 or not meta.blocks:
        pytest.skip("no accel metadata")
    C = meta.stride
    hdr = parse_frame_header(frame)
    pos = hdr.header_size
    bh = int.from_bytes(frame[pos : pos + 3], "little")
    if (bh >> 1) & 3 != 2:
        pytest.skip("block not compressed")
    body = frame[pos + 3 : pos + 3 + (bh >> 3)]
    plan, _, _ = D._parse_block_plan(body, None, None)
    if plan.nbseq == 0:
        pytest.skip("no sequences")
    rec = meta.blocks[0]
    NC = _bucket(max(-(-plan.nbseq // C), 1), lo=1)
    ckb = np.zeros((1, max(NC - 1, 1)), np.int32)
    cks = np.zeros((1, max(NC - 1, 1)), np.int32)
    ckr = np.ones((1, max(NC - 1, 1), 3), np.int32)
    n = min(len(rec[1]), NC - 1)
    ckb[0, :n] = rec[1][:n].astype(np.int64).astype(np.int32)
    cks[0, :n] = rec[2][:n].astype(np.int64).astype(np.int32)
    ckr[0, :n] = rec[3][:n].astype(np.int64).astype(np.int32)
    sym, nb, ns, logs = plan.tables
    from tpu_zstd.ops.decode_jax import SeqTables, decode_sequences_device_chunked

    ll, ml, off, _ = decode_sequences_device_chunked(
        jnp.asarray(np.frombuffer(plan.stream, np.uint8)[None]),
        jnp.asarray([plan.total_bits], np.int32),
        SeqTables(*(jnp.asarray(np.asarray(t)[None]) for t in (sym, nb, ns, logs))),
        jnp.asarray([plan.nbseq], np.int32),
        jnp.asarray(ckb), jnp.asarray(cks), jnp.asarray(ckr), C, NC, D.MAX_SEQS_DEC,
    )
    ll, ml, off = (np.asarray(jax.device_get(a))[0] for a in (ll, ml, off))
    # Reference: host sequence decode with resolved offsets.
    from tpu_zstd.constants import REPCODE_INIT
    from tpu_zstd.format.sequences import decode_sequences_section, resolve_offset

    rest = body[D.decode_literals_section(body, None).consumed :]
    seqs, _, _ = decode_sequences_section(rest, None)
    rep = list(REPCODE_INIT)
    ns = plan.nbseq
    for k in range(ns):
        o, rep = resolve_offset(int(seqs.off_bases[k]), int(seqs.lit_lengths[k]), rep)
        assert ll[k] == seqs.lit_lengths[k], f"ll[{k}]"
        assert ml[k] == seqs.match_lengths[k], f"ml[{k}]"
        assert off[k] == o, f"off[{k}]: {off[k]} != {o}"
