"""Decode-acceleration metadata (format/accel.py) + chunk-parallel decode.

The encoder publishes FSE decoder checkpoints in a TRAILING skippable frame;
stock libzstd must keep decoding the frames unchanged, and the chunked device
decoder must reproduce the serial decoder's output bit-exactly.
"""

from dataclasses import replace

import numpy as np
import pytest
import zstandard

from tpu_zstd.api.config import CompressionConfig
from tpu_zstd.api.decompress import decompress_batch_to_device
from tpu_zstd.api.manager import compress_items_tpu
from tpu_zstd.format.accel import parse_accel_tail, write_accel_frame

N = 16384


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0xACCE1)
    words = [b"alpha", b"beta", b"gamma", b"delta-delta", b"epsilon"]
    items = []
    for _ in range(3):
        parts = [words[int(x) % 5] for x in rng.integers(0, 5, 2200)]
        items.append(b" ".join(parts)[:N])
    items.append(rng.integers(0, 256, N, dtype=np.uint8).tobytes())  # raw block
    items.append(b"abcd" * (N // 4))  # periodic
    items.append(b"z" * N)  # RLE block
    items.append(b"short payload")
    # rep0-heavy: fixed motif at a constant period with varying literal gaps,
    # so rep0 sequences land on chunk boundaries (regression: chunk decoders
    # must seed r0 from the checkpoint, not the default history).
    rep = bytearray()
    while len(rep) < N:
        rep += bytes(rng.integers(0, 256, 10, dtype=np.uint8)) + b"MOTIF-MOTIF-XY"
    items.append(bytes(rep[:N]))
    return items


@pytest.fixture(scope="module")
def accel_frames(corpus):
    cfg = replace(CompressionConfig.from_level(3), block_size=N, decode_accel=True)
    return compress_items_tpu(corpus, cfg)


def test_metadata_roundtrip():
    # v4 wire format delta-encodes the checkpoint cursors, which DECREASE
    # with the chunk index (they count unread bits); synthetic data must
    # respect that invariant like the encoder does.
    bits = np.asarray([90000, 89000, 88000], np.uint32)
    states = np.asarray([7 | (9 << 10) | (11 << 20)] * 3, np.uint32)
    reps = np.asarray([[17, 42, 9000], [1, 4, 8], [5, 17, 42]], np.uint32)
    lit_ck = np.asarray(
        [[8000, 7000], [6000, 5500], [4000, 3999], [2000, 1000]], np.uint32
    )
    frame = write_accel_frame(
        64,
        [(777, bits, states, reps, lit_ck), (0, bits[:0], states[:0], reps[:0])],
    )
    meta, end = parse_accel_tail(b"PREFIX" + frame)
    assert meta is not None and end == 6
    assert meta.stride == 64
    assert len(meta.blocks) == 2
    nseq, b, s, r, lc = meta.blocks[0]
    assert nseq == 777 and np.array_equal(b, bits) and np.array_equal(s, states)
    assert np.array_equal(r, reps)
    assert np.array_equal(lc, lit_ck)
    assert meta.blocks[1][0] == 0 and len(meta.blocks[1][1]) == 0
    assert meta.blocks[1][4].shape == (4, 0)
    # Not-our-data tails parse as absent, not as errors.
    assert parse_accel_tail(b"")[0] is None
    assert parse_accel_tail(b"\x00" * 40)[0] is None
    assert parse_accel_tail(frame[:-1])[0] is None


def test_libzstd_ignores_trailing_metadata(corpus, accel_frames):
    d = zstandard.ZstdDecompressor()
    for item, frame in zip(corpus, accel_frames):
        meta, end = parse_accel_tail(frame)
        if len(item) > 64:  # tiny items may skip the device path's metadata
            assert meta is not None
        assert d.decompress(frame, max_output_size=len(item)) == item


def test_chunked_device_decode_bit_exact(corpus, accel_frames):
    out, lens = decompress_batch_to_device(accel_frames, max_block=N)
    out = np.asarray(out)
    lens = np.asarray(lens)
    for i, item in enumerate(corpus):
        assert lens[i] == len(item)
        assert bytes(out[i][: len(item)]) == item


def test_prepared_plan_repeated_executes(corpus, accel_frames):
    """DecompressPlan: parse/upload once, execute() is repeatable and exact
    (the reference's preallocated repeated-decode pattern, manager.h:193-273)."""
    from tpu_zstd.api.decompress import prepare_decompress_batch

    plan = prepare_decompress_batch(accel_frames, max_block=N)
    for _ in range(2):
        out, lens = plan.execute()
        out = np.asarray(out)
        lens = np.asarray(lens)
        for i, item in enumerate(corpus):
            assert lens[i] == len(item)
            assert bytes(out[i][: len(item)]) == item


def test_device_huffman_literal_decode():
    """4-stream Huffman literals decode fully on device from published
    cursors (no host literal decode, no decoded-literal upload)."""
    N = 65536
    rng = np.random.default_rng(3)
    item = bytearray(rng.integers(97, 123, N, dtype=np.uint8).tobytes())
    for k in range(0, N - 64, 4096):
        item[k : k + 32] = item[0:32]
    item = bytes(item)
    cfg = replace(CompressionConfig.from_level(3), block_size=N, decode_accel=True)
    frames = compress_items_tpu([item], cfg)
    meta, _ = parse_accel_tail(frames[0])
    assert meta.blocks[0][4].shape[0] == 4 and meta.blocks[0][4].shape[1] > 0
    assert zstandard.ZstdDecompressor().decompress(frames[0], max_output_size=N) == item
    out, lens = decompress_batch_to_device(frames, max_block=N)
    assert np.asarray(lens)[0] == len(item)
    assert bytes(np.asarray(out)[0][: len(item)]) == item


def test_device_huffman_kernel_vs_host():
    """decode_huffman_device matches the host stream decoder symbol-for-
    symbol, including the zero-padded peeks near the stream start."""
    import jax.numpy as jnp

    from tpu_zstd.format import huffman as huf
    from tpu_zstd.ops.decode_jax import decode_huffman_device

    rng = np.random.default_rng(11)
    data = rng.integers(0, 40, 3000, dtype=np.uint8).tobytes()
    freqs = np.bincount(np.frombuffer(data, np.uint8), minlength=256).astype(np.int64)
    ct = huf.build_ctable(freqs)
    enc = huf.encode_stream(data, ct)
    weights, _ = huf.parse_weights(ct.header)
    dt = huf.build_dtable(weights)
    packed = np.zeros((1, 2048), np.int32)
    packed[0, : 1 << dt.table_log] = (dt.symbol << 4) | dt.nb_bits
    sentinel = enc[-1].bit_length() - 1
    tbits = (len(enc) - 1) * 8 + sentinel
    C = 64
    NCL = -(-len(data) // C)
    # cursors: bits_left before forward symbol c*C
    lens_per = ct.lengths[np.frombuffer(data, np.uint8)]
    cume = np.concatenate([[0], np.cumsum(lens_per)])
    cks = np.asarray(
        [tbits - cume[c * C] for c in range(1, NCL)], np.int32
    )[None, :]
    streams = np.zeros((4, 4096), np.uint8)
    streams[0, : len(enc)] = np.frombuffer(enc, np.uint8)
    syms = decode_huffman_device(
        jnp.asarray(streams),
        jnp.asarray([tbits, 0, 0, 0], np.int32),
        jnp.asarray(packed),
        jnp.asarray([dt.table_log], np.int32),
        jnp.asarray([len(data), 0, 0, 0], np.int32),
        C,
        NCL,
        jnp.asarray(np.concatenate([cks, np.zeros((3, NCL - 1), np.int32)])),
    )
    got = bytes(np.asarray(syms)[0][: len(data)])
    assert got == data


def test_serial_path_unchanged(corpus):
    cfg = replace(CompressionConfig.from_level(3), block_size=N, decode_accel=False)
    frames = compress_items_tpu(corpus, cfg)
    for f in frames:
        assert parse_accel_tail(f)[0] is None
    out, lens = decompress_batch_to_device(frames, max_block=N)
    out = np.asarray(out)
    for i, item in enumerate(corpus):
        assert bytes(out[i][: len(item)]) == item
