"""Multi-chip (virtual 8-device CPU mesh) sharding tests.

The conftest forces XLA_FLAGS=--xla_force_host_platform_device_count=8, so
these run without accelerators.
"""

import numpy as np
import pytest
import zstandard as zstd

import jax


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_compress_roundtrip(rng):
    from tpu_zstd.ops.pipeline import PipelineConfig
    from tpu_zstd.parallel.sharding import compress_blocks_sharded, make_mesh
    from tpu_zstd.format.frame import decompress as host_decompress, write_frame_header

    cfg = PipelineConfig(block_size=2048, hash_log=12, cap=16)
    mesh = make_mesh(8)
    B, N = 16, cfg.block_size
    blocks = np.zeros((B, N), np.uint8)
    lengths = np.zeros(B, np.int32)
    payloads = []
    for b in range(B):
        n = int(rng.integers(64, N + 1))
        payload = (b"sharded-block-%02d " % b) * 64 + rng.integers(0, 256, n, np.uint8).tobytes()
        payload = payload[:n]
        blocks[b, :n] = np.frombuffer(payload, np.uint8)
        lengths[b] = n
        payloads.append(payload)
    contents, clens, btypes = compress_blocks_sharded(blocks, lengths, cfg, mesh)
    dctx = zstd.ZstdDecompressor()
    for b in range(B):
        hdr = write_frame_header(int(lengths[b]))
        btype, clen = int(btypes[b]), int(clens[b])
        if btype == 1:
            frame = hdr + (((int(lengths[b]) << 3) | 2 | 1)).to_bytes(3, "little") + contents[b, :1].tobytes()
        else:
            frame = hdr + (((clen << 3) | (btype << 1) | 1)).to_bytes(3, "little") + contents[b, :clen].tobytes()
        assert dctx.decompress(frame, max_output_size=int(lengths[b])) == payloads[b], f"block {b}"
        assert host_decompress(frame) == payloads[b]


def test_graft_entry_dryrun():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_graft_entry_compile():
    import __graft_entry__ as g

    fn, args = g.entry()
    r = jax.jit(fn)(*args)
    jax.block_until_ready(r)


def test_distributed_batch_over_virtual_mesh(rng):
    """compress_batch_distributed over the 8-device virtual mesh (single
    process; DCN path exercised by the same code on real pods)."""
    import zstandard as zstd

    from tpu_zstd.ops.pipeline import PipelineConfig
    from tpu_zstd.parallel.multihost import compress_batch_distributed

    cfg = PipelineConfig(block_size=2048, hash_log=12, cap=16)
    items = [
        rng.integers(0, 24, int(n), np.uint8).tobytes()
        for n in rng.integers(100, 7000, 9)
    ]
    outs = compress_batch_distributed(items, cfg, checksum=True)
    dctx = zstd.ZstdDecompressor()
    for c, d in zip(outs, items):
        assert dctx.decompress(c, max_output_size=len(d)) == d
