"""API-surface tests: Manager / BatchManager / StreamingManager / Hybrid.

Mirrors the reference's python/tests/test_basic.py coverage (round-trips,
batch, Manager lifecycle, hybrid routing, validation helpers) with the
libzstd interop oracle throughout.
"""

import numpy as np
import pytest
import zstandard as zstd

import tpu_zstd
from tpu_zstd import (
    BatchManager,
    CompressionConfig,
    ChecksumPolicy,
    ExecutionPath,
    HybridConfig,
    HybridEngine,
    HybridResult,
    Manager,
    RoutingMode,
    Status,
    StreamingManager,
    Strategy,
)

SMALL = CompressionConfig.from_level(3)
SMALL.block_size = 4096
SMALL.hash_log = 13


@pytest.fixture(scope="module")
def dctx():
    return zstd.ZstdDecompressor()


def test_oneshot_roundtrip(corpus, dctx):
    for name, data in corpus.items():
        if name == "multiblock":
            continue
        c = tpu_zstd.compress(data, level=3)
        assert dctx.decompress(c, max_output_size=max(len(data), 1)) == data, name
        assert tpu_zstd.decompress(c) == data, name


def test_manager_stats_and_paths(corpus):
    with Manager(config=SMALL, execution_path=ExecutionPath.TPU_BATCH) as m:
        data = corpus["text"]
        c = m.compress(data)
        assert m.decompress(c) == data
        assert m.stats.total_input_bytes == len(data)
        assert m.stats.total_output_bytes == len(c)
        assert m.stats.ratio > 1.0
        assert m.stats.total_compress_calls == 1


def test_manager_cpu_path(corpus, dctx):
    with Manager(level=3, execution_path=ExecutionPath.CPU) as m:
        data = corpus["mixed"]
        c = m.compress(data)
        assert dctx.decompress(c, max_output_size=len(data)) == data


def test_batch_manager(corpus, dctx):
    items = [corpus["text"], corpus["rle"], corpus["random_4k"], b"", b"x"]
    with BatchManager(config=SMALL) as bm:
        res = bm.compress_batch(items)
        for it, orig in zip(res, items):
            assert it.status == Status.SUCCESS
            assert dctx.decompress(it.output, max_output_size=max(len(orig), 1)) == orig
        dec = bm.decompress_batch([it.output for it in res])
        for it, orig in zip(dec, items):
            assert it.output == orig


def test_batch_large(dctx, rng):
    items = [
        rng.integers(0, 32, rng.integers(100, 9000), dtype=np.uint8).tobytes()
        for _ in range(37)
    ]
    outs = tpu_zstd.compress_batch(items, level=1)
    for c, orig in zip(outs, items):
        assert dctx.decompress(c, max_output_size=len(orig)) == orig


def test_streaming_manager(dctx):
    sm = StreamingManager(config=SMALL)
    chunks = [b"first chunk of streaming data " * 100,
              b"second chunk >>> " * 200,
              b"",
              b"final chunk." * 50]
    out = bytearray()
    for ch in chunks:
        out += sm.compress_chunk(ch)
    out += sm.flush()
    expect = b"".join(chunks)
    assert dctx.decompress(bytes(out), max_output_size=len(expect)) == expect
    # reset starts a fresh frame
    sm.reset()
    out2 = sm.compress_chunk(b"fresh") + sm.flush()
    assert dctx.decompress(bytes(out2), max_output_size=5) == b"fresh"


def test_streaming_checksum(dctx):
    cfg = CompressionConfig.from_level(3)
    cfg.block_size = 4096
    cfg.hash_log = 13
    cfg.checksum = ChecksumPolicy.COMPUTE
    sm = StreamingManager(config=cfg)
    data = b"checksummed streaming payload " * 300
    out = sm.compress_chunk(data) + sm.flush()
    assert dctx.decompress(out, max_output_size=len(data)) == data


def test_hybrid_routing(corpus):
    eng = HybridEngine(HybridConfig(mode=RoutingMode.AUTO),
                       compression=SMALL)
    res = HybridResult()
    small = corpus["short_text"]
    c = eng.compress(small, result=res)
    assert res.backend == tpu_zstd.Backend.CPU_LIBZSTD
    assert "CPU" in res.routing_reason or "host" in res.routing_reason
    assert eng.decompress(c) == small

    eng_forced = HybridEngine(HybridConfig(mode=RoutingMode.FORCE_TPU), compression=SMALL)
    res2 = HybridResult()
    c2 = eng_forced.compress(small, result=res2)
    assert res2.backend == tpu_zstd.Backend.TPU_KERNELS
    assert eng_forced.decompress(c2) == small


def test_hybrid_decompress_routing(corpus):
    """Host-bound decodes route to CPU libzstd (a rule set on another
    accelerator, not measured on the H100; round-3 review weak #1 flagged
    the old accel->device rule as parity-in-shape). FORCE modes and the
    device-resident inference route still reach the device decoder."""
    from dataclasses import replace

    from tpu_zstd.api.config import CompressionConfig
    from tpu_zstd.api.manager import compress_items_tpu

    data = corpus["text"]
    cfg = replace(
        CompressionConfig.from_level(3), block_size=4096, hash_log=13,
        decode_accel=True,
    )
    frame = compress_items_tpu([data], cfg)[0]

    eng = HybridEngine(HybridConfig(mode=RoutingMode.AUTO), compression=SMALL)
    res = HybridResult()
    out = eng.decompress(frame, result=res)
    assert out == data
    assert res.backend == tpu_zstd.Backend.CPU_LIBZSTD
    assert "CPU" in res.routing_reason

    eng_tpu = HybridEngine(HybridConfig(mode=RoutingMode.FORCE_TPU), compression=SMALL)
    res_t = HybridResult()
    assert eng_tpu.decompress(frame, result=res_t) == data
    assert res_t.backend == tpu_zstd.Backend.TPU_KERNELS

    eng_cpu = HybridEngine(HybridConfig(mode=RoutingMode.FORCE_CPU), compression=SMALL)
    res2 = HybridResult()
    assert eng_cpu.decompress(frame, result=res2) == data
    assert res2.backend == tpu_zstd.Backend.CPU_LIBZSTD

    # batch route (multi-block frames take the general device decoder)
    outs = eng.decompress_batch([frame])
    assert outs == [data]

    # device-resident inference route needs single-block frames
    small = data[:4000]
    sframe = compress_items_tpu([small], cfg)[0]
    dev_out, dev_lens = eng.decompress_to_device([sframe], max_block=4096)
    assert int(np.asarray(dev_lens)[0]) == len(small)
    assert bytes(np.asarray(dev_out)[0][: len(small)]) == small


def test_hybrid_numpy_input(dctx):
    arr = np.arange(5000, dtype=np.uint8) % 64
    eng = HybridEngine(compression=SMALL)
    c = eng.compress(arr)
    assert dctx.decompress(c, max_output_size=arr.size) == arr.tobytes()


def test_validate_and_estimate(corpus):
    data = corpus["text"]
    c = tpu_zstd.compress(data, level=3, checksum=True)
    assert tpu_zstd.validate_compressed_data(c)
    bad = bytearray(c)
    bad[-2] ^= 0xFF
    assert not tpu_zstd.validate_compressed_data(bytes(bad))
    assert tpu_zstd.estimate_compressed_size(len(data)) >= len(data)
    assert tpu_zstd.get_decompressed_size(c) == len(data)


def test_config_from_level_table():
    assert CompressionConfig.from_level(1).strategy == Strategy.FAST
    assert CompressionConfig.from_level(22).strategy == Strategy.BTULTRA
    assert CompressionConfig.from_level(0).level == 1  # clamped
    assert CompressionConfig.from_level(99).level == 22
    bad = CompressionConfig(block_size=100)
    assert bad.validate() == Status.ERROR_INVALID_PARAMETER


def test_decompress_libzstd_produced(corpus):
    data = corpus["mixed"]
    c = zstd.ZstdCompressor(level=7).compress(data)
    assert tpu_zstd.decompress(c) == data


def test_streaming_window_history(dctx):
    """Cross-chunk matches via window history (reference
    compress_chunk_with_history, manager.cu:6327-6420)."""
    import numpy as np

    cfg = CompressionConfig.from_level(5)
    cfg.block_size = 4096
    cfg.hash_log = 13
    c1 = bytes(np.random.default_rng(5).integers(0, 256, 4000, np.uint8))
    sm = StreamingManager(config=cfg, window_history=True)
    out = sm.compress_chunk(c1) + sm.compress_chunk(c1) + sm.flush()
    assert dctx.decompress(out, max_output_size=8000) == c1 + c1
    sm2 = StreamingManager(config=cfg, window_history=False)
    out2 = sm2.compress_chunk(c1) + sm2.compress_chunk(c1) + sm2.flush()
    assert len(out) < len(out2) // 1.5, "history should catch the repeat"


def test_ldm_cross_block_window(dctx):
    import numpy as np
    from tpu_zstd.api.manager import compress_items_tpu

    cfg = CompressionConfig.from_level(5)
    cfg.block_size = 4096
    cfg.hash_log = 13
    blockful = bytes(np.random.default_rng(6).integers(0, 256, 4000, np.uint8))
    data = blockful * 3
    cfg.enable_ldm = True
    with_ldm = compress_items_tpu([data], cfg)[0]
    cfg.enable_ldm = False
    without = compress_items_tpu([data], cfg)[0]
    assert dctx.decompress(with_ldm, max_output_size=len(data)) == data
    assert len(with_ldm) < len(without) // 2




def test_ldm_window_log_reach():
    """window_log extends enable_ldm's cross-block reach (round-3 review #7):
    a duplicate ~120 KB back is invisible to independent 64 KB-window blocks
    but compresses once a 256 KB window covers it."""
    import zstandard
    from dataclasses import replace

    import numpy as np

    from tpu_zstd.api.config import CompressionConfig
    from tpu_zstd.api.manager import compress_items_tpu

    rng = np.random.default_rng(3)
    chunk = rng.integers(0, 256, 40_000, np.uint8).tobytes()
    mid = rng.integers(0, 256, 50_000, np.uint8).tobytes()
    data = chunk + mid + chunk  # duplicate 90 KB after the original
    base_cfg = replace(
        CompressionConfig.from_level(3), block_size=16 * 1024
    )
    f_plain = compress_items_tpu([data], base_cfg)[0]
    f_ldm = compress_items_tpu(
        [data], replace(base_cfg, enable_ldm=True, window_log=17)
    )[0]
    d = zstandard.ZstdDecompressor()
    assert d.decompress(f_ldm, max_output_size=len(data)) == data
    # The duplicate chunk must be substantially captured by the 128 KB window.
    assert len(f_ldm) < len(f_plain) - 24_000, (len(f_ldm), len(f_plain))
