"""End-to-end tests for the device (JAX) compression pipeline.

Oracle strategy mirrors the reference's test suite (tests/test_roundtrip.cu,
tests/test_pipeline_integration.cu external-decoder check): every frame the
device pipeline emits must be decodable by stock libzstd (`zstandard` package)
and by our own host decoder, with bit-exact content recovery.
"""

import numpy as np
import pytest
import zstandard as zstd

from tpu_zstd.format.frame import decompress as host_decompress
from tpu_zstd.ops.pipeline import DEFAULT_CONFIG, PipelineConfig, compress

SMALL_CFG = PipelineConfig(block_size=4096, hash_log=13)


@pytest.fixture(scope="module")
def dctx():
    return zstd.ZstdDecompressor()


def _check(data: bytes, cfg, dctx):
    c = compress(data, cfg)
    d = dctx.decompress(c, max_output_size=max(len(data), 1))
    assert d == data, "libzstd decode mismatch"
    assert host_decompress(c) == data, "host decoder mismatch"
    return c


def test_roundtrip_corpus_small_blocks(corpus, dctx):
    for name, data in corpus.items():
        _check(data, SMALL_CFG, dctx)


def test_roundtrip_corpus_full_blocks(corpus, dctx):
    for name, data in corpus.items():
        _check(data, DEFAULT_CONFIG, dctx)


def test_multiblock_boundary_sizes(dctx):
    base = b"pattern-123456789-pattern " * 8192
    for n in (4095, 4096, 4097, 8192, 12288 + 7):
        _check(base[:n], SMALL_CFG, dctx)


def test_compression_ratio_reasonable(dctx):
    text = b"the quick brown fox jumps over the lazy dog. " * 3000
    c = _check(text, DEFAULT_CONFIG, dctx)
    assert len(c) * 10 < len(text), "repetitive text should compress >10x"


def test_incompressible_raw_fallback(rng, dctx):
    data = rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes()
    c = _check(data, DEFAULT_CONFIG, dctx)
    nblocks = -(-len(data) // DEFAULT_CONFIG.block_size)
    assert len(c) <= len(data) + 18 + 3 * nblocks


def test_rle_block(dctx):
    c = _check(b"\xAB" * 50_000, DEFAULT_CONFIG, dctx)
    assert len(c) < 32


def test_checksum_emitted(dctx):
    data = b"checksum me " * 1000
    c = compress(data, SMALL_CFG, checksum=True)
    # zstandard verifies the checksum during decompression.
    assert dctx.decompress(c, max_output_size=len(data)) == data


def test_determinism(corpus):
    data = corpus["mixed"]
    assert compress(data, SMALL_CFG) == compress(data, SMALL_CFG)


def test_empty_and_tiny(dctx):
    for data in (b"", b"a", b"ab", b"abc", b"abcd"):
        _check(data, SMALL_CFG, dctx)
