"""tpu_zstd — a JAX Zstandard (RFC 8878) compression framework.

A ground-up JAX/XLA re-design with the capabilities of the reference CUDA
library `RhushabhVaghela/Custom-NVComp-with-ZSTD`: RFC 8878 compression and
decompression, batch and streaming APIs, hybrid CPU/accelerator routing,
dictionary support, and multi-device scaling via jax.sharding. Output is
decodable by stock libzstd.

Module map:
  tpu_zstd.format    host-side RFC 8878 reference codec (numpy)
  tpu_zstd.ops       device compute pipeline (jitted JAX; Pallas kernels
                     through Triton on the GPU)
  tpu_zstd.api       managers / hybrid engine / config / status
  tpu_zstd.parallel  multi-device sharding (mesh batch parallelism)
  tpu_zstd.platform  the one module that decides which machine runs
"""

from __future__ import annotations

from .api import (
    Backend,
    BatchItem,
    BatchManager,
    ChecksumPolicy,
    CompressionConfig,
    CompressionStats,
    DataLocation,
    ExecutionPath,
    HybridConfig,
    HybridEngine,
    HybridResult,
    Manager,
    RoutingMode,
    Status,
    Strategy,
    StreamingDecompressor,
    StreamingManager,
    estimate_compressed_size,
)

__version__ = "0.1.0"


def is_tpu_available() -> bool:
    """True when JAX sees an accelerator, such as a CUDA GPU (counterpart of
    cuda_zstd.is_cuda_available; see platform.accelerator_available)."""
    from .platform import accelerator_available

    return accelerator_available()


def compress(data: bytes, level: int = 3, checksum: bool = False) -> bytes:
    """One-shot compression (auto CPU/device routing by size)."""
    cfg = CompressionConfig.from_level(level)
    if checksum:
        cfg.checksum = ChecksumPolicy.COMPUTE
    with Manager(config=cfg) as m:
        return m.compress(data)


def decompress(data: bytes, max_output_size: int | None = None) -> bytes:
    """One-shot decompression of (concatenated) zstd frames."""
    with Manager() as m:
        return m.decompress(data, max_output_size)


def compress_batch(items: list[bytes], level: int = 3) -> list[bytes]:
    """Compress many independent buffers in one device dispatch."""
    with BatchManager(level=level) as m:
        return [it.output for it in m.compress_batch(items)]


def decompress_batch(items: list[bytes]) -> list[bytes]:
    with BatchManager() as m:
        return [it.output for it in m.decompress_batch(items)]


def hybrid_compress(data, level: int = 3) -> bytes:
    """Compress with automatic CPU/device backend selection."""
    return HybridEngine(compression=CompressionConfig.from_level(level)).compress(data)


def hybrid_decompress(data, max_output_size: int | None = None) -> bytes:
    return HybridEngine().decompress(data, max_output_size)


def validate_compressed_data(data: bytes) -> bool:
    """Structural validation: parses frame/block structure and, when a
    checksum is present, verifies it (reference validate_compressed_data,
    manager.h:393)."""
    try:
        from .format.frame import decompress as _dec

        _dec(data, verify_checksum=True)
        return True
    except Exception:
        return False


def get_decompressed_size(data: bytes) -> int | None:
    """Frame-header content size, if recorded (reference types.cpp:1058)."""
    from .format.frame import parse_frame_header

    try:
        return parse_frame_header(data).content_size
    except Exception:
        return None
