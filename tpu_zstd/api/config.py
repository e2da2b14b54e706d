"""Status codes, strategies, and compression configuration.

Counterpart of the reference's types layer
(reference include/cuda_zstd_types.h:92-128 `Status`, :162-171 `Strategy`,
:196-232 `CompressionConfig`, src/cuda_zstd_types.cpp:147-207 `from_level`).
The level table maps RFC-style levels 1-22 onto the device pipeline's
static knobs (hash_log / search depth / compare cap / lazy) rather than the
CUDA hash/chain/search log trio — the sorted-domain matcher has different
cost axes, so higher levels mostly widen `cap` and `depth`.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class Status(enum.IntEnum):
    """Operation status codes (superset used across the API; mirrors the
    reference's 29-code Status enum semantics, types.h:92-128)."""

    SUCCESS = 0
    ERROR_GENERIC = 1
    ERROR_INVALID_PARAMETER = 2
    ERROR_BUFFER_TOO_SMALL = 3
    ERROR_CORRUPT_DATA = 4
    ERROR_OUT_OF_MEMORY = 5
    ERROR_UNSUPPORTED = 6
    ERROR_NOT_INITIALIZED = 7
    ERROR_DEVICE = 8
    ERROR_CHECKSUM_MISMATCH = 9
    ERROR_DICTIONARY_MISMATCH = 10
    ERROR_DST_SIZE_TOO_SMALL = 11
    ERROR_SRC_EMPTY = 12
    ERROR_FRAME_HEADER = 13
    ERROR_BLOCK_HEADER = 14
    ERROR_LITERALS = 15
    ERROR_SEQUENCES = 16
    ERROR_FSE_TABLE = 17
    ERROR_HUFFMAN_TABLE = 18
    ERROR_OFFSET_TOO_LARGE = 19
    ERROR_CONTENT_SIZE_MISMATCH = 20
    ERROR_WINDOW_TOO_LARGE = 21
    ERROR_DICT_TRAINING = 22
    ERROR_STREAM_STATE = 23
    ERROR_BATCH_PARTIAL = 24
    ERROR_CANCELLED = 25
    ERROR_INTERNAL = 26
    ERROR_IO = 27
    ERROR_TIMEOUT = 28


class Strategy(enum.IntEnum):
    """Parse strategies (reference types.h:162-171)."""

    FAST = 1
    DFAST = 2
    GREEDY = 3
    LAZY = 4
    LAZY2 = 5
    BTLAZY2 = 6
    BTOPT = 7
    BTULTRA = 8


class ExecutionPath(enum.IntEnum):
    """Routing decision (reference cuda_zstd_manager.h:83-90). TPU_BATCH
    and TPU_CHUNK name the device paths, whatever the accelerator."""

    AUTO = 0
    CPU = 1
    TPU_BATCH = 2
    TPU_CHUNK = 3


class ChecksumPolicy(enum.IntEnum):
    NONE = 0
    COMPUTE = 1
    COMPUTE_AND_VERIFY = 2


@dataclass
class CompressionConfig:
    """User-facing knobs; `from_level` fills strategy-appropriate defaults."""

    level: int = 3
    strategy: Strategy = Strategy.GREEDY
    window_log: int | None = None
    hash_log: int = 16
    search_depth: int = 2
    compare_cap: int = 32
    min_match: int = 4
    block_size: int = 128 * 1024
    checksum: ChecksumPolicy = ChecksumPolicy.NONE
    enable_ldm: bool = False
    cpu_threshold: int = 1 << 20  # route-to-CPU size threshold (hybrid)
    dict_id: int = 0
    # Emit decoder-checkpoint metadata (a skippable frame stock libzstd
    # ignores) enabling chunk-parallel device decompression (format/accel.py).
    decode_accel: bool = False

    @classmethod
    def from_level(cls, level: int) -> "CompressionConfig":
        """Level -> parameter table (counterpart of types.cpp:147-207)."""
        # Depth and compare cap rise quickly with level (ratios below are on
        # the mixed bench corpus; their speed cost on the H100 is not
        # measured).
        level = max(1, min(22, int(level)))
        if level <= 2:
            # Unsampled depth-3 search: ratio 2.589 (90% of libzstd L1)
            # against 2.371 with sample_log=1 acceleration.
            p = dict(strategy=Strategy.FAST, hash_log=15, search_depth=3, compare_cap=16)
        elif level <= 4:
            # Carried-word count (compare_cap / 4) is one sort operand per
            # word; cap 8 gave ratio 2.713 against 2.706 at cap 12 (the
            # same-offset merge pass re-joins matches truncated at the cap,
            # and shorter carried words improve tie-breaking).
            p = dict(strategy=Strategy.LAZY, hash_log=17, search_depth=8, compare_cap=8)
        elif level <= 6:
            p = dict(strategy=Strategy.LAZY, hash_log=17, search_depth=8, compare_cap=64)
        elif level <= 9:
            p = dict(strategy=Strategy.LAZY2, hash_log=18, search_depth=12, compare_cap=64)
        elif level <= 15:
            p = dict(strategy=Strategy.BTLAZY2, hash_log=18, search_depth=24, compare_cap=64)
        elif level <= 19:
            # Depth sweep (L19, 2 MB): 16 -> 32 -> 48 = ratio 2.755 -> 2.807
            # -> 2.824; candidate window 15 -> 16 = +0.9%.
            # min_match 3 like the reference (types.cpp:883-947) at the
            # optimal-parse levels only: the two-pass DP prices a 3-byte
            # match's real bits, so it is taken exactly when it wins.
            p = dict(strategy=Strategy.BTOPT, hash_log=18, search_depth=48,
                     compare_cap=64, min_match=3)
        else:
            p = dict(strategy=Strategy.BTULTRA, hash_log=18, search_depth=96,
                     compare_cap=64, min_match=3)
        # NOTE: enable_ldm (cross-block 64 KB windows via the sampled LDM
        # pass) stays OPT-IN at every level: blocks compress independently by
        # default, exactly like the reference GPU (its multi-GPU/window modes
        # are likewise explicit). Auto-enabling it at ratio levels was
        # measured nearly ratio-neutral on the mixed corpus while multiplying
        # the windowed-path compile surface.
        return cls(level=level, **p)

    def validate(self) -> Status:
        if not (1 <= self.level <= 22):
            return Status.ERROR_INVALID_PARAMETER
        if not (10 <= self.hash_log <= 24):
            return Status.ERROR_INVALID_PARAMETER
        if self.block_size < 1024 or self.block_size > 128 * 1024:
            return Status.ERROR_INVALID_PARAMETER
        if self.compare_cap % 4 != 0 or self.compare_cap < 8:
            return Status.ERROR_INVALID_PARAMETER
        return Status.SUCCESS


@dataclass
class CompressionStats:
    """Cumulative per-manager counters (reference types.h:238-262)."""

    total_input_bytes: int = 0
    total_output_bytes: int = 0
    total_blocks: int = 0
    total_frames: int = 0
    total_compress_calls: int = 0
    total_decompress_calls: int = 0
    total_compress_time_s: float = 0.0
    total_decompress_time_s: float = 0.0

    @property
    def ratio(self) -> float:
        if self.total_output_bytes == 0:
            return 0.0
        return self.total_input_bytes / self.total_output_bytes

    @property
    def compress_throughput_mbps(self) -> float:
        if self.total_compress_time_s == 0:
            return 0.0
        return self.total_input_bytes / self.total_compress_time_s / 1e6

    def reset(self) -> None:
        for f in self.__dataclass_fields__:
            setattr(self, f, 0 if isinstance(getattr(self, f), int) else 0.0)


def estimate_compressed_size(input_size: int) -> int:
    """Worst-case frame size (ZSTD_compressBound-style; the pipeline's raw
    block guarantee keeps blocks <= input + 3 bytes each, reference
    manager.cu:140-165)."""
    nblocks = max(1, -(-input_size // (128 * 1024)))
    return input_size + 3 * nblocks + 18 + 4
