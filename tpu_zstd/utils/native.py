"""ctypes loader for the native host runtime (csrc/tpu_zstd_native.cpp).

Builds the shared library on first use (g++, cached beside the source) and
exposes XXH64/32 and the frame assembler. Every entry point has a pure-Python
fallback so the package works without a toolchain — mirroring the reference's
graceful no-GPU fallback (reference python/cuda_zstd/__init__.py:146).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

try:
    import fcntl
except ImportError:  # non-POSIX: fall back to thread-lock-only builds
    fcntl = None

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "csrc")
_SRC = os.path.join(_CSRC, "tpu_zstd_native.cpp")
_SRC_ENGINE = os.path.join(_CSRC, "tpu_zstd_engine.cpp")
_LIB = os.path.join(_CSRC, "build", "libtz_native.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _build() -> bool:
    # Compile to a private temp path, then atomically rename into place:
    # a concurrent process that already dlopen-mapped the old library keeps
    # its (unlinked) inode, and no process can ever load a half-written file.
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.tmp.{os.getpid()}"
    srcs = [_SRC] + ([_SRC_ENGINE] if os.path.exists(_SRC_ENGINE) else [])
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", *srcs, "-o", tmp],
            check=True, capture_output=True, timeout=180,
        )
        os.replace(tmp, _LIB)
        return True
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _ensure_built() -> bool:
    """Stale-check + build under a cross-process file lock (parallel pytest
    workers must not race g++ against each other — a thread lock alone lets
    two PROCESSES rebuild/load the .so mid-write, observed as a worker
    segfault under `pytest -n 4`)."""
    if not os.path.exists(_SRC):
        return False

    def stale() -> bool:
        if not os.path.exists(_LIB):
            return True
        newest = max(
            os.path.getmtime(s) for s in (_SRC, _SRC_ENGINE) if os.path.exists(s)
        )
        return os.path.getmtime(_LIB) < newest

    if not stale():
        return True
    if fcntl is None:
        return _build()
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    with open(f"{_LIB}.lock", "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            return (not stale()) or _build()
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)


def get_native() -> ctypes.CDLL | None:
    """The native library, building it on first call; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _ensure_built():
            return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        lib.tz_xxh64.restype = ctypes.c_uint64
        lib.tz_xxh64.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
        lib.tz_xxh32.restype = ctypes.c_uint32
        lib.tz_xxh32.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32]
        lib.tz_huf_decode_stream.restype = ctypes.c_int32
        lib.tz_huf_decode_stream.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.tz_assemble_frames.restype = ctypes.c_int64
        lib.tz_assemble_frames.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        try:
            lib.tz_engine_create.restype = ctypes.c_void_p
            lib.tz_engine_create.argtypes = [ctypes.c_int]
            lib.tz_engine_destroy.argtypes = [ctypes.c_void_p]
            lib.tz_engine_set_checksum.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.tz_engine_set_block_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.tz_engine_compress.restype = ctypes.c_int64
            lib.tz_engine_compress.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64,
            ]
            lib.tz_engine_decompress.restype = ctypes.c_int64
            lib.tz_engine_decompress.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64,
            ]
            lib.tz_engine_compress_bound.restype = ctypes.c_int64
            lib.tz_engine_compress_bound.argtypes = [ctypes.c_int64]
            lib.tz_engine_decompressed_size.restype = ctypes.c_int64
            lib.tz_engine_decompressed_size.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            lib.tz_engine_validate.restype = ctypes.c_int32
            lib.tz_engine_validate.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            lib.tz_engine_get_stats.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.tz_engine_reset.argtypes = [ctypes.c_void_p]
            lib.tz_engine_error_string.restype = ctypes.c_char_p
            lib.tz_engine_error_string.argtypes = [ctypes.c_int32]
        except AttributeError:
            pass  # stale lib without the engine; rebuilt on next stale check
        _lib = lib
        return _lib


class NativeEngine:
    """Python handle over the C engine (the reference's C API surface,
    reference include/cuda_zstd_manager.h:433-479). None-safe: use
    NativeEngine.create() and check for None when the toolchain is absent."""

    __slots__ = ("_lib", "_h")

    @classmethod
    def create(cls, level: int = 3, checksum: bool = False, block_size: int = 0):
        lib = get_native()
        if lib is None or not hasattr(lib, "tz_engine_create"):
            return None
        h = lib.tz_engine_create(int(level))
        if not h:
            return None
        eng = cls()
        eng._lib = lib
        eng._h = h
        lib.tz_engine_set_checksum(h, 1 if checksum else 0)
        if block_size:
            lib.tz_engine_set_block_size(h, int(block_size))
        return eng

    def compress(self, data: bytes) -> bytes | None:
        cap = self._lib.tz_engine_compress_bound(len(data))
        out = ctypes.create_string_buffer(cap)
        n = self._lib.tz_engine_compress(self._h, bytes(data), len(data), out, cap)
        return out.raw[:n] if n >= 0 else None

    def decompress(self, frame: bytes, max_output: int) -> bytes | None:
        out = ctypes.create_string_buffer(max(max_output, 1))
        n = self._lib.tz_engine_decompress(
            self._h, bytes(frame), len(frame), out, max_output
        )
        return out.raw[:n] if n >= 0 else None

    def stats(self) -> tuple[int, int, int, int]:
        buf = (ctypes.c_int64 * 4)()
        self._lib.tz_engine_get_stats(self._h, buf)
        return tuple(buf)

    def reset(self) -> None:
        self._lib.tz_engine_reset(self._h)

    def __del__(self):
        try:
            self._lib.tz_engine_destroy(self._h)
        except Exception:
            pass


def xxh64(data: bytes, seed: int = 0) -> int:
    lib = get_native()
    if lib is not None:
        return int(lib.tz_xxh64(data, len(data), seed))
    from ..format.xxhash import xxh64 as py_xxh64

    return py_xxh64(data, seed)


def xxh32(data: bytes, seed: int = 0) -> int:
    lib = get_native()
    if lib is not None:
        return int(lib.tz_xxh32(data, len(data), seed))
    from ..format.xxhash import xxh32 as py_xxh32

    return py_xxh32(data, seed)


def huf_decode_stream(data: bytes, dtable_packed: np.ndarray, table_log: int, out_len: int) -> bytes | None:
    """Native Huffman stream decode; None when unavailable or malformed
    (caller falls back to the Python oracle)."""
    lib = get_native()
    if lib is None:
        return None
    dt = np.ascontiguousarray(dtable_packed, dtype=np.int32)
    out = np.empty(out_len, dtype=np.uint8)
    rc = lib.tz_huf_decode_stream(
        bytes(data), len(data), dt.ctypes.data, int(table_log), out.ctypes.data, out_len
    )
    if rc != 0:
        return None
    return out.tobytes()


def assemble_frames(
    contents: np.ndarray,
    lens: np.ndarray,
    types: np.ndarray,
    raw_lens: np.ndarray,
    firsts: np.ndarray,
    counts: np.ndarray,
    headers: list[bytes],
    checksums: list[bytes] | None,
) -> bytes | None:
    """Native frame join; None when the library is unavailable (caller falls
    back to Python concatenation)."""
    lib = get_native()
    if lib is None:
        return None
    contents = np.ascontiguousarray(contents, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    types = np.ascontiguousarray(types, dtype=np.int32)
    raw_lens = np.ascontiguousarray(raw_lens, dtype=np.int32)
    firsts = np.ascontiguousarray(firsts, dtype=np.int32)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    hdr_blob = b"".join(headers)
    hdr_lens = np.array([len(h) for h in headers], dtype=np.int32)
    checks_blob = b"".join(checksums) if checksums is not None else None
    out_cap = int(lens.sum()) + 3 * len(lens) + len(hdr_blob) + 4 * len(headers) + 64
    out = np.empty(out_cap, dtype=np.uint8)
    n = lib.tz_assemble_frames(
        contents.ctypes.data, contents.shape[1],
        lens.ctypes.data, types.ctypes.data, raw_lens.ctypes.data,
        firsts.ctypes.data, counts.ctypes.data, len(headers),
        hdr_blob, hdr_lens.ctypes.data,
        checks_blob, out_cap, out.ctypes.data,
    )
    if n < 0:
        return None
    return out[:n].tobytes()
