"""Managers: single-shot, batch, and streaming compression surfaces.

Counterpart of the reference's manager layer
(reference include/cuda_zstd_manager.h:45-352 — `ZstdManager`,
`ZstdBatchManager`, `ZstdStreamingManager`; impl src/cuda_zstd_manager.cu).
The CUDA stream pool / workspace partitioning machinery has no analogue
here (XLA owns memory; batching replaces streams): a Manager wraps the jitted
block pipeline plus host framing, with power-of-two batch bucketing in place
of the reference's 8-stream round-robin (manager.cu:5540-5585).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..constants import BLOCK_COMPRESSED, BLOCK_RAW, BLOCK_RLE
from ..format.frame import write_frame_header
from ..format.xxhash import content_checksum
from .config import (
    ChecksumPolicy,
    CompressionConfig,
    CompressionStats,
    ExecutionPath,
    Status,
    estimate_compressed_size,
)


# Decoder-checkpoint stride (format/accel.py): the sidecar costs ~20 B per
# chunk, so 256 (against 64) quarters it; each chunk's serial decode walk is
# then 256 steps (its cost on the H100 is not measured).
ACCEL_STRIDE = 256


def _pipeline_config(cfg: CompressionConfig):
    from ..ops.pipeline import PipelineConfig

    return PipelineConfig(
        block_size=cfg.block_size,
        # 17 bits keep (hash << (mf_win_log+1) | pos) in one u32 sort key
        # (17 + 1 + 14 = 32 bits, lz77_jax.py single-key path); at a 16 KB
        # window a 17-bit hash is already collision-sparse.
        hash_log=min(cfg.hash_log, 17),
        depth=cfg.search_depth,
        cap=cfg.compare_cap,
        min_match=cfg.min_match,
        lazy=cfg.strategy >= 4,          # Strategy.LAZY and up
        optimal=cfg.strategy >= 7,       # Strategy.BTOPT and up (levels 16+)
        # All levels entropy-code literals, like libzstd (raw-lit fast levels
        # measured -10-16% ratio for a modest assemble-stage cost).
        huffman_literals=True,
        of_gate=(8, 12) if cfg.level >= 3 else (99, 99),
        # Ratio-focused levels widen the candidate window instead of going
        # full-block (a 128K-wide two-key 17-operand sort compiles for tens of
        # minutes; 32K windows stay tractable). Ratio at the L16 shape:
        # win 13 -> 14 -> 15 = 2.633 -> 2.682 -> 2.713.
        # L13+ pay for a 64 KB candidate window (two-key sort: the packed
        # single-u32 key tops out at win 15); measured +0.9% at L19.
        mf_win_log=13 if cfg.level <= 6 else (14 if cfg.level <= 9 else (15 if cfg.level <= 12 else 16)),
        ckpt_every=ACCEL_STRIDE if cfg.decode_accel else 0,
        sample_log=0,
        # Long-range supplement for ratio-focused levels (reference LDM).
        ldm=cfg.level >= 7,
    )


def _bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


@dataclass
class BatchItem:
    """One batch entry (reference types.h:268-274)."""

    data: bytes
    output: bytes | None = None
    status: Status = Status.SUCCESS


class Manager:
    """Single-shot compress/decompress manager (context-manager friendly).

    Mirrors the `cuda_zstd.Manager` Python surface
    (reference python/cuda_zstd/__init__.py:176-339).
    """

    def __init__(
        self,
        level: int = 3,
        config: CompressionConfig | None = None,
        execution_path: ExecutionPath = ExecutionPath.AUTO,
    ):
        self.config = config or CompressionConfig.from_level(level)
        st = self.config.validate()
        if st != Status.SUCCESS:
            raise ValueError(f"invalid config: {st.name}")
        self.execution_path = execution_path
        self.stats = CompressionStats()
        self._closed = False

    # -- context manager ------------------------------------------------------
    def __enter__(self) -> "Manager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._closed = True

    # -- paths ----------------------------------------------------------------
    def select_execution_path(self, size: int) -> ExecutionPath:
        """Size-based routing (reference manager.cu:6466 select_execution_path:
        small inputs are faster on the host; large ones on the accelerator)."""
        if self.execution_path != ExecutionPath.AUTO:
            return self.execution_path
        if size < self.config.cpu_threshold:
            return ExecutionPath.CPU
        return ExecutionPath.TPU_BATCH

    # -- single-shot ----------------------------------------------------------
    def compress(self, data: bytes) -> bytes:
        t0 = time.perf_counter()
        path = self.select_execution_path(len(data))
        if path == ExecutionPath.CPU:
            out = self._compress_cpu(data)
        else:
            out = self._compress_tpu([data])[0]
        dt = time.perf_counter() - t0
        self.stats.total_input_bytes += len(data)
        self.stats.total_output_bytes += len(out)
        self.stats.total_frames += 1
        self.stats.total_blocks += max(1, -(-len(data) // self.config.block_size))
        self.stats.total_compress_calls += 1
        self.stats.total_compress_time_s += dt
        return out

    def decompress(self, data: bytes, max_output_size: int | None = None) -> bytes:
        t0 = time.perf_counter()
        if self.execution_path in (ExecutionPath.TPU_BATCH, ExecutionPath.TPU_CHUNK):
            from .decompress import decompress_batch_tpu

            out = decompress_batch_tpu(
                [data],
                verify_checksum=self.config.checksum != ChecksumPolicy.NONE,
            )[0]
        else:
            out = _decompress_host(
                data,
                max_output_size,
                verify=self.config.checksum == ChecksumPolicy.COMPUTE_AND_VERIFY,
            )
        dt = time.perf_counter() - t0
        self.stats.total_decompress_calls += 1
        self.stats.total_decompress_time_s += dt
        return out

    # -- internals ------------------------------------------------------------
    def _compress_cpu(self, data: bytes) -> bytes:
        """Host path: the native C++ engine (csrc/tpu_zstd_engine.cpp).

        The reference's CPU path delegates to libzstd (manager.cu:1607-1668);
        ours runs this framework's OWN native engine — the same format layer,
        compiled — with the pure-Python format codec as the no-toolchain
        fallback (a perf trap the round-2 review flagged: the Python codec
        runs at a few MB/s; the engine runs at tens-to-hundreds of MB/s).
        """
        from ..utils.native import NativeEngine

        checksum = self.config.checksum != ChecksumPolicy.NONE
        eng = NativeEngine.create(
            self.config.level, checksum=checksum, block_size=self.config.block_size
        )
        if eng is not None:
            out = eng.compress(data)
            if out is not None:
                return out
        from ..format.frame import CompressParams, compress as host_compress

        return host_compress(
            data,
            CompressParams(
                level=self.config.level,
                hash_log=min(self.config.hash_log, 16),
                search_depth=self.config.search_depth,
                min_match=self.config.min_match,
                lazy=self.config.strategy >= 4,
                block_size=self.config.block_size,
                checksum=checksum,
            ),
        )

    def _compress_tpu(self, items: list[bytes]) -> list[bytes]:
        return compress_items_tpu(items, self.config)


LDM_WINDOW_CAP = 64 * 1024  # cross-block window size (enable_ldm / streaming history)

_TRIM_CACHE: dict = {}


def _trim_content(contents, bucket: int):
    """Device-side slice before transfer (one cached jit per pow2 bucket)."""
    import jax

    fn = _TRIM_CACHE.get(bucket)
    if fn is None:
        fn = jax.jit(lambda c: c[:, :bucket])
        _TRIM_CACHE[bucket] = fn
    return fn(contents)


def compress_items_tpu(
    items: list[bytes],
    cfg: CompressionConfig,
    history: list[bytes] | None = None,
) -> list[bytes]:
    """Compress a list of buffers on the device in ONE dispatch.

    All items' blocks are flattened into a (B, block_size) batch (the
    replacement for the reference's per-item stream dispatch,
    manager.cu:5715-5797), then reassembled into one frame per item.

    With cfg.enable_ldm (or `history`), every block additionally sees the
    bytes that precede it in the logical stream as a match window — the
    equivalent of the reference's LDM + streaming window history
    (ldm_implementation.cu; manager.cu:6327-6420). `history[i]` is prior
    stream content for item i (streaming chunks).
    """
    import jax
    import jax.numpy as jnp

    from ..ops.pipeline import PipelineConfig, compress_blocks_dict, compress_blocks_staged

    pcfg = _pipeline_config(cfg)
    N = pcfg.block_size
    windowed = cfg.enable_ldm or history is not None
    # Cross-block reach: 64 KB default (a blanket 256 KB ladder was measured
    # ratio-NEGATIVE on the mixed corpus — extra LDM rows dilute the chain
    # without redundancy at those distances). config.window_log raises it
    # explicitly, up to 1 MB: on a long-range-redundant corpus (400 KB
    # duplicate ~900 KB back) a 1 MB window gave +12% ratio where 64/256 KB
    # were neutral (reference LDM reaches window_log <= 31, ldm.h:10-29).
    dcap = 0
    if windowed:
        dcap = LDM_WINDOW_CAP
        if cfg.window_log:
            dcap = min(1 << cfg.window_log, 1 << 20)
        dcap = -(-dcap // 4096) * 4096
    if windowed:
        # enable_ldm keeps the cheap windowed local search and reaches the
        # cross-block prefix through the sampled LDM pass (>= 16-byte
        # verified matches — the bulk of the full-window ratio advantage).
        # Streaming history / dictionary preloads keep full-reach search so
        # short matches into the preload stay available.
        extra = (
            {"ldm": True, "ldm_window": True}
            if cfg.enable_ldm and history is None
            else {}
        )
        pcfg = PipelineConfig(**{**pcfg.__dict__, "dict_cap": dcap, **extra})

    spans: list[tuple[int, int]] = []  # (first_block, nblocks) per item
    all_blocks: list[np.ndarray] = []
    lengths: list[int] = []
    dlens: list[int] = []
    for it_i, data in enumerate(items):
        n = len(data)
        nb = max(1, -(-n // N))
        spans.append((len(all_blocks), nb))
        arr = np.frombuffer(data, dtype=np.uint8)
        hist = history[it_i] if history is not None else b""
        for b in range(nb):
            chunk = arr[b * N : min((b + 1) * N, n)]
            buf = np.zeros(dcap + N, dtype=np.uint8)
            buf[dcap : dcap + len(chunk)] = chunk
            if windowed:
                prior = hist + data[: b * N]
                tail = prior[-dcap:]
                if tail:
                    buf[dcap - len(tail) : dcap] = np.frombuffer(tail, np.uint8)
                dlens.append(len(tail))
            all_blocks.append(buf)
            lengths.append(len(chunk))
    B = len(all_blocks)
    Bpad = _bucket(B)
    blocks_np = np.zeros((Bpad, dcap + N), dtype=np.uint8)
    if B:
        blocks_np[:B] = np.stack(all_blocks)
    lens_np = np.zeros(Bpad, dtype=np.int32)
    lens_np[:B] = lengths

    if windowed:
        dlens_np = np.zeros(Bpad, dtype=np.int32)
        dlens_np[:B] = dlens
        out = compress_blocks_dict(
            jnp.asarray(blocks_np), jnp.asarray(lens_np), jnp.asarray(dlens_np), pcfg
        )
    else:
        out = compress_blocks_staged(jnp.asarray(blocks_np), jnp.asarray(lens_np), pcfg)

    # Two-phase fetch: lens/types are tiny; the content transfer is trimmed to
    # the largest non-Raw block (Raw blocks re-use the caller's input bytes).
    accel = bool(pcfg.ckpt_every) and not windowed
    accel_meta: list[bytes] = []
    if accel:
        from ..format.accel import write_accel_frame

        C = pcfg.ckpt_every
        clens, btypes, nseq_h = jax.device_get((out[1], out[2], out[6]))
        nck = np.maximum(-(-nseq_h // C) - 1, 0)
        mx_ck = int(nck[:B].max()) if B else 0
        ckb, cks, ckr = jax.device_get(
            (out[3][:, :mx_ck], out[4][:, :mx_ck], out[5][:, :mx_ck])
        )
        has_lit_ck = pcfg.huffman_literals and len(out) > 9
        CL = pcfg.lit_ckpt_every
        if has_lit_ck:
            # Literal checkpoints: per-stream records cover ceil(nlit/4)
            # forward symbols in chunks of CL (record c-1 -> symbol c*CL).
            lit_used_h, nlit_h = jax.device_get((out[8], out[9]))
            seg_h = -(-nlit_h // 4)
            nckl = np.where(lit_used_h, np.maximum(-(-seg_h // CL) - 1, 0), 0)
            mx_ckl = int(nckl[:B].max()) if B else 0
            lck = jax.device_get(out[7][:, :, :mx_ckl]) if mx_ckl else None
        e = np.empty(0, np.uint32)
        el = np.zeros((4, 0), np.uint32)
        for first, nb in spans:
            recs = []
            for b in range(first, first + nb):
                if btypes[b] == BLOCK_COMPRESSED and nseq_h[b] > 0:
                    n = int(nck[b])
                    lc = (
                        lck[b, :, : int(nckl[b])]
                        if has_lit_ck and lck is not None and nckl[b] > 0
                        else el
                    )
                    recs.append(
                        (int(nseq_h[b]), ckb[b, :n], cks[b, :n], ckr[b, :n], lc)
                    )
                else:
                    recs.append((0, e, e, e, el))
            accel_meta.append(write_accel_frame(C, recs, lit_stride=CL))
    else:
        clens, btypes = jax.device_get((out[1], out[2]))
    nonraw = btypes[:B] != BLOCK_RAW if B else np.zeros(0, bool)
    mx = int(clens[:B][nonraw].max()) if nonraw.any() else 1
    bucket = _bucket(max(mx, 64), lo=64)
    if bucket < N:
        contents = jax.device_get(_trim_content(out[0], bucket))
    else:
        bucket = None
        contents = jax.device_get(out[0])

    checksum = cfg.checksum != ChecksumPolicy.NONE

    if bucket is None:
        # Fast path: native C++ frame assembler (csrc), then split per item.
        native_out = _assemble_native(
            items, spans, contents, clens, btypes, lens_np, cfg, checksum
        )
        if native_out is not None:
            if accel_meta:
                return [f + m for f, m in zip(native_out, accel_meta)]
            return native_out

    outs: list[bytes] = []
    for (first, nb), data in zip(spans, items):
        if len(data) == 0:
            hdr = write_frame_header(0, checksum=checksum, dict_id=cfg.dict_id)
            out = hdr + (1).to_bytes(3, "little")
            if checksum:
                out += content_checksum(b"").to_bytes(4, "little")
            outs.append(out)
            continue
        parts = [
            write_frame_header(
                len(data), checksum=checksum, dict_id=cfg.dict_id,
                window_log=cfg.window_log,
            )
        ]
        for k in range(nb):
            b = first + k
            last = 1 if k == nb - 1 else 0
            btype = int(btypes[b])
            clen = int(clens[b])
            if btype == BLOCK_RLE:
                parts.append(((int(lens_np[b]) << 3) | (BLOCK_RLE << 1) | last).to_bytes(3, "little"))
                parts.append(contents[b, :1].tobytes())
            elif btype == BLOCK_RAW:
                # Raw content == the caller's input bytes (not transferred).
                parts.append(((clen << 3) | (BLOCK_RAW << 1) | last).to_bytes(3, "little"))
                parts.append(data[k * N : k * N + clen])
            else:
                parts.append(((clen << 3) | (btype << 1) | last).to_bytes(3, "little"))
                parts.append(contents[b, :clen].tobytes())
        if checksum:
            parts.append(content_checksum(data).to_bytes(4, "little"))
        outs.append(b"".join(parts))
    if accel_meta:
        return [f + m for f, m in zip(outs, accel_meta)]
    return outs


def _assemble_native(
    items, spans, contents, clens, btypes, lens_np, cfg, checksum
) -> list[bytes] | None:
    """Join blocks into frames via csrc/tpu_zstd_native.cpp; None -> fallback."""
    if any(len(d) == 0 for d in items):
        return None  # empty-frame special case stays on the Python path
    try:
        from ..utils.native import assemble_frames
    except Exception:
        return None
    headers = [
        write_frame_header(
            len(d), checksum=checksum, dict_id=cfg.dict_id, window_log=cfg.window_log
        )
        for d in items
    ]
    checks = (
        [content_checksum(d).to_bytes(4, "little") for d in items] if checksum else None
    )
    firsts = np.array([s[0] for s in spans], dtype=np.int32)
    counts = np.array([s[1] for s in spans], dtype=np.int32)
    blob = assemble_frames(
        contents, clens, btypes, lens_np[: len(clens)], firsts, counts, headers, checks
    )
    if blob is None:
        return None
    # Split the blob back into per-item frames by recomputing sizes.
    outs = []
    pos = 0
    for (first, nb), hdr in zip(spans, headers):
        size = len(hdr) + sum(
            3 + (1 if int(btypes[first + k]) == BLOCK_RLE else int(clens[first + k]))
            for k in range(nb)
        )
        if checksum:
            size += 4
        outs.append(blob[pos : pos + size])
        pos += size
    return outs


def _decompress_host(
    data: bytes, max_output_size: int | None = None, verify: bool = False
) -> bytes:
    """Host decompression via libzstd (`zstandard`), falling back to the
    format-layer decoder. libzstd plays the same role as in the reference
    (CPU backend + oracle, CMakeLists.txt:31-32)."""
    try:
        import zstandard

        from ..format.frame import parse_frame_header

        hdr = parse_frame_header(data)
        if max_output_size is None:
            max_output_size = hdr.content_size if hdr.content_size is not None else 0
        dctx = zstandard.ZstdDecompressor()
        if max_output_size:
            return dctx.decompress(data, max_output_size=max_output_size)
        return dctx.decompress(data)
    except Exception:
        from ..format.frame import decompress as fallback

        return fallback(data, verify_checksum=verify)


def _is_oom(exc: Exception) -> bool:
    s = f"{type(exc).__name__}: {exc}"
    return "RESOURCE_EXHAUSTED" in s or "Out of memory" in s or "OOM" in s


def _compress_items_degraded(
    items: list[bytes], cfg: CompressionConfig, on_degrade=None
) -> list[bytes]:
    """compress_items_tpu with graceful degradation: an accelerator OOM
    splits the batch and retries the halves, down to single items; a
    single-item OOM falls back to the host engine.

    The analogue of the reference memory pool's degradation ladder
    (reference src/cuda_zstd_memory_pool_complex.cu:373-770:
    NORMAL -> CONSERVATIVE -> AGGRESSIVE -> EMERGENCY with host fallback) —
    XLA owns memory here, so degradation means smaller dispatches, not
    smaller pools.
    """
    try:
        return compress_items_tpu(items, cfg)
    except Exception as e:  # noqa: BLE001 - we re-raise non-OOM below
        if not _is_oom(e):
            raise
        if on_degrade is not None:
            on_degrade(len(items))
        if len(items) > 1:
            mid = len(items) // 2
            return _compress_items_degraded(
                items[:mid], cfg, on_degrade
            ) + _compress_items_degraded(items[mid:], cfg, on_degrade)
        from .hybrid import HybridEngine, HybridConfig, RoutingMode

        eng = HybridEngine(HybridConfig(mode=RoutingMode.FORCE_CPU), compression=cfg)
        return [eng.compress(items[0])]


class BatchManager:
    """Batched many-buffer compression (reference ZstdBatchManager,
    manager.h:113-278). One device dispatch per batch, with OOM
    split-and-retry degradation (see _compress_items_degraded)."""

    def __init__(self, level: int = 3, config: CompressionConfig | None = None):
        self.config = config or CompressionConfig.from_level(level)
        self.stats = CompressionStats()
        self.degradations = 0  # batch splits forced by accelerator OOM

    def __enter__(self) -> "BatchManager":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def compress_batch(self, items: list[BatchItem] | list[bytes]) -> list[BatchItem]:
        t0 = time.perf_counter()
        norm = [it if isinstance(it, BatchItem) else BatchItem(it) for it in items]

        def on_degrade(n):
            self.degradations += 1

        outs = _compress_items_degraded(
            [it.data for it in norm], self.config, on_degrade
        )
        for it, out in zip(norm, outs):
            it.output = out
            it.status = Status.SUCCESS
        dt = time.perf_counter() - t0
        self.stats.total_input_bytes += sum(len(it.data) for it in norm)
        self.stats.total_output_bytes += sum(len(it.output or b"") for it in norm)
        self.stats.total_frames += len(norm)
        self.stats.total_compress_calls += 1
        self.stats.total_compress_time_s += dt
        return norm

    def compress_batch_async(self, items: list[bytes]):
        """Dispatch-now / resolve-later batch compression.

        JAX dispatch is asynchronous, so device work overlaps host code until
        the returned zero-arg resolver is called — the analogue of the
        reference's double-buffered `decompress_async_no_sync` pattern
        (manager.h:219-238). The resolver returns list[BatchItem]."""
        import concurrent.futures

        ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        fut = ex.submit(self.compress_batch, items)

        def resolve() -> list[BatchItem]:
            try:
                return fut.result()
            finally:
                ex.shutdown(wait=False)

        return resolve

    def decompress_batch_to_device(self, items: list[bytes], max_block: int = 128 * 1024):
        """Inference path: decompress single-block frames into device-resident
        arrays (see api/decompress.decompress_batch_to_device)."""
        from .decompress import decompress_batch_to_device

        return decompress_batch_to_device(items, max_block)

    def decompress_batch(
        self, items: list[BatchItem] | list[bytes], use_tpu: bool = False
    ) -> list[BatchItem]:
        t0 = time.perf_counter()
        norm = [it if isinstance(it, BatchItem) else BatchItem(it) for it in items]
        if use_tpu:
            from .decompress import decompress_batch_tpu

            try:
                outs = decompress_batch_tpu([it.data for it in norm])
                for it, out in zip(norm, outs):
                    it.output, it.status = out, Status.SUCCESS
                self.stats.total_decompress_calls += 1
                self.stats.total_decompress_time_s += time.perf_counter() - t0
                return norm
            except Exception:
                pass  # fall through to the per-item host path with statuses
        for it in norm:
            try:
                it.output = _decompress_host(it.data)
                it.status = Status.SUCCESS
            except Exception:
                it.output = None
                it.status = Status.ERROR_CORRUPT_DATA
        self.stats.total_decompress_calls += 1
        self.stats.total_decompress_time_s += time.perf_counter() - t0
        return norm


class StreamingManager:
    """Chunked single-frame streaming (reference ZstdStreamingManager,
    manager.h:300-352; StreamingContext manager.cu:770).

    Emits one zstd frame across `compress_chunk` calls: frame header (unknown
    content size) on the first chunk, per-chunk blocks, closing (+ optional
    checksum) on `flush`. Matches stay chunk-local, so chunk boundaries are
    block boundaries (the reference's window-history mode is a ratio
    optimization, not a format requirement)."""

    def __init__(
        self,
        level: int = 3,
        config: CompressionConfig | None = None,
        window_history: bool = True,
    ):
        self.config = config or CompressionConfig.from_level(level)
        self.window_history = window_history
        self.reset()

    def reset(self) -> None:
        self._started = False
        self._finished = False
        self._hasher_data = bytearray()
        self._history = b""
        self.stats = CompressionStats()

    def compress_chunk(self, chunk: bytes) -> bytes:
        """Compress one chunk as frame blocks. With window_history, matches
        reach back into previous chunks (the reference's
        compress_chunk_with_history, manager.cu:6327-6420)."""
        if self._finished:
            raise RuntimeError("stream finished; call reset()")
        out = bytearray()
        if not self._started:
            out += write_frame_header(
                None, checksum=self.config.checksum != ChecksumPolicy.NONE,
                window_log=self.config.window_log or 20, dict_id=self.config.dict_id,
            )
            self._started = True
        if self.config.checksum != ChecksumPolicy.NONE:
            self._hasher_data += chunk
        if chunk:
            hist = [self._history] if self.window_history else None
            frame = compress_items_tpu([chunk], self.config, history=hist)[0]
            # strip the per-item frame header; keep raw block stream, clearing
            # the `last` flag of the final block.
            out += _strip_frame_to_blocks(frame, clear_last=True)
        if self.window_history:
            # Honor the window_log the frame header declares (up to the 1 MB
            # compressor reach): a config.window_log of 20 keeps 1 MB of
            # history so cross-chunk matches actually span the promised
            # window, not just the 64 KB default.
            keep = LDM_WINDOW_CAP
            if self.config.window_log:
                keep = min(1 << self.config.window_log, 1 << 20)
            self._history = (self._history + chunk)[-keep:]
        self.stats.total_input_bytes += len(chunk)
        self.stats.total_output_bytes += len(out)
        return bytes(out)

    def flush(self) -> bytes:
        """Terminate the frame (empty raw last block + checksum)."""
        if self._finished:
            return b""
        out = bytearray()
        if not self._started:
            out += write_frame_header(
                None, checksum=self.config.checksum != ChecksumPolicy.NONE,
                window_log=self.config.window_log or 20, dict_id=self.config.dict_id,
            )
            self._started = True
        out += (1).to_bytes(3, "little")  # empty Raw block, last=1
        if self.config.checksum != ChecksumPolicy.NONE:
            out += content_checksum(bytes(self._hasher_data)).to_bytes(4, "little")
        self._finished = True
        return bytes(out)

    # -- decompress half (reference manager.h:300-352 has both directions on
    # -- the one streaming manager) -------------------------------------------
    def decompress_chunk(self, data: bytes) -> bytes:
        """Incremental decode of a compressed stream; see StreamingDecompressor."""
        if not hasattr(self, "_dec") or self._dec is None:
            self._dec = StreamingDecompressor()
        return self._dec.decompress_chunk(data)

    def decompress_flush(self) -> bytes:
        if getattr(self, "_dec", None) is None:
            return b""
        return self._dec.flush()

    def decompress_reset(self) -> None:
        if getattr(self, "_dec", None) is not None:
            self._dec.reset()


class StreamingDecompressor:
    """Incremental frame decoder — the decompress half of streaming
    (reference ZstdStreamingManager::decompress_chunk + reset/flush,
    include/cuda_zstd_manager.h:300-352, impl manager.cu:6043-6456).

    Feed ARBITRARY byte chunks; decoded bytes come back as soon as whole
    blocks are available. Window history, repcodes, Repeat-mode FSE tables
    and the treeless Huffman table persist across chunk boundaries (RFC 8878
    §3.1.1.5); checksums verify incrementally (streaming XXH64 state, so no
    full-output buffering); multiple back-to-back frames and skippable
    frames are handled.
    """

    def __init__(self, window_cap: int = 1 << 23, verify_checksum: bool = True):
        self.window_cap = window_cap
        self.verify_checksum = verify_checksum
        self.reset()

    def reset(self) -> None:
        self._buf = bytearray()
        self._phase = "frame_header"
        self._hdr = None
        self._content_len = 0
        self.frames_completed = 0
        self._reset_frame_state()

    def _reset_frame_state(self) -> None:
        from ..constants import REPCODE_INIT
        from ..format.xxhash import XXH64State

        self._window = b""
        self._rep = list(REPCODE_INIT)
        self._seq_tables = None
        self._huff = None
        self._hash = XXH64State()

    @property
    def at_frame_boundary(self) -> bool:
        """True when no partial frame is pending (flush would succeed)."""
        return self._phase == "frame_header" and not self._buf

    def decompress_chunk(self, data: bytes) -> bytes:
        """Consume more compressed bytes; return newly decoded bytes."""
        from ..constants import (
            REPCODE_INIT,
            SKIPPABLE_MAGIC_MAX,
            SKIPPABLE_MAGIC_MIN,
            ZSTD_MAGIC,
        )
        from ..format import huffman as _huf  # noqa: F401 (decode deps)
        from ..format.frame import decode_literals_section, parse_frame_header
        from ..format.sequences import decode_sequences_section, execute_sequences

        self._buf += data
        out = bytearray()
        while True:
            buf = self._buf
            if self._phase == "frame_header":
                if len(buf) < 4:
                    break
                magic = int.from_bytes(buf[:4], "little")
                if SKIPPABLE_MAGIC_MIN <= magic <= SKIPPABLE_MAGIC_MAX:
                    if len(buf) < 8:
                        break
                    size = int.from_bytes(buf[4:8], "little")
                    if len(buf) < 8 + size:
                        break
                    del self._buf[: 8 + size]
                    continue
                if magic != ZSTD_MAGIC:
                    raise ValueError(f"bad magic 0x{magic:08X}")
                if len(buf) < 5:
                    break
                fhd = buf[4]
                fcs_flag, single_segment, did_flag = fhd >> 6, (fhd >> 5) & 1, fhd & 3
                need = (
                    5
                    + (0 if single_segment else 1)
                    + (0, 1, 2, 4)[did_flag]
                    + ((1 if single_segment else 0), 2, 4, 8)[fcs_flag]
                )
                if len(buf) < need:
                    break
                self._hdr = parse_frame_header(bytes(buf[:need]))
                del self._buf[:need]
                self._phase = "blocks"
                self._content_len = 0
                self._reset_frame_state()
                continue
            if self._phase == "blocks":
                if len(buf) < 3:
                    break
                bh = int.from_bytes(buf[:3], "little")
                last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
                body_len = 1 if btype == BLOCK_RLE else bsize
                if len(buf) < 3 + body_len:
                    break
                body = bytes(buf[3 : 3 + body_len])
                del self._buf[: 3 + body_len]
                if btype == BLOCK_RAW:
                    decoded = body
                elif btype == BLOCK_RLE:
                    decoded = body[:1] * bsize
                elif btype == BLOCK_COMPRESSED:
                    lit = decode_literals_section(body, self._huff)
                    self._huff = lit.huff_table
                    seqs, new_tables, _ = decode_sequences_section(
                        body[lit.consumed :], self._seq_tables
                    )
                    if seqs is not None:
                        self._seq_tables = new_tables
                    decoded, self._rep = execute_sequences(
                        lit.data, seqs, self._rep, window=self._window
                    )
                else:
                    raise ValueError("reserved block type")
                out += decoded
                self._content_len += len(decoded)
                self._window = (self._window + decoded)[-self.window_cap :]
                if self.verify_checksum and self._hdr.has_checksum:
                    self._hash.update(decoded)
                if last:
                    cs = self._hdr.content_size
                    if cs is not None and self._content_len != cs:
                        raise ValueError(
                            f"content size mismatch: {self._content_len} != {cs}"
                        )
                    self._phase = "checksum" if self._hdr.has_checksum else "frame_header"
                    if self._phase == "frame_header":
                        self.frames_completed += 1
                continue
            if self._phase == "checksum":
                if len(buf) < 4:
                    break
                stored = int.from_bytes(buf[:4], "little")
                del self._buf[:4]
                if self.verify_checksum and stored != (self._hash.digest() & 0xFFFFFFFF):
                    raise ValueError("content checksum mismatch")
                self.frames_completed += 1
                self._phase = "frame_header"
                continue
        return bytes(out)

    def flush(self) -> bytes:
        """Assert stream completeness (mirrors the reference's flush: no
        buffered output exists — blocks decode eagerly)."""
        if not self.at_frame_boundary:
            raise ValueError("incomplete frame at flush")
        return b""


def _strip_frame_to_blocks(frame: bytes, clear_last: bool) -> bytes:
    """Drop the frame header (and checksum) from a single-frame buffer,
    returning the raw block stream; optionally clear the final last-block flag."""
    from ..format.frame import parse_frame_header

    hdr = parse_frame_header(frame)
    pos = hdr.header_size
    blocks = bytearray()
    while True:
        bh = int.from_bytes(frame[pos : pos + 3], "little")
        last = bh & 1
        btype = (bh >> 1) & 3
        bsize = bh >> 3
        size = 1 if btype == BLOCK_RLE else bsize
        new_bh = bh & ~1 if clear_last else bh
        blocks += new_bh.to_bytes(3, "little")
        blocks += frame[pos + 3 : pos + 3 + size]
        pos += 3 + size
        if last:
            break
    return bytes(blocks)
