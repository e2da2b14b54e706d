"""HybridEngine: automatic CPU/accelerator routing with profiling feedback.

Counterpart of the reference's hybrid layer
(reference include/cuda_zstd_hybrid.h:73-240, src/cuda_zstd_hybrid.cu:142-745):
`decide_route` reproduces the AUTO matrix (hybrid.cu:196-328) in terms of
host/device-resident numpy/jax arrays; ADAPTIVE keeps a rolling throughput
history per backend with the same 1.2x switching hysteresis (hybrid.cu:216-236).
The CPU backend is libzstd via the `zstandard` package when it is installed
(the same role libzstd plays in the reference, CMakeLists.txt:31-32), and
this package's native engine otherwise. `Backend.TPU_KERNELS` names the
device pipeline, whatever the accelerator.
"""

from __future__ import annotations

import enum
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from .config import CompressionConfig, Status


class Backend(enum.IntEnum):
    CPU_LIBZSTD = 0
    TPU_KERNELS = 1


class RoutingMode(enum.IntEnum):
    AUTO = 0
    FORCE_CPU = 1
    FORCE_TPU = 2
    ADAPTIVE = 3


class DataLocation(enum.IntEnum):
    UNKNOWN = 0
    HOST = 1
    DEVICE = 2


@dataclass
class HybridConfig:
    """Routing thresholds (reference types.h:358-385). The two size
    thresholds were set on another accelerator and are not measured on the
    H100."""

    mode: RoutingMode = RoutingMode.AUTO
    tpu_batch_threshold: int = 4 << 20   # host-resident data below this -> CPU
    tpu_device_threshold: int = 64 << 10  # device-resident data >= this -> device
    adaptive_history: int = 16
    adaptive_hysteresis: float = 1.2
    enable_profiling: bool = True
    level: int = 3


@dataclass
class HybridResult:
    """Per-call breakdown (reference types.h:392-425)."""

    backend: Backend = Backend.CPU_LIBZSTD
    routing_reason: str = ""
    total_time_s: float = 0.0
    compute_time_s: float = 0.0
    transfer_time_s: float = 0.0
    input_size: int = 0
    output_size: int = 0

    @property
    def throughput_mbps(self) -> float:
        return self.input_size / self.total_time_s / 1e6 if self.total_time_s else 0.0


def detect_location(data) -> DataLocation:
    """Pointer-attribute probing (reference hybrid.cu:334-355) becomes type
    probing: jax.Array committed to an accelerator counts as DEVICE."""
    try:
        import jax

        if isinstance(data, jax.Array):
            if any(d.platform != "cpu" for d in data.devices()):
                return DataLocation.DEVICE
            return DataLocation.HOST
    except Exception:
        pass
    if isinstance(data, (bytes, bytearray, memoryview, np.ndarray)):
        return DataLocation.HOST
    return DataLocation.UNKNOWN


class HybridEngine:
    """Routes each call to the CPU codec or the device pipeline."""

    def __init__(self, config: HybridConfig | None = None,
                 compression: CompressionConfig | None = None):
        self.config = config or HybridConfig()
        self.compression = compression or CompressionConfig.from_level(self.config.level)
        self._history: dict[Backend, deque[float]] = {
            Backend.CPU_LIBZSTD: deque(maxlen=self.config.adaptive_history),
            Backend.TPU_KERNELS: deque(maxlen=self.config.adaptive_history),
        }

    # -- routing --------------------------------------------------------------
    def decide_route(
        self, size: int, location: DataLocation, is_compress: bool,
        accel: bool = False,
    ) -> tuple[Backend, str]:
        mode = self.config.mode
        if mode == RoutingMode.FORCE_CPU:
            return Backend.CPU_LIBZSTD, "forced CPU"
        if mode == RoutingMode.FORCE_TPU:
            return Backend.TPU_KERNELS, "forced device"
        if mode == RoutingMode.ADAPTIVE:
            cpu_avg = self._avg(Backend.CPU_LIBZSTD)
            tpu_avg = self._avg(Backend.TPU_KERNELS)
            if cpu_avg and tpu_avg:
                if tpu_avg > cpu_avg * self.config.adaptive_hysteresis:
                    return Backend.TPU_KERNELS, f"adaptive: device {tpu_avg:.0f} > CPU {cpu_avg:.0f} MB/s"
                return Backend.CPU_LIBZSTD, f"adaptive: CPU {cpu_avg:.0f} MB/s wins"
            # fall through to AUTO until both backends have samples
        if location == DataLocation.DEVICE:
            if size >= self.config.tpu_device_threshold:
                return Backend.TPU_KERNELS, "device-resident data stays on device"
            return Backend.TPU_KERNELS, "device-resident small data (avoid transfer)"
        if not is_compress:
            # Host-bound decode goes to the CPU (a rule set on another
            # accelerator; not measured on the H100). The device decoder is
            # meant for output that stays on the device — the
            # decompress_to_device / DecompressPlan inference path, which
            # routes explicitly, not through here.
            return Backend.CPU_LIBZSTD, "host-bound decode: CPU libzstd wins"
        if size >= self.config.tpu_batch_threshold:
            return Backend.TPU_KERNELS, "large host buffer: device batch path"
        return Backend.CPU_LIBZSTD, "small host buffer: CPU faster than transfer"

    def _avg(self, backend: Backend) -> float:
        h = self._history[backend]
        return sum(h) / len(h) if h else 0.0

    # -- operations -----------------------------------------------------------
    def compress(self, data, result: HybridResult | None = None) -> bytes:
        res = result if result is not None else HybridResult()
        t0 = time.perf_counter()
        loc = detect_location(data)
        raw = _to_bytes(data)
        backend, reason = self.decide_route(len(raw), loc, True)
        t1 = time.perf_counter()
        if backend == Backend.CPU_LIBZSTD:
            out, engine = self._cpu_compress(raw)
            reason = f"{reason} ({engine})"
        else:
            out = self._tpu_compress(raw)
        t2 = time.perf_counter()
        res.backend, res.routing_reason = backend, reason
        res.transfer_time_s = t1 - t0
        res.compute_time_s = t2 - t1
        res.total_time_s = t2 - t0
        res.input_size, res.output_size = len(raw), len(out)
        if self.config.enable_profiling and res.total_time_s > 0:
            self._history[backend].append(len(raw) / res.total_time_s / 1e6)
        return out

    def decompress(self, data, max_output_size: int | None = None,
                   result: HybridResult | None = None) -> bytes:
        """Routed decompression (reference hybrid.cu:278-327 routes GPU
        decompress for device-resident/small-device data; here the device
        path takes decode-accelerated frames — whose literals and sequences
        decode chunk-parallel on device — and large host frames, with the
        host decoder as the default route. Frames the device decoder does not
        support (its ValueError) decode on the host; any other error
        propagates."""
        res = result if result is not None else HybridResult()
        t0 = time.perf_counter()
        loc = detect_location(data)
        raw = _to_bytes(data)
        backend, reason = self.decide_route(
            len(raw), loc, False, accel=_has_accel_meta(raw)
        )
        out = None
        if backend == Backend.TPU_KERNELS:
            try:
                out = self._tpu_decompress(raw)
            except ValueError as e:
                backend, reason = Backend.CPU_LIBZSTD, f"device decoder refused the frame: {e}"
        if out is None:
            from .manager import _decompress_host

            out = _decompress_host(raw, max_output_size)
        res.backend, res.routing_reason = backend, reason
        res.total_time_s = res.compute_time_s = time.perf_counter() - t0
        res.input_size, res.output_size = len(raw), len(out)
        if self.config.enable_profiling and res.total_time_s > 0:
            self._history[backend].append(len(out) / res.total_time_s / 1e6)
        return out

    def compress_batch(self, items: list) -> list[bytes]:
        raws = [_to_bytes(d) for d in items]
        total = sum(len(r) for r in raws)
        backend, _ = self.decide_route(total, DataLocation.HOST, True)
        if backend == Backend.TPU_KERNELS:
            from .manager import compress_items_tpu

            return compress_items_tpu(raws, self.compression)
        return [self._cpu_compress(r)[0] for r in raws]

    def decompress_batch(self, items: list) -> list[bytes]:
        """Batched routed decompression: accel-metadata frames decode on the
        device as one batch; the rest take the CPU route. Frames the device
        decoder does not support (its ValueError) decode on the host."""
        raws = [_to_bytes(d) for d in items]
        total = sum(len(r) for r in raws)
        accel = all(_has_accel_meta(r) for r in raws) if raws else False
        backend, _ = self.decide_route(total, DataLocation.HOST, False, accel=accel)
        if backend == Backend.TPU_KERNELS:
            from .decompress import decompress_batch_tpu

            try:
                return decompress_batch_tpu(raws)
            except ValueError:
                pass
        from .manager import _decompress_host

        return [_decompress_host(r, None) for r in raws]

    def decompress_to_device(self, items: list, max_block: int = 128 * 1024):
        """Inference route: decompress a batch straight into device-resident
        arrays (reference inference API manager.h:193-273). Always on device."""
        from .decompress import decompress_batch_to_device

        return decompress_batch_to_device([_to_bytes(d) for d in items], max_block)

    # -- backends -------------------------------------------------------------
    def _cpu_compress(self, data: bytes) -> tuple[bytes, str]:
        """(frame, engine): stock libzstd when `zstandard` is installed,
        else this package's host engine (as Manager's CPU path)."""
        try:
            import zstandard
        except ImportError:
            from .manager import Manager

            return Manager(config=self.compression)._compress_cpu(data), "native engine"
        c = zstandard.ZstdCompressor(level=self.compression.level)
        return c.compress(data), "libzstd"

    def _tpu_compress(self, data: bytes) -> bytes:
        from .manager import compress_items_tpu

        return compress_items_tpu([data], self.compression)[0]

    def _tpu_decompress(self, raw: bytes) -> bytes:
        """Single-block accel frames take the fully-device chunk-parallel
        decoder; anything else the general device block-batch decoder."""
        from .decompress import decompress_batch_to_device, decompress_batch_tpu

        try:
            out, lens = decompress_batch_to_device([raw])
            return bytes(np.asarray(out)[0][: int(np.asarray(lens)[0])])
        except ValueError:
            return decompress_batch_tpu([raw])[0]


def _has_accel_meta(frame: bytes) -> bool:
    """True when the frame carries decode-acceleration checkpoints."""
    try:
        from ..format.accel import parse_accel_tail

        return parse_accel_tail(frame)[0] is not None
    except Exception:
        return False


def _to_bytes(data) -> bytes:
    if isinstance(data, bytes):
        return data
    if isinstance(data, (bytearray, memoryview)):
        return bytes(data)
    if isinstance(data, np.ndarray):
        return data.astype(np.uint8, copy=False).tobytes()
    try:
        import jax

        if isinstance(data, jax.Array):
            return np.asarray(data).astype(np.uint8, copy=False).tobytes()
    except Exception:
        pass
    raise TypeError(f"unsupported input type {type(data)}")
