"""Benchmark: batched compression throughput on a GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "GB/s", "vs_baseline": N,
   "device": {"platform", "kind", "count"}, ...}

Refuses to run (exit 2) when JAX finds no accelerator. Baseline = the
reference's peak batch-compress throughput, 9.81 GB/s on an RTX 5080 Laptop
GPU (reference README.md:903; see BASELINE.md). The corpus is a seeded
Silesia-like mix (text / structured / binary / random / repetitive), since
the real Silesia corpus is not redistributable. Produced frames are decoded
and compared before timing: by stock libzstd when `zstandard` is installed,
else by this package's host decoder; the line names which.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

BASELINE_GBPS = 9.81


def make_corpus(total_bytes: int, seed: int = 0x51E51A) -> bytes:
    """Deterministic mixed corpus with Silesia-like composition.

    Parts are generated long enough to fill total_bytes WITHOUT wholesale
    self-duplication (an earlier `blob += blob` fill made the corpus one
    giant self-copy at ~total/2 distance — unrepresentative of Silesia and
    measuring window reach instead of matching quality)."""
    rng = np.random.default_rng(seed)
    parts: list[bytes] = []
    # english-ish markov text (dickens/webster stand-in)
    words = (
        b"the of and to a in that it is was for on are with as his they be at "
        b"one have this from or had by hot word but what some we can out other "
        b"were all there when up use your how said an each she which do their "
        b"time if will way about many then them write would like so these her "
        b"long make thing see him two has look more day could go come did number"
    ).split()
    state = seed & 0x7FFFFFFF
    text = []
    for _ in range(total_bytes // 4 // 6 + total_bytes // 16):
        state = (state * 1103515245 + 12345) & 0x7FFFFFFF
        text.append(words[state % len(words)])
    parts.append(b" ".join(text))
    # structured records (xml/database stand-in)
    rec = b'<row id="%06d" val="%08x" flag="true"><name>item-%04d</name></row>\n'
    parts.append(b"".join(rec % (i, i * 2654435761 % (1 << 32), i % 3000)
                          for i in range(total_bytes // 4 // 64 + total_bytes // 1024)))
    # binary numeric data (mr/sao stand-in: correlated doubles)
    walk = np.cumsum(rng.normal(0, 1, total_bytes // 8 // 4 + total_bytes // 64)).astype(np.float32)
    parts.append(walk.tobytes())
    # hard-to-compress (x-ray stand-in)
    parts.append(rng.integers(0, 256, total_bytes // 8, dtype=np.uint8).tobytes())
    # repetitive (nci stand-in)
    parts.append((b"c1ccccc1 CC(=O)Nc1ccc(O)cc1 " * (total_bytes // 8 // 28 + 1)))
    blob = b"".join(parts)
    if len(blob) < total_bytes:  # safety fill: unique random, never a self-copy
        blob += rng.integers(0, 256, total_bytes - len(blob), dtype=np.uint8).tobytes()
    return blob[:total_bytes]


def _host_decoder():
    """(name, decode(frame, size) -> bytes): libzstd when installed, else
    this package's native engine (or its numpy oracle without a toolchain)."""
    try:
        import zstandard

        d = zstandard.ZstdDecompressor()
        return "libzstd", lambda f, n: d.decompress(f, max_output_size=n)
    except ImportError:
        from tpu_zstd.utils.native import NativeEngine

        eng = NativeEngine.create(3)
        if eng is not None:
            return "native engine", eng.decompress
        from tpu_zstd.format.frame import decompress

        return "numpy oracle", lambda f, n: decompress(f)


def main() -> None:
    from tpu_zstd import platform

    if not platform.accelerator_available():
        print("bench.py: no accelerator visible to JAX", file=sys.stderr)
        sys.exit(2)
    platform.init_compile_cache()

    import jax
    import jax.numpy as jnp

    from tpu_zstd.ops.pipeline import (
        DEFAULT_CONFIG,
        compress_blocks_staged,
        compress_blocks_staged_many,
    )
    from tpu_zstd.api.manager import compress_items_tpu
    from tpu_zstd.api.config import CompressionConfig

    N = DEFAULT_CONFIG.block_size
    B = 128
    data = make_corpus(B * N)
    dec_name, host_decode = _host_decoder()
    blocks = np.frombuffer(data, dtype=np.uint8).reshape(B, N)
    lengths = np.full(B, N, dtype=np.int32)
    jb, jl = jnp.asarray(blocks), jnp.asarray(lengths)

    # Correctness gate: frames must decode back to the input.
    cfg = CompressionConfig.from_level(3)
    item = data[: 4 * N]
    frame = compress_items_tpu([item], cfg)[0]
    ok = host_decode(frame, len(item)) == item
    if not ok:
        print(json.dumps({"metric": "silesia_batch_compress", "value": 0.0,
                          "unit": "GB/s", "vs_baseline": 0.0,
                          "error": f"{dec_name} validation failed"}))
        sys.exit(1)

    # Warm up / compile.
    out = compress_blocks_staged(jb, jl, DEFAULT_CONFIG)
    jax.device_get(out)

    # Timed: pipelined steady state over REPS batches (parse of batch k+1
    # overlaps the bucket round-trip of batch k), timing includes fetching
    # every batch's compressed lengths.
    REPS = 5
    dt = float("inf")
    stack_lens = jax.jit(lambda ls: jnp.stack(ls))
    for _ in range(2):  # best of 2 rounds
        t0 = time.perf_counter()
        outs = compress_blocks_staged_many([(jb, jl)] * REPS, DEFAULT_CONFIG)
        # ONE final fetch of every batch's compressed lengths — the
        # reference's batch API likewise syncs its stream pool once at the
        # end of the whole batch (reference src/cuda_zstd_manager.cu:5782).
        jax.device_get(stack_lens([o[1] for o in outs]))
        dt = min(dt, (time.perf_counter() - t0) / REPS)
    gbps = B * N / dt / 1e9

    comp = compress_items_tpu([data], cfg)
    ratio = len(data) / len(comp[0])
    try:
        import zstandard

        zr = len(data) / len(zstandard.ZstdCompressor(level=3).compress(data))
    except ImportError:
        zr = None

    # Device-side decompression throughput (single-block frames, inference
    # path) with decode-acceleration metadata (format/accel.py — checkpoints
    # in a trailing skippable frame; output stays stock-libzstd-decodable).
    from dataclasses import replace

    from tpu_zstd.api.decompress import prepare_decompress_batch

    frames = compress_items_tpu(
        [data[i * N : (i + 1) * N] for i in range(B)], replace(cfg, decode_accel=True)
    )
    for probe in (0, B // 2):
        assert host_decode(frames[probe], N) == data[probe * N : (probe + 1) * N]
    # Bytes gate: the timed decode path must reproduce the corpus exactly
    # (never time a decoder whose output is unverified).
    plan = prepare_decompress_batch(frames, max_block=N)
    out, lens = plan.execute()
    out_h, lens_h = jax.device_get((out, lens))
    for i in range(B):
        assert lens_h[i] == N and out_h[i].tobytes() == data[i * N : (i + 1) * N], (
            f"device decompression mismatch at frame {i}"
        )
    # Steady-state device-resident decode (reference's DEV->DEV inference
    # path, preallocated/async API): compressed inputs live on device; time
    # repeated executes, fetch only lengths.
    DREPS = 3
    ddt = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        pending = [plan.execute() for _ in range(DREPS)]
        for _, lens in pending:
            jax.device_get(lens)
        ddt = min(ddt, (time.perf_counter() - t0) / DREPS)
    dec_gbps = B * N / ddt / 1e9

    print(json.dumps({
        "metric": "silesia_batch_compress",
        "value": round(gbps, 4),
        "unit": "GB/s",
        "vs_baseline": round(gbps / BASELINE_GBPS, 4),
        "device": platform.device_summary(),
        "detail": {
            "batch": f"{B}x{N >> 10}KB",
            "best_ms": round(dt * 1000, 2),
            "ratio_tpu_L3": round(ratio, 3),
            "ratio_libzstd_L3": round(zr, 3) if zr else None,
            "validated_by": dec_name,
            "decompress_GBps": round(dec_gbps, 4),
        },
    }))


if __name__ == "__main__":
    main()
