#!/usr/bin/env python3
"""Smoke test of the codec's main path on one NVIDIA GPU.

Runs every phase below once in one JAX process, through the entry points a
user calls, on a seeded Silesia-like corpus (`bench.make_corpus`), and
checks every output byte for byte:

  native_build      the host C++ engine builds from csrc/ and loads
  batch_compress    512 items x 128 KB at L3 through BatchManager; every
                    frame decoded by the native engine (and by libzstd when
                    `zstandard` is installed), a sample by the numpy oracle
  device_decompress the same items as decode-accelerated frames, decoded by
                    prepare_decompress_batch(...).execute() with the output
                    kept on the device until one final fetch
  single_shot       one 8 MiB item through Manager(TPU_BATCH), both ways,
                    checksum written and verified
  hybrid            one 4 MiB item through HybridEngine(FORCE_TPU), both ways
  archival          16 x 128 KB at L19 (optimal-parse DP, min_match 3)
  kernels           each hand-written Pallas kernel at the batch shapes,
                    compared with its plain reference and timed beside it,
                    and the parse stage timed with the kernels on and off

Every phase prints one JSON line (shapes, compile and run seconds, bytes
verified, peak device memory). The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
Any failure raises, exits non-zero and prints no such line; so does a run
without a GPU, or from a directory without the package.

    python chip_smoke.py                 # one card, all phases
    python chip_smoke.py --four          # only the four-card sharded phase
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
KB = 1024
MB = 1024 * 1024
ITEMS = 512         # batch items (the reference's batch row is 64 MB)
ITEM = 128 * KB     # item size = the pipeline's block size

_COMPILE_S = [0.0]


def _on_event(event: str, duration: float, **_kw) -> None:
    if event.startswith("/jax/core/compile/"):
        _COMPILE_S[0] += duration


def _check(cond, msg) -> None:
    """A correctness gate that stays under `python -O`."""
    if not cond:
        raise AssertionError(msg)


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def gpu_info() -> list[str]:
    """Name and power limit of each card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _run_phase(name: str, fn, *args, **kw) -> dict:
    """Run one phase, adding its compile seconds, wall seconds and the
    device's peak memory to the line it prints."""
    c0 = _COMPILE_S[0]
    t0 = time.perf_counter()
    info = fn(*args, **kw)
    info = {
        "phase": name,
        **info,
        "compile_s": round(_COMPILE_S[0] - c0, 3),
        "wall_s": round(time.perf_counter() - t0, 3),
        "peak_bytes_in_use": _peak_bytes(),
    }
    _emit(info)
    return info


def _timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def _best_time(fn, *args, reps: int = 3) -> float:
    return min(_timed(fn, *args)[1] for _ in range(reps))


# --- host-side checks ------------------------------------------------------------


def verify_frames(frames, items, oracle_sample: int = 2) -> list[str]:
    """Decode every frame with the native engine (and libzstd when
    installed), a sample with the numpy oracle; returns the decoders run."""
    from tpu_zstd.format.frame import decompress as oracle
    from tpu_zstd.utils.native import NativeEngine

    eng = NativeEngine.create(3)
    _check(eng is not None, "native engine unavailable")
    for i, (f, it) in enumerate(zip(frames, items)):
        _check(eng.decompress(f, len(it)) == it, f"native engine mismatch, frame {i}")
    ran = ["native engine"]
    step = max(1, len(frames) // max(oracle_sample, 1))
    for i in list(range(0, len(frames), step))[:oracle_sample]:
        _check(oracle(frames[i]) == items[i], f"numpy oracle mismatch, frame {i}")
    ran.append(f"numpy oracle ({min(oracle_sample, len(frames))} frames)")
    try:
        import zstandard
    except ImportError:
        return ran
    d = zstandard.ZstdDecompressor()
    for i, (f, it) in enumerate(zip(frames, items)):
        _check(d.decompress(f, max_output_size=len(it)) == it, f"libzstd mismatch, frame {i}")
    return ran + ["libzstd"]


# --- phases ---------------------------------------------------------------------


def phase_native_build() -> dict:
    from tpu_zstd.utils.native import get_native

    ok = get_native() is not None
    _check(ok, "native library did not build from csrc/")
    return {"built": ok}


def parse_stage_memory(n_blocks: int, block: int, level: int = 3) -> dict:
    """memory_analysis() of the compress parse stage at (n_blocks, block)."""
    import jax
    import jax.numpy as jnp

    from tpu_zstd.api.config import CompressionConfig
    from tpu_zstd.api.manager import _pipeline_config
    from tpu_zstd.ops.pipeline import _parse_prep_stage

    cfg = _pipeline_config(CompressionConfig.from_level(level))
    compiled = _parse_prep_stage.lower(
        jax.ShapeDtypeStruct((n_blocks, block), jnp.uint8),
        jax.ShapeDtypeStruct((n_blocks,), jnp.int32),
        cfg,
    ).compile()
    ma = compiled.memory_analysis()
    need = ma.temp_size_in_bytes + ma.argument_size_in_bytes + ma.output_size_in_bytes
    limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit")
    return {"need_bytes": int(need), "limit_bytes": limit}


def _config(level: int = 3):
    from tpu_zstd import CompressionConfig

    return CompressionConfig.from_level(level)


def phase_batch_compress(items, cfg=None) -> dict:
    from tpu_zstd import BatchManager

    cfg = cfg or _config()
    mgr = BatchManager(config=cfg)
    t0 = time.perf_counter()
    first = [it.output for it in mgr.compress_batch(items)]
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    frames = [it.output for it in mgr.compress_batch(items)]
    run_s = time.perf_counter() - t0
    _check(frames == first, "two runs of the same batch differ")
    _check(mgr.degradations == 0, f"{mgr.degradations} OOM degradations")
    decoders = verify_frames(frames, items)
    total = sum(len(x) for x in items)
    return {
        "shapes": f"{len(items)}x{len(items[0]) // KB}KB L{cfg.level}",
        "first_call_s": round(first_s, 3),
        "run_s": round(run_s, 3),
        "bytes_verified": total,
        "ratio": round(total / sum(len(f) for f in frames), 4),
        "decoders": decoders,
        "degradations": mgr.degradations,
    }


def phase_device_decompress(items, cfg=None) -> dict:
    import dataclasses

    import jax
    import numpy as np

    from tpu_zstd import BatchManager
    from tpu_zstd.api.decompress import prepare_decompress_batch

    cfg = dataclasses.replace(cfg or _config(), decode_accel=True)
    mgr = BatchManager(config=cfg)
    frames = [it.output for it in mgr.compress_batch(items)]
    _check(mgr.degradations == 0, f"{mgr.degradations} OOM degradations")
    N = max(len(x) for x in items)
    plan = prepare_decompress_batch(frames, max_block=N)
    (out, lens), first_s = _timed(plan.execute)
    (out, lens), run_s = _timed(plan.execute)
    out_h, lens_h = jax.device_get((out, lens))  # the one fetch
    bad = [
        i for i, it in enumerate(items)
        if int(lens_h[i]) != len(it)
        or not np.array_equal(out_h[i, : len(it)], np.frombuffer(it, np.uint8))
    ]
    _check(not bad, f"device decode mismatch in {len(bad)} of {len(items)} frames: {bad[:8]}")
    return {
        "shapes": f"{len(items)}x{N // KB}KB accel frames",
        "first_call_s": round(first_s, 3),
        "run_s": round(run_s, 3),
        "bytes_verified": int(sum(len(x) for x in items)),
    }


def phase_single_shot(data: bytes, cfg=None) -> dict:
    import dataclasses

    from tpu_zstd import ChecksumPolicy, ExecutionPath, Manager
    from tpu_zstd.format.frame import parse_frame_header

    cfg = dataclasses.replace(
        cfg or _config(), checksum=ChecksumPolicy.COMPUTE_AND_VERIFY
    )
    m = Manager(config=cfg, execution_path=ExecutionPath.TPU_BATCH)
    t0 = time.perf_counter()
    frame = m.compress(data)
    c_s = time.perf_counter() - t0
    _check(parse_frame_header(frame).has_checksum, "frame carries no checksum")
    t0 = time.perf_counter()
    out = m.decompress(frame)  # verifies the stored checksum
    d_s = time.perf_counter() - t0
    _check(out == data, "single-shot round trip mismatch")
    decoders = verify_frames([frame], [data], oracle_sample=0)[:1]
    return {
        "shapes": f"1x{len(data) / MB:g}MiB ({-(-len(data) // cfg.block_size)} blocks)",
        "compress_s": round(c_s, 3),
        "decompress_s": round(d_s, 3),
        "run_s": round(c_s + d_s, 3),
        "bytes_verified": len(data),
        "decoders": decoders + ["device decoder with checksum"],
    }


def phase_hybrid(data: bytes, cfg=None) -> dict:
    from tpu_zstd import Backend, HybridConfig, HybridEngine, HybridResult, RoutingMode

    eng = HybridEngine(HybridConfig(mode=RoutingMode.FORCE_TPU), compression=cfg or _config())
    rc, rd = HybridResult(), HybridResult()
    frame = eng.compress(data, result=rc)
    _check(rc.backend == Backend.TPU_KERNELS, rc.routing_reason)
    out = eng.decompress(frame, result=rd)
    _check(rd.backend == Backend.TPU_KERNELS, rd.routing_reason)
    _check(out == data, "hybrid round trip mismatch")
    return {
        "shapes": f"1x{len(data) / MB:g}MiB",
        "compress_s": round(rc.total_time_s, 3),
        "decompress_s": round(rd.total_time_s, 3),
        "run_s": round(rc.total_time_s + rd.total_time_s, 3),
        "backend": [rc.backend.name, rd.backend.name],
        "bytes_verified": len(data),
    }


def _greedy_inputs(n_seg: int, seg: int, seed: int):
    """Random greedy-walk inputs: matches of 4..40 bytes at 30% of
    positions, truncated at the segment end; 10% lazy deferrals."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pos = np.arange(seg, dtype=np.int32)[None, :]
    ml = rng.integers(4, 41, (n_seg, seg), dtype=np.int32)
    ml = np.minimum(ml, seg - pos)
    matched = (rng.random((n_seg, seg)) < 0.3) & (ml >= 4)
    defer = rng.random((n_seg, seg)) < 0.1
    step = np.where(matched, ml, 1)
    return (step | (matched << 16) | (defer << 17)).astype(np.int32)


def phase_kernels(items, cfg=None, seed: int = 0, e2e: bool = False, interpret: bool = False) -> dict:
    """Each Pallas kernel at the batch phase's shapes: compared once with
    its plain reference on the card, and timed beside it. (interpret=True
    runs the kernels in the Pallas interpreter: for CPU tests only.)"""
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpu_zstd.api.manager import _pipeline_config
    from tpu_zstd.ops.lz77_jax import greedy_scan
    from tpu_zstd.ops import pallas_greedy, pallas_rep
    from tpu_zstd.ops.pallas_rep import rep_codes_scan
    from tpu_zstd.ops.pipeline import _parse_prep_stage

    rep_codes_blocks = functools.partial(pallas_rep.rep_codes_blocks, interpret=interpret)
    greedy_segments = functools.partial(pallas_greedy.greedy_segments, interpret=interpret)
    cfg = _pipeline_config(cfg or _config())
    N = cfg.block_size
    B = len(items)
    blocks = np.zeros((B, N), np.uint8)
    for i, it in enumerate(items):
        blocks[i, : len(it)] = np.frombuffer(it, np.uint8)
    jb = jnp.asarray(blocks)
    jl = jnp.asarray(np.asarray([len(x) for x in items], np.int32))

    # Repcode walk: the parse stage's own sequence lists and its own ob.
    seqs, _ = jax.block_until_ready(_parse_prep_stage(jb, jl, cfg))
    k = jnp.arange(seqs.ll.shape[1], dtype=jnp.int32)[None, :]
    valid = k < seqs.nseq[:, None]
    packed = jnp.where(
        valid, seqs.off | ((seqs.ll > 0).astype(jnp.int32) << 21) | (1 << 22), 0
    )
    scan_fn = jax.jit(jax.vmap(rep_codes_scan))
    got = np.asarray(rep_codes_blocks(packed))
    want = np.asarray(scan_fn(packed))
    _check(np.array_equal(got, want), "rep_codes kernel != rep_codes_scan")
    _check(np.array_equal(got, np.asarray(seqs.ob)), "rep_codes kernel != parse ob")
    rep_k = _best_time(rep_codes_blocks, packed)
    rep_x = _best_time(scan_fn, packed)

    # Greedy walk: every segment of the batch.
    seg = 1 << cfg.seg_log
    gin = jnp.asarray(_greedy_inputs(B * N // seg, seg, seed))
    gscan = jax.jit(greedy_scan)
    _check(np.array_equal(
        np.asarray(greedy_segments(gin)), np.asarray(gscan(gin))
    ), "greedy kernel != greedy_scan")
    gr_k = _best_time(greedy_segments, gin)
    gr_x = _best_time(gscan, gin)

    info = {
        "shapes": {
            "rep_codes": list(packed.shape),
            "greedy": list(gin.shape),
            "max_nseq": int(jnp.max(seqs.nseq)),
        },
        "rep_codes_ms": {"pallas_triton": round(rep_k * 1e3, 3), "xla_scan": round(rep_x * 1e3, 3)},
        "greedy_ms": {"pallas_triton": round(gr_k * 1e3, 3), "xla_scan": round(gr_x * 1e3, 3)},
        "bytes_verified": int(packed.size + gin.size) * 4,
    }
    if e2e:
        info["parse_stage_ms"] = _parse_stage_ab(jb, jl, cfg)
    return info


def _parse_stage_ab(jb, jl, cfg) -> dict:
    """The compress parse stage timed with the kernels on and off (the
    choice is made at trace time, so caches are cleared in between)."""
    import jax

    from tpu_zstd import platform
    from tpu_zstd.ops.pipeline import _parse_prep_stage

    real = platform.use_gpu_kernels
    out = {}
    try:
        for name, on in (("pallas_triton", True), ("xla_scan", False), ("pallas_triton_again", True)):
            platform.use_gpu_kernels = lambda on=on: on
            jax.clear_caches()
            jax.block_until_ready(_parse_prep_stage(jb, jl, cfg))
            out[name] = round(_best_time(_parse_prep_stage, jb, jl, cfg) * 1e3, 3)
    finally:
        platform.use_gpu_kernels = real
        jax.clear_caches()
    return out


def phase_four(corpus: bytes, n_items: int, cfg=None) -> dict:
    """Batch sharded over a flat four-device mesh, compared frame by frame
    with one device compressing the same blocks, then decoded on the host."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpu_zstd.api.manager import _pipeline_config
    from tpu_zstd.constants import BLOCK_RLE
    from tpu_zstd.format.frame import write_frame_header
    from tpu_zstd.ops.pipeline import compress_blocks_staged
    from tpu_zstd.parallel.sharding import compress_blocks_sharded, make_mesh

    _check(len(jax.devices()) >= 4, f"need 4 devices, have {len(jax.devices())}")
    cfg = _pipeline_config(cfg or _config())
    block = cfg.block_size
    B = 4 * n_items
    blocks = np.frombuffer(corpus[: B * block], np.uint8).reshape(B, block)
    lengths = np.full(B, block, np.int32)
    mesh = make_mesh(4)
    jax.block_until_ready(compress_blocks_sharded(blocks, lengths, cfg, mesh))
    t0 = time.perf_counter()
    contents, clens, btypes = compress_blocks_sharded(blocks, lengths, cfg, mesh)
    run4 = time.perf_counter() - t0

    # One device, n_items blocks at a time, through the staged path the
    # batch managers use (same bytes as compress_blocks; its shapes are the
    # one-card batch phase's).
    one = []
    t0 = time.perf_counter()
    for c in range(4):
        sl = slice(c * n_items, (c + 1) * n_items)
        one.append(jax.device_get(compress_blocks_staged(
            jnp.asarray(blocks[sl]), jnp.asarray(lengths[sl]), cfg,
        )))
    run1 = time.perf_counter() - t0
    c1 = np.concatenate([o[0] for o in one])
    l1 = np.concatenate([o[1] for o in one])
    t1 = np.concatenate([o[2] for o in one])
    _check(np.array_equal(clens, l1) and np.array_equal(btypes, t1), "sizes/types differ")
    frames, items = [], []
    for b in range(B):
        n = 1 if btypes[b] == BLOCK_RLE else int(clens[b])
        _check(np.array_equal(contents[b, :n], c1[b, :n]), f"block {b} differs from one card")
        size = int(lengths[b]) if btypes[b] == BLOCK_RLE else n
        hdr = ((size << 3) | (int(btypes[b]) << 1) | 1).to_bytes(3, "little")
        frames.append(write_frame_header(int(lengths[b])) + hdr + contents[b, :n].tobytes())
        items.append(blocks[b].tobytes())
    decoders = verify_frames(frames, items, oracle_sample=1)
    return {
        "shapes": f"4x{n_items}x{block // KB}KB over a flat 4-device mesh",
        "sharded_run_s": round(run4, 3),
        "one_device_run_s": round(run1, 3),
        "frames_identical": B,
        "bytes_verified": int(B * block),
        "decoders": decoders,
    }


# --- driver ---------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(REPO, "tpu_zstd")):
        print("chip_smoke.py: run it from a checkout of the repository", file=sys.stderr)
        return 2
    try:
        cards = gpu_info()  # read before JAX starts
    except (OSError, subprocess.SubprocessError) as e:
        print(f"chip_smoke.py: nvidia-smi failed: {e}", file=sys.stderr)
        return 1
    for ln in cards:
        print(ln, flush=True)

    sys.path.insert(0, REPO)
    import jax
    from jax import monitoring

    from bench import make_corpus
    from tpu_zstd import platform

    platform.init_compile_cache()
    dev = platform.device_summary()
    if dev["platform"] != "gpu":
        print(f"chip_smoke.py: JAX found no GPU ({dev})", file=sys.stderr)
        return 1
    monitoring.register_event_duration_secs_listener(_on_event)
    _emit({"devices": dev, "jax": jax.__version__, "seed": args.seed})

    if args.four:
        corpus = make_corpus(4 * ITEMS * ITEM, seed=args.seed)
        _run_phase("four_card_sharded", phase_four, corpus, ITEMS)
        _emit({"ok": True, "device": dev})
        return 0

    corpus = make_corpus(ITEMS * ITEM + 12 * MB + 16 * ITEM, seed=args.seed)
    n = ITEMS
    mem = parse_stage_memory(n, ITEM)
    while mem["limit_bytes"] and mem["need_bytes"] > 0.9 * mem["limit_bytes"] and n > 1:
        n //= 2  # the batch does not fit the card: halve it and say so
        mem = parse_stage_memory(n, ITEM)
    _emit({"phase": "batch_fit", "items": n, "halved_from": ITEMS if n != ITEMS else None,
           "parse_stage_memory": mem})
    items = [corpus[i * ITEM:(i + 1) * ITEM] for i in range(n)]
    rest = corpus[ITEMS * ITEM:]
    _run_phase("native_build", phase_native_build)
    _run_phase("batch_compress", phase_batch_compress, items)
    _run_phase("device_decompress", phase_device_decompress, items)
    _run_phase("single_shot", phase_single_shot, rest[: 8 * MB])
    _run_phase("hybrid", phase_hybrid, rest[8 * MB: 12 * MB])
    arch = [rest[12 * MB + i * ITEM: 12 * MB + (i + 1) * ITEM] for i in range(16)]
    _run_phase("archival", phase_batch_compress, arch, _config(19))
    _run_phase("kernels", phase_kernels, items, seed=args.seed, e2e=True)
    _emit({"ok": True, "device": dev})
    return 0


if __name__ == "__main__":
    sys.exit(main())
