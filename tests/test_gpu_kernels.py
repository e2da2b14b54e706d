"""The Pallas kernels as compiled for the GPU (no interpreter).

These need a CUDA card: they skip on the CPU (the `gpu` fixture decides at
run time), and the same checks run at full size as chip_smoke.py's
`kernels` phase.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_zstd.ops.lz77_jax import greedy_scan
from tpu_zstd.ops.pallas_greedy import greedy_segments
from tpu_zstd.ops.pallas_rep import rep_codes_blocks, rep_codes_scan

pytestmark = pytest.mark.gpu


def test_rep_kernel_compiled(gpu):
    rng = np.random.default_rng(1)
    S, rows = 70, 4096
    n = rng.integers(0, rows + 1, (S, 1))
    valid = np.arange(rows)[None, :] < n
    offs = rng.choice([3, 9, 27, 81, 1000], (S, rows))
    lls = rng.integers(0, 2, (S, rows))
    packed = jnp.asarray(np.where(valid, offs | (lls << 21) | (1 << 22), 0), jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(rep_codes_blocks(packed)), np.asarray(jax.vmap(rep_codes_scan)(packed))
    )


def test_greedy_kernel_compiled(gpu):
    rng = np.random.default_rng(2)
    S, seg = 300, 1024
    pos = np.arange(seg)[None, :]
    ml = np.minimum(rng.integers(4, 41, (S, seg)), seg - pos)
    matched = (rng.random((S, seg)) < 0.3) & (ml >= 4)
    defer = rng.random((S, seg)) < 0.1
    packed = jnp.asarray(np.where(matched, ml, 1) | (matched << 16) | (defer << 17), jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(greedy_segments(packed)), np.asarray(greedy_scan(packed))
    )


def test_pipeline_roundtrip_with_kernels(gpu):
    from tpu_zstd.format.frame import decompress
    from tpu_zstd.ops.pipeline import PipelineConfig, compress

    data = (b"kernel path round trip " * 3000)[:60000]
    cfg = PipelineConfig(block_size=16384, hash_log=14, depth=4, mf_win_log=11)
    assert decompress(compress(data, cfg, checksum=True)) == data
