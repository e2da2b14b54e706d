"""Optimal-parse DP: scan path vs brute force, end-to-end L19 interop."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_zstd.ops.optimal_parse import (
    LIT_BITS,
    MATCH_BASE,
    SCALE,
    _mlx,
    opt_steps,
)

I32 = jnp.int32


def _brute(ml, ofc, mm, cap, seg):
    """Exact numpy DP for one segment."""
    cost = np.zeros(seg + cap + 2, np.int64)
    step = np.ones(seg, np.int64)
    for p in range(seg - 1, -1, -1):
        best = LIT_BITS * SCALE + cost[p + 1]
        ch = 1
        for l in range(mm, cap + 1):
            if ml[p] >= l:
                c = (MATCH_BASE + ofc[p] + _mlx(l)) * SCALE + cost[p + l]
                if c < best:
                    best, ch = c, l
        cost[p] = best
        step[p] = ch
    return step, cost[0]


@pytest.mark.parametrize("seg,mm,cap", [(64, 4, 16), (128, 3, 32)])
def test_dp_matches_brute_force(seg, mm, cap):
    rng = np.random.default_rng(11)
    S = 5
    ml = rng.integers(0, cap + 1, (S, seg))
    ml[rng.random((S, seg)) < 0.5] = 0  # no-match positions
    ofc = rng.integers(0, 21, (S, seg))
    packed = jnp.asarray(ml | (ofc << 7), I32)
    got = np.asarray(opt_steps(packed, mm, cap))
    for s in range(S):
        want, want_cost = _brute(ml[s], ofc[s], mm, cap, seg)
        # Multiple optimal parses can exist; compare achieved COST.
        cost = 0
        p = 0
        while p < seg:
            g = int(got[s, p])
            if g == 1:
                cost += LIT_BITS * SCALE
                p += 1
            else:
                assert ml[s, p] >= g >= mm
                cost += (MATCH_BASE + ofc[s, p] + _mlx(g)) * SCALE
                p += g
        assert cost == want_cost, (s, cost, want_cost)


def test_dp_prefers_match_over_literals():
    seg = 64
    ml = np.zeros(seg, np.int64)
    ofc = np.zeros(seg, np.int64)
    ml[0] = 16  # one 16-byte match at p=0, cheap offset
    packed = jnp.asarray((ml | (ofc << 7))[None], I32)
    got = np.asarray(opt_steps(packed, 4, 32))[0]
    assert got[0] == 16  # 11 bits beats 16 literals * 6 bits


def test_level19_roundtrip_interop():
    import zstandard

    from tpu_zstd.api.config import CompressionConfig
    from tpu_zstd.api.manager import compress_items_tpu

    rng = np.random.default_rng(3)
    base = bytes(rng.integers(0, 255, 3000, dtype=np.uint8))
    data = base + b"hello optimal parse " * 700 + base + bytes(200)
    cfg = CompressionConfig.from_level(19)
    frame = compress_items_tpu([data], cfg)[0]
    out = zstandard.ZstdDecompressor().decompress(frame, max_output_size=len(data) * 2)
    assert out == data


def test_level19_ratio_not_worse_than_level3():
    from tpu_zstd.api.config import CompressionConfig
    from tpu_zstd.api.manager import compress_items_tpu

    import pathlib

    doc = pathlib.Path(__file__).resolve().parent.parent / "SURVEY.md"
    if not doc.exists():
        import pytest

        pytest.skip("SURVEY.md corpus not present in this checkout")
    data = (doc.read_bytes() * 3)[:200_000]
    c3 = compress_items_tpu([data], CompressionConfig.from_level(3))[0]
    c19 = compress_items_tpu([data], CompressionConfig.from_level(19))[0]
    assert len(c19) <= len(c3) * 1.02
