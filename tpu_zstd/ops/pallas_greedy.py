"""Greedy-parse segment walk: a Pallas kernel (Triton route).

The greedy parse is an exact sequential walk over each SEG-byte segment
(ops/lz77_jax.py greedy_parse; the reference does it one thread per position,
reference src/lz77_parallel.cu:177 `greedy_parse_kernel`). As a `lax.scan`
of SEG steps, XLA runs each step as its own loop iteration over a handful of
small elementwise ops. Here one program walks a tile of BS segments with the
whole loop inside the kernel: the input is laid out (seg, segments) so each
step loads BS contiguous words, and the two state words stay in registers.

Packed input per position:  step | matched << 16 | defer << 17
(step <= seg < 2^16). Output per position (u8):  take | is_lit << 1.
`lz77_jax.greedy_scan` is the plain reference and the CPU path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

I32 = jnp.int32
BS = 128     # segments per program (4 warps, one segment per thread)
UNROLL = 8   # positions per loop trip: their loads do not depend on the state


def _make_kernel(seg: int):
    def kernel(in_ref, out_ref):
        def body(t, carry):
            na, me = carry  # next-allowed, match-end per segment
            for u in range(UNROLL):
                p = t * UNROLL + u
                x = in_ref[p, :]
                stp = x & 0xFFFF
                m = (x >> 16) & 1
                d = (x >> 17) & 1
                is_pp = na == p
                take = is_pp & (m == 1) & (d == 0)
                adv = jnp.where(take, stp, 1)
                me = jnp.where(take, p + stp, me)
                na = jnp.where(is_pp, p + adv, na)
                is_lit = p >= me
                out_ref[p, :] = (
                    take.astype(I32) + jnp.where(is_lit, 2, 0)
                ).astype(jnp.uint8)
            return na, me

        z = jnp.zeros((BS,), I32)
        jax.lax.fori_loop(0, seg // UNROLL, body, (z, z))

    return kernel


@functools.partial(jax.jit, static_argnames=("interpret",))
def greedy_segments(packed: jax.Array, *, interpret: bool = False) -> jax.Array:
    """Run the greedy walk over (S, seg) packed segments; returns (S, seg) u8
    of take | is_lit << 1. seg must be a multiple of UNROLL; S is padded to
    a whole tile with no-match segments."""
    S, seg = packed.shape
    Sp = -(-S // BS) * BS
    x = jnp.pad(packed.astype(I32), ((0, Sp - S), (0, 0)), constant_values=1).T
    out = pl.pallas_call(
        _make_kernel(seg),
        out_shape=jax.ShapeDtypeStruct((seg, Sp), jnp.uint8),
        grid=(Sp // BS,),
        in_specs=[pl.BlockSpec((seg, BS), lambda i: (0, i))],
        out_specs=pl.BlockSpec((seg, BS), lambda i: (0, i)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="greedy_segments",
    )(x)
    return out.T[:S]


@jax.custom_batching.custom_vmap
def greedy_walk(packed: jax.Array) -> jax.Array:
    """greedy_segments for one block's (nseg, seg) segments. Under vmap the
    batch axes fold into the segment axis, so one kernel call takes the
    whole batch."""
    return greedy_segments(packed)


@greedy_walk.def_vmap
def _greedy_walk_vmap(axis_size, in_batched, packed):
    if not in_batched[0]:
        packed = jnp.broadcast_to(packed, (axis_size,) + packed.shape)
    seg = packed.shape[-1]
    out = greedy_segments(packed.reshape(-1, seg))
    return out.reshape(packed.shape), True
