"""Exact repeat-offset (repcode) assignment: a Pallas kernel (Triton route).

RFC 8878 offset-base values may name one of three rolling repeat offsets
instead of spelling the offset (format/sequences.py encode_offset is the
host-side rule; the reference resolves them at sequence.cu:209
`compute_sequence_details_kernel` with init {1,4,8}). Emitting repcodes costs
1-2 offset bits instead of ~log2(offset), but the history is a sequential
3-entry move-to-front state — one step per sequence.

Blocks are compressed independently while repcode history persists across
blocks in a frame (RFC §3.1.1.5), so the initial history is UNKNOWN: each
entry carries a known-flag and matches are only taken against entries whose
value was established inside the block. The decoder's history VALUES evolve
identically either way, so emitted frames stay stock-libzstd-decodable.

Input per sequence row, packed i32:  off | has_lit << 21 | valid << 22
(invalid rows are no-ops; in the pipeline the valid rows form a prefix).
Output: offset-base value (1..3 or off + 3), 0 on invalid rows.

`rep_codes_scan` is the plain reference (and the CPU path). The kernel walks
the same steps with one program per tile of BS blocks: the sequence lists
are laid out (rows, blocks) so each step loads BS contiguous words, the six
state words stay in registers, and the loop stops after the tile's last
valid row.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import platform

I32 = jnp.int32

M21 = (1 << 21) - 1
BS = 32      # blocks per program (one warp, one block per thread)
UNROLL = 8   # rows per loop trip: their loads do not depend on the state


def _rep_step(x, state):
    """One encode_offset step on (…,) i32 vectors. state = (v0,v1,v2,k0,k1,k2)
    with k* in {0,1}. Returns (ob, new_state)."""
    v0, v1, v2, k0, k1, k2 = state
    off = x & M21
    has_ll = (x >> 21) & 1
    valid = (x >> 22) & 1

    h0 = (k0 == 1) & (off == v0)
    h1 = (k1 == 1) & (off == v1)
    h2 = (k2 == 1) & (off == v2)
    hm1 = (k0 == 1) & (off == v0 - 1) & (off != 0)  # ll==0 repcode 3

    ll = has_ll == 1
    # Priority chains per the host rule (format/sequences.py:87-103).
    ob_ll = jnp.where(h0, 1, jnp.where(h1, 2, jnp.where(h2, 3, off + 3)))
    ob_nl = jnp.where(h1, 1, jnp.where(h2, 2, jnp.where(hm1, 3, off + 3)))
    ob = jnp.where(ll, ob_ll, ob_nl)

    # History update by case, in the host rule's priority order:
    #   unchanged            : ll>0 naming entry 0
    #   swap01  [v1, v0, v2] : entry-1 hit (either ll case)
    #   rot2    [v2, v0, v1] : entry-2 hit (either ll case)
    #   push    [off, v0, v1]: new offset, and the ll==0 off==v0-1 repcode
    unchanged = ll & h0
    swap = (ll & ~h0 & h1) | (~ll & h1)
    rot = (ll & ~h0 & ~h1 & h2) | (~ll & ~h1 & h2)
    n0 = jnp.where(unchanged, v0, jnp.where(swap, v1, jnp.where(rot, v2, off)))
    nk0 = jnp.where(unchanged, k0, jnp.where(swap, k1, jnp.where(rot, k2, 1)))
    n1 = jnp.where(unchanged, v1, v0)
    nk1 = jnp.where(unchanged, k1, k0)
    n2 = jnp.where(unchanged | swap, v2, v1)
    nk2 = jnp.where(unchanged | swap, k2, k1)

    live = valid == 1
    ob = jnp.where(live, ob, 0)
    new_state = tuple(
        jnp.where(live, n, o)
        for n, o in zip((n0, n1, n2, nk0, nk1, nk2), state)
    )
    return ob, new_state


def rep_codes_scan(packed: jax.Array) -> jax.Array:
    """lax.scan reference implementation: packed (rows,) -> ob (rows,)."""
    z = jnp.zeros((), I32)

    def step(state, x):
        ob, new_state = _rep_step(x, state)
        return new_state, ob

    _, obs = jax.lax.scan(step, (z, z, z, z, z, z), packed)
    return obs


def _kernel(n_ref, x_ref, o_ref):
    trips = (jnp.max(n_ref[...]) + UNROLL - 1) // UNROLL
    z = jnp.zeros((BS,), I32)

    def body(t, state):
        for u in range(UNROLL):
            r = t * UNROLL + u
            ob, state = _rep_step(x_ref[r, :], state)
            o_ref[r, :] = ob
        return state

    jax.lax.fori_loop(0, trips, body, (z,) * 6)


@functools.partial(jax.jit, static_argnames=("interpret",))
def rep_codes_blocks(packed: jax.Array, *, interpret: bool = False) -> jax.Array:
    """Kernel path: (S, rows) per-block packed lists -> (S, rows) ob.

    S and rows need not be multiples of the tile: padding rows and blocks
    carry valid=0 and are cut off again. Rows the kernel never reaches (past
    a block's last valid row) are masked to 0 here."""
    S, rows = packed.shape
    Sp = -(-S // BS) * BS
    Rp = -(-rows // UNROLL) * UNROLL
    x = jnp.pad(packed.astype(I32), ((0, Sp - S), (0, Rp - rows))).T  # (Rp, Sp)
    row = jnp.arange(Rp, dtype=I32)[:, None]
    nseq = jnp.max(jnp.where(((x >> 22) & 1) == 1, row + 1, 0), axis=0)  # last valid + 1
    out = pl.pallas_call(
        _kernel,
        out_shape=jax.ShapeDtypeStruct((Rp, Sp), I32),
        grid=(Sp // BS,),
        in_specs=[
            pl.BlockSpec((BS,), lambda i: (i,)),
            pl.BlockSpec((Rp, BS), lambda i: (0, i)),
        ],
        out_specs=pl.BlockSpec((Rp, BS), lambda i: (0, i)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="rep_codes",
    )(nseq, x)
    out = jnp.where(row < nseq[None, :], out, 0)
    return out.T[:S, :rows]


@jax.custom_batching.custom_vmap
def _rep_codes_kernel(packed: jax.Array) -> jax.Array:
    return rep_codes_blocks(packed[None])[0]


@_rep_codes_kernel.def_vmap
def _rep_codes_vmap(axis_size, in_batched, packed):
    if not in_batched[0]:
        packed = jnp.broadcast_to(packed, (axis_size,) + packed.shape)
    lead = packed.shape[:-1]
    out = rep_codes_blocks(packed.reshape(-1, packed.shape[-1]))
    return out.reshape(lead + packed.shape[-1:]), True


def rep_codes(packed: jax.Array) -> jax.Array:
    """Offset-base values for one block's packed list (rows,). Under vmap
    the kernel takes the whole batch in one call."""
    if platform.use_gpu_kernels():
        return _rep_codes_kernel(packed)
    return rep_codes_scan(packed)
