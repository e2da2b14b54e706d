"""End-to-end device block compression pipeline + host frame assembly.

Counterpart of the reference's DefaultZstdManager::compress GPU path
(reference src/cuda_zstd_manager.cu:1536-3192): Phase-1 LZ77 + greedy parse,
Phase-2 literals/sequence encoding and block emission. This design replaces
the multi-stream per-block loop with one jitted, vmapped function over a
(blocks, block_size) batch; Raw/RLE/Compressed block selection happens inside
the kernel with a gather-based assembly (no BlockBufferWriter staging).

Host-side code here only splits/pads input and concatenates the final frame
bytes (numpy slicing; the heavy work is on device).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import BLOCK_COMPRESSED, BLOCK_RAW, BLOCK_RLE, BLOCK_SIZE_MAX
from ..format.frame import write_frame_header
from ..format.xxhash import content_checksum
from .fse_jax import encode_sequences_predefined
from .lz77_jax import parse_block

I32 = jnp.int32
U32 = jnp.uint32


@dataclass(frozen=True)
class PipelineConfig:
    """Static compile-time pipeline parameters (one jit cache entry each)."""

    block_size: int = BLOCK_SIZE_MAX
    hash_log: int = 17
    depth: int = 8
    # Carried sort words = cap/4: every word is one more sort operand.
    cap: int = 8
    min_match: int = 4
    lazy: bool = True  # 1-step lazy parse (Strategy.LAZY and up)
    optimal: bool = False  # BTOPT-style segment DP (Strategy.BTOPT and up)
    dict_cap: int = 0  # dictionary-window prefix capacity (0 = no dictionary)
    huffman_literals: bool = True  # compress literals (reference emits Raw only)
    custom_fse: bool = True  # per-block FSE sequence tables (ops/fse_tables_jax.py)
    seg_log: int = 10  # greedy-parse segment log (scan length = 2^seg_log)
    ckpt_every: int = 0  # decoder-checkpoint stride (0 = no accel metadata)
    lit_ckpt_every: int = 1024  # literal decode-checkpoint stride (coarser:
    # literals are ~10-40x more numerous than sequences)
    # Offset-cost gate (ml-4/ml-5 max offset codes; 99 = off): short matches
    # at large offsets cost more bits than the literals they replace.
    of_gate: tuple = (8, 12)
    # Window-local candidate search (0 = whole block): sorts run along a
    # 2^mf_win_log axis (about -0.8% ratio at 13). Must be 0 in dictionary
    # mode (the preloaded window prefix has to stay visible to every
    # position).
    mf_win_log: int = 13
    # Sampled whole-block long-range pass (ops/lz77_jax.find_matches_long):
    # recovers matches beyond the 2^mf_win_log candidate horizon with a sort
    # over a quarter of the rows (ratio-neutral on the mixed bench corpus,
    # wins on long-range-redundant data).
    # Default off; ratio-focused levels (>= 7) enable it. No-op when
    # mf_win_log == 0 (full reach already).
    ldm: bool = False
    # Cross-block window mode that KEEPS the cheap windowed local search:
    # the dict_cap prefix is reachable only through the LDM pass (>= 16-byte
    # verified matches) instead of forcing full-block sorts. The big-ratio
    # lever for multi-block items — libzstd's full-window advantage over
    # per-block-independent compression is mostly long matches.
    ldm_window: bool = False
    # Insertion subsampling (libzstd fast-level acceleration): every
    # 2^sample_log-th position participates in match search — sort rows
    # shrink by the same factor. FAST levels only (costs ratio).
    sample_log: int = 0
    # Decode-tuned profile (accel/inference frames): suppress matches shorter
    # than this so frames decode with FEWER, LONGER sequences (reference
    # inference API counterpart:
    # decompress_batch_preallocated, manager.h:193-273). 0 = off.
    dec_min_ml: int = 0

    @property
    def eff_mf_win_log(self) -> int:
        if self.dict_cap and not (self.ldm_window and self.ldm):
            return 0  # prefix must stay visible to every position
        return self.mf_win_log

    @property
    def max_seqs(self) -> int:
        # block_size/4 even at min_match 3: a parse needing more sequences
        # than this requires most matches to be bare 3-byte takes, which the
        # DP prices out; parse_block detects the overflow and poisons the
        # block to Raw instead (keeping the capacity at the min_match-3 bound
        # would make every shape non-pow2 — measured as an XLA:CPU compile
        # explosion on the L19 suite path).
        return self.block_size // 4

    @property
    def seq_cap(self) -> int:
        # worst case ~34 bits/sequence (17 state + <=17 offset extra) + room
        # for the section header incl. three NCount table descriptions.
        return self.seq_cap_for(self.max_seqs)

    def seq_cap_for(self, msb: int) -> int:
        """Sequence-section byte capacity for an nseq bucket of msb entries
        (same 40-bit/sequence bound as seq_cap; smaller buckets keep the
        select-based section assembly proportionally narrow). 4096-aligned."""
        return -(-((msb * 40) // 8 + 1024) // 4096) * 4096


DEFAULT_CONFIG = PipelineConfig()


def _lit_compressed_header(regen: jax.Array, comp: jax.Array, hdr_len: jax.Array) -> jax.Array:
    """Compressed_Literals_Block header bytes (RFC §3.1.1.3.1.2): LSB-first
    [type=2 (2b) | size_format (2b) | regen (rb) | comp (rb)] with
    rb = 10/14/18 for size_format 1/2/3 (always 4-stream)."""
    U = jnp.uint32
    sf = (hdr_len - 2).astype(U)        # 3->1, 4->2, 5->3
    rb = (hdr_len - 3) * 4 + 10         # 10/14/18
    regen = regen.astype(U) & ((U(1) << rb.astype(U)) - U(1))
    comp_u = comp.astype(U)
    low = U(2) | (sf << U(2)) | (regen << U(4))
    shift_c = (4 + rb).astype(U)
    bytes_out = []
    for i in range(5):
        lo_byte = (low >> U(8 * i)) & U(0xFF)
        # comp bits land at bit (4+rb): for byte i they sit at 8i - (4+rb).
        s_pos = jnp.int32(8 * i) - shift_c.astype(jnp.int32)
        right = (comp_u >> jnp.clip(s_pos, 0, 31).astype(U)) & U(0xFF)
        left = (comp_u << jnp.clip(-s_pos, 0, 31).astype(U)) & U(0xFF)
        comp_byte = jnp.where(s_pos >= 0, right, left)
        bytes_out.append((lo_byte | comp_byte).astype(jnp.uint8))
    return jnp.stack(bytes_out)


def _parse_one(block: jax.Array, n: jax.Array, cfg: PipelineConfig, dlen: jax.Array | int = 0):
    """Parse stage: block (dict_cap + N,) uint8 — [padding | dict tail |
    payload] -> BlockSequences (see ops/lz77_jax.py)."""
    DC = cfg.dict_cap
    return parse_block(
        block,
        DC + n,
        max_seqs=cfg.max_seqs,
        hash_log=cfg.hash_log,
        depth=cfg.depth,
        cap=cfg.cap,
        min_match=cfg.min_match,
        lazy=cfg.lazy,
        block_start=DC,
        win_start=DC - dlen,
        seg_log=cfg.seg_log,
        of_gate=cfg.of_gate,
        mf_win_log=cfg.eff_mf_win_log,
        optimal=cfg.optimal,
        ldm=cfg.ldm,
        sample_log=cfg.sample_log,
        dec_min_ml=cfg.dec_min_ml,
    )


def _fse_bucketed(ll, ml, ob, nseq, cfg: PipelineConfig):
    """Batch-level sequence-section encode with nseq bucketing.

    The FSE state pre-pass costs O(max_seqs x table_size) regardless of the
    actual sequence count, so the batch picks the smallest bucket covering
    max(nseq) via lax.switch — a REAL branch at batch level (inside vmap it
    would degenerate to executing every branch). This in-graph ladder is
    deliberately coarser than the staged path's _BUCKETS: every lax.switch
    branch compiles eagerly whether used or not, so the single-jit paths
    (compress_blocks / compress_blocks_dict, incl. pjit sharding) pay compile
    time per rung; the staged path compiles rungs lazily and can afford the
    finer ladder."""
    full = cfg.max_seqs
    buckets = [b for b in _BUCKETS[:2] if b < full] + [full]
    bmax = jnp.max(nseq)
    idx = jnp.int32(0)
    for b in buckets[:-1]:
        idx = idx + (bmax > b).astype(jnp.int32)

    if cfg.custom_fse:
        from .fse_jax import encode_prepared, prepare_sequences_auto

        # Table building is bucket-independent: run it once at full width so
        # the bucket switch only contains the state chains + deposit.
        prep = jax.vmap(
            lambda a, b_, c, n: prepare_sequences_auto(a, b_, c, n, full)
        )(ll, ml, ob, nseq)

        def mk(msb):
            def branch(_):
                return jax.vmap(lambda p, n: encode_prepared(p, n, msb, cfg.seq_cap))(
                    prep, nseq
                )

            return branch

    else:

        def mk(msb):
            def branch(_):
                return jax.vmap(
                    lambda x, y, z, w: encode_sequences_predefined(
                        x[:msb], y[:msb], z[:msb], w, msb, cfg.seq_cap
                    )
                )(ll, ml, ob, nseq)

            return branch

    return jax.lax.switch(idx, [mk(b) for b in buckets], None)


def _assemble_one(
    block: jax.Array,
    n: jax.Array,
    lits: jax.Array,
    nlit: jax.Array,
    nseq: jax.Array,
    seq_bytes: jax.Array,
    seq_len: jax.Array,
    cfg: PipelineConfig,
):
    """Literal section (Raw/Huffman) + block-type decision + body composition.

    Returns (content[(N,)] uint8, content_len, block_type) — the block body
    WITHOUT the 3-byte block header (the frame assembler adds it, since the
    `last` flag is frame-level).
    """
    N = cfg.block_size
    DC = cfg.dict_cap

    # Raw literals section header (RFC 8878 §3.1.1.3.1.1).
    lit_hdr_len = jnp.where(nlit < 32, 1, jnp.where(nlit < 4096, 2, 3))
    v2 = (nlit << 4) | (1 << 2)
    v3 = (nlit << 4) | (3 << 2)
    lh = jnp.stack(
        [
            jnp.where(nlit < 32, nlit << 3, jnp.where(nlit < 4096, v2 & 0xFF, v3 & 0xFF)),
            jnp.where(nlit < 4096, (v2 >> 8) & 0xFF, (v3 >> 8) & 0xFF),
            (v3 >> 16) & 0xFF,
        ]
    ).astype(jnp.uint8)

    from .bitpack import place

    # Raw literals section: header (1-3 bytes) then literals, composed with
    # select-based placement (no scatters under vmap).
    zero = jnp.zeros((), I32)
    litcap = N + 4096
    litsec_raw = place(lh, lit_hdr_len, zero, litcap, 1) + place(
        lits[:N], nlit, lit_hdr_len, litcap, 4
    )
    raw_total = lit_hdr_len + nlit

    lit_ck = None
    if cfg.huffman_literals:
        from .huffman_jax import compress_literals_huffman, huff_payload_cap

        hcap = huff_payload_cap(N)
        if cfg.ckpt_every:
            hpay, hlen, h_ok, lit_ck = compress_literals_huffman(
                lits[:N], nlit, hcap, cfg.lit_ckpt_every
            )
        else:
            hpay, hlen, h_ok = compress_literals_huffman(lits[:N], nlit, hcap)
        h_hdr_len = jnp.where(
            (nlit < 1024) & (hlen < 1024), 3,
            jnp.where((nlit < 16384) & (hlen < 16384), 4, 5),
        )
        hh = _lit_compressed_header(nlit, hlen, h_hdr_len)
        huff_total = h_hdr_len + hlen
        use_h = h_ok & (huff_total < raw_total)
        litcap = max(N + 4096, hcap + 4096)
        litsec_h = place(hh, h_hdr_len, zero, litcap, 1) + place(
            hpay, hlen, h_hdr_len, litcap, 8
        )
        litsec_r = place(litsec_raw, raw_total, zero, litcap, 1)
        litsec = jnp.where(use_h, litsec_h, litsec_r)
        lit_sec_len = jnp.where(use_h, huff_total, raw_total)
    else:
        litsec = litsec_raw
        lit_sec_len = raw_total

    body_len = lit_sec_len + seq_len

    # Block type decision. RLE: whole block is one repeated byte.
    payload = jax.lax.dynamic_slice_in_dim(block, DC, N)  # static start
    pos = jnp.arange(N, dtype=I32)
    all_same = jnp.sum(((payload != payload[0]) & (pos < n)).astype(I32)) == 0
    is_rle = all_same & (n >= 2)
    is_comp = ~is_rle & (body_len < n) & (nseq > 0)
    btype = jnp.where(is_rle, BLOCK_RLE, jnp.where(is_comp, BLOCK_COMPRESSED, BLOCK_RAW))
    content_len = jnp.where(is_rle, 1, jnp.where(is_comp, body_len, n))

    # Body: literal section at 0 + sequence section rolled to lit_sec_len. The
    # compressed body is only used when body_len < n <= N, so composing into
    # an N-byte buffer is safe.
    body = place(litsec, lit_sec_len, zero, N, 1) + place(
        seq_bytes, seq_len, lit_sec_len, N, N
    )

    content = jnp.where(
        is_rle,
        jnp.broadcast_to(payload[0], (N,)).astype(jnp.uint8),
        jnp.where(is_comp, body, payload.astype(jnp.uint8)),
    )
    if cfg.ckpt_every and cfg.huffman_literals:
        # Literal decode checkpoints are live only when the emitted block
        # really is Compressed with Huffman literals.
        lit_used = is_comp & use_h
        return content, content_len, btype, lit_ck, lit_used
    return content, content_len, btype


@functools.partial(jax.jit, static_argnums=(3,))
def compress_blocks_dict(
    blocks: jax.Array, lengths: jax.Array, dlens: jax.Array, cfg: PipelineConfig
):
    """Dictionary-window batched compression.

    blocks: (B, dict_cap + N) uint8 laid out [padding | dict tail | payload];
    lengths: payload lengths; dlens: dictionary bytes present per block.
    """
    seqs = jax.vmap(lambda b, l, d: _parse_one(b, l, cfg, d))(blocks, lengths, dlens)
    seq_bytes, seq_len = _fse_bucketed(seqs.ll, seqs.ml, seqs.ob, seqs.nseq, cfg)
    return jax.vmap(
        lambda b, l, li, nl, ns, sb, sl: _assemble_one(b, l, li, nl, ns, sb, sl, cfg)
    )(blocks, lengths, seqs.lits, seqs.nlit, seqs.nseq, seq_bytes, seq_len)


@functools.partial(jax.jit, static_argnums=(2,))
def compress_blocks(blocks: jax.Array, lengths: jax.Array, cfg: PipelineConfig):
    """Batched block compression: (B, N) uint8 + (B,) lengths -> per-block bodies.

    Returns (contents (B, N) uint8, content_lens (B,), block_types (B,)).
    """
    seqs = jax.vmap(lambda b, l: _parse_one(b, l, cfg))(blocks, lengths)
    seq_bytes, seq_len = _fse_bucketed(seqs.ll, seqs.ml, seqs.ob, seqs.nseq, cfg)
    return jax.vmap(
        lambda b, l, li, nl, ns, sb, sl: _assemble_one(b, l, li, nl, ns, sb, sl, cfg)
    )(blocks, lengths, seqs.lits, seqs.nlit, seqs.nseq, seq_bytes, seq_len)


# --- Two-dispatch staged pipeline ----------------------------------------------------
#
# The single-jit compress_blocks keeps the whole pipeline (parse, per-bucket
# sequence encode via lax.switch, assemble) in one graph — needed for the
# sharded/pjit path, but every nseq bucket compiles whether used or not and
# the graph is large. The staged variant dispatches parse+table-prep first,
# fetches ONE scalar (max nseq) to pick the bucket on the host, then runs a
# bucket-specific encode+assemble executable (compiled lazily per bucket).


@functools.partial(jax.jit, static_argnums=(2,))
def _parse_prep_stage(blocks: jax.Array, lengths: jax.Array, cfg: PipelineConfig):
    """Parse-only first dispatch. (FSE table prep runs inside _encode_stage at
    the bucket width — ~37% less prep work when max(nseq) lands in a small
    bucket.)"""
    seqs = jax.vmap(lambda b, l: _parse_one(b, l, cfg))(blocks, lengths)
    return seqs, seqs.nseq


@functools.partial(jax.jit, static_argnums=(3, 4))
def _encode_stage(blocks, lengths, seqs, cfg: PipelineConfig, msb: int):
    cap = cfg.seq_cap_for(msb)
    ck = (None, None)
    if cfg.custom_fse:
        from .fse_jax import encode_prepared, prepare_sequences_auto

        prep = jax.vmap(
            lambda a, b, c, n, o: prepare_sequences_auto(
                a[:msb], b[:msb], c[:msb], n, msb, o[:msb] if cfg.ckpt_every else None
            )
        )(seqs.ll, seqs.ml, seqs.ob, seqs.nseq, seqs.off)
        enc = jax.vmap(lambda p, n: encode_prepared(p, n, msb, cap, cfg.ckpt_every))(
            prep, seqs.nseq
        )
        if cfg.ckpt_every:
            seq_bytes, seq_len, ck_bits, ck_states, ck_r0 = enc
            ck = (ck_bits, ck_states, ck_r0)
        else:
            seq_bytes, seq_len = enc
    else:
        seq_bytes, seq_len = jax.vmap(
            lambda x, y, z, w: encode_sequences_predefined(
                x[:msb], y[:msb], z[:msb], w, msb, cap
            )
        )(seqs.ll, seqs.ml, seqs.ob, seqs.nseq)
    out = jax.vmap(
        lambda b, l, li, nl, ns, sb, sl: _assemble_one(b, l, li, nl, ns, sb, sl, cfg)
    )(blocks, lengths, seqs.lits, seqs.nlit, seqs.nseq, seq_bytes, seq_len)
    if cfg.ckpt_every:
        # (content, clens, btypes, ck_bits, ck_states, ck_rep, nseq[,
        #  lit_ck, lit_used, nlit])
        lit_extra = out[3:] + (seqs.nlit,) if cfg.huffman_literals else ()
        return out[:3] + ck + (seqs.nseq,) + lit_extra
    return out


# Staged-path bucket ladder (finer than the in-graph lax.switch ladder: each
# bucket compiles lazily on first use, so granularity costs nothing up front).
# All entries are multiples of the state-chain CHUNK (64). The state chains +
# deposit work is ~linear in the bucket size.
_BUCKETS = (2048, 4096, 8192, 12288, 16384, 20480, 21760, 24576, 28672)


def _pick_bucket(bmax: int, full: int) -> int:
    return next((b for b in _BUCKETS if b < full and bmax <= b), full)


def _encode_grouped(blocks, lengths, seqs, nseq_host, cfg: PipelineConfig):
    """Single-bucket encode at the smallest bucket covering max(nseq)."""
    msb = _pick_bucket(int(nseq_host.max()), cfg.max_seqs)
    return _encode_stage(blocks, lengths, seqs, cfg, msb)


def compress_blocks_staged(blocks: jax.Array, lengths: jax.Array, cfg: PipelineConfig):
    """Host-staged batched block compression (same results as compress_blocks)."""
    seqs, nseq_dev = _parse_prep_stage(blocks, lengths, cfg)
    nseq_host = np.asarray(jax.device_get(nseq_dev))
    return _encode_grouped(blocks, lengths, seqs, nseq_host, cfg)


def compress_blocks_staged_many(batches, cfg: PipelineConfig):
    """Pipelined staged compression over an iterable of (blocks, lengths).

    Keeps one batch's parse in flight while the previous batch's nseq vector
    crosses the host link, hiding the per-batch round-trip + dispatch gaps
    (the reference overlaps batches with its 3-slot ring + triple streams,
    reference src/pipeline_manager.hpp:12-70; here JAX async dispatch plays
    the streams' role and only the nseq fetch synchronizes).
    Returns a list of (contents, content_lens, block_types) device tuples.
    """
    results = []
    pending = []
    for jb, jl in batches:
        seqs, nseq_dev = _parse_prep_stage(jb, jl, cfg)
        # Start the nseq device->host copy NOW: by the time this batch is
        # drained (one batch later) the transfer has landed, so the bucket
        # decision never blocks on the link round-trip.
        nseq_dev.copy_to_host_async()
        pending.append((jb, jl, (seqs, nseq_dev)))
        if len(pending) >= 2:
            results.append(_drain_one(pending, cfg))
    while pending:
        results.append(_drain_one(pending, cfg))
    return results


def _drain_one(pending, cfg: PipelineConfig):
    jb, jl, (seqs, nseq_dev) = pending.pop(0)
    nseq_host = np.asarray(jax.device_get(nseq_dev))
    return _encode_grouped(jb, jl, seqs, nseq_host, cfg)


# --- Host-side framing ---------------------------------------------------------------


def _split_blocks(data: bytes, block_size: int) -> tuple[np.ndarray, np.ndarray]:
    n = len(data)
    nblocks = max(1, -(-n // block_size))
    blocks = np.zeros((nblocks, block_size), dtype=np.uint8)
    lengths = np.zeros(nblocks, dtype=np.int32)
    arr = np.frombuffer(data, dtype=np.uint8)
    for b in range(nblocks):
        chunk = arr[b * block_size : min((b + 1) * block_size, n)]
        blocks[b, : len(chunk)] = chunk
        lengths[b] = len(chunk)
    return blocks, lengths


def compress(
    data: bytes,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    checksum: bool = False,
) -> bytes:
    """Single-shot device compression of one buffer into one zstd frame."""
    if len(data) == 0:
        hdr = write_frame_header(0, checksum=checksum)
        out = hdr + (1).to_bytes(3, "little")  # empty raw last block
        if checksum:
            out += content_checksum(b"").to_bytes(4, "little")
        return out
    blocks, lengths = _split_blocks(data, cfg.block_size)
    contents, clens, btypes = jax.device_get(
        compress_blocks_staged(jnp.asarray(blocks), jnp.asarray(lengths), cfg)
    )
    parts = [write_frame_header(len(data), checksum=checksum)]
    nblocks = len(lengths)
    for b in range(nblocks):
        last = 1 if b == nblocks - 1 else 0
        btype = int(btypes[b])
        clen = int(clens[b])
        if btype == BLOCK_RLE:
            hdr = (int(lengths[b]) << 3) | (BLOCK_RLE << 1) | last
            parts.append(hdr.to_bytes(3, "little"))
            parts.append(contents[b, :1].tobytes())
        else:
            hdr = (clen << 3) | (btype << 1) | last
            parts.append(hdr.to_bytes(3, "little"))
            parts.append(contents[b, :clen].tobytes())
    if checksum:
        parts.append(content_checksum(data).to_bytes(4, "little"))
    return b"".join(parts)
