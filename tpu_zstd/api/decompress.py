"""Batched device decompression driver: host framing -> device decode.

Counterpart of the reference's decompress stack driver
(reference src/cuda_zstd_manager.cu:3194-3780: frame parse, per-block loop
with Raw/RLE/Compressed handling, literals :4981, sequences :5106 with
Predefined/RLE/FSE/Repeat table modes and prev-table persistence
:5227-5265). Section headers and entropy TABLES are parsed/built on the host
(they are tiny); the bulk bit-serial sequence decode, 4-stream Huffman
literal decode (chunk-parallel from encoder-published cursors — the
counterpart of the reference's GPU decoder, huffman.cu:1676/2204), and the
full sequence execution run on device (ops/decode_jax.py). Frames without
decode-acceleration metadata fall back to host literal decode.

Blocks at the same index across frames decode as one device batch; the
decoded window and repcode state carry to the next block index (RFC 8878
§3.1.1.5), so multi-block frames and cross-block matches are supported.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (
    BLOCK_COMPRESSED,
    BLOCK_RAW,
    BLOCK_RLE,
    REPCODE_INIT,
    SKIPPABLE_MAGIC_MAX,
    SKIPPABLE_MAGIC_MIN,
)
from ..format.frame import decode_literals_section, parse_frame_header
from ..format.sequences import SeqDecodeTables, read_nbseq, read_sequence_table
from ..format.xxhash import content_checksum
from ..constants import (
    LL_DEFAULT_LOG,
    LL_DEFAULT_NORM,
    ML_DEFAULT_LOG,
    ML_DEFAULT_NORM,
    OF_DEFAULT_LOG,
    OF_DEFAULT_NORM,
)

MAX_SEQS_DEC = 44032  # ceil(128K / 3) chunk-aligned
TSIZE_MAX = 512


@functools.partial(jax.jit, static_argnums=(3,))
def _carry_window(win_prev, out, olen, Wn: int):
    """Device-side history carry: right-aligned last Wn bytes of
    concat(win_prev, out[:, :olen]) per row — no host round-trip between
    block rounds."""
    _, Wp = win_prev.shape
    M = out.shape[1]
    idx = jnp.arange(Wn, dtype=jnp.int32)[None, :] - Wn + olen[:, None]
    out_g = jnp.take_along_axis(out, jnp.clip(idx, 0, M - 1), axis=1)
    win_g = jnp.take_along_axis(win_prev, jnp.clip(idx + Wp, 0, Wp - 1), axis=1)
    return jnp.where(idx >= 0, out_g, win_g)


class _BlockPlan:
    """Host-parsed decode plan for one Compressed block."""

    __slots__ = ("lits", "nlit", "stream", "total_bits", "tables", "nbseq", "litdev")

    def __init__(self, lits, nlit, stream, total_bits, tables, nbseq, litdev=None):
        self.lits = lits
        self.nlit = nlit
        self.stream = stream
        self.total_bits = total_bits
        self.tables = tables  # (sym, nb, ns, logs) numpy or None when nbseq==0
        self.nbseq = nbseq
        # Device-literal info when Huffman literals decode ON DEVICE:
        # (streams[4] bytes, tbits[4], nsym[4], dtable_packed (2048,) i32,
        #  table_log, regen) — self.lits is then b"" and nlit == regen.
        self.litdev = litdev


def _parse_litdev(body: bytes) -> tuple | None:
    """Parse a 4-stream Compressed-literals section WITHOUT decoding.

    Returns (litdev tuple, consumed, regen) when the section is device-
    decodable (4-stream Huffman with its own table), else None (caller runs
    the host decode)."""
    from ..format import huffman as huf

    b0 = body[0]
    lit_type = b0 & 3
    size_format = (b0 >> 2) & 3
    if lit_type != 2 or size_format == 0:  # only Compressed_Literals, 4-stream
        return None
    if size_format == 1:
        v = int.from_bytes(body[:3], "little")
        regen, comp, pos = (v >> 4) & 0x3FF, (v >> 14) & 0x3FF, 3
    elif size_format == 2:
        v = int.from_bytes(body[:4], "little")
        regen, comp, pos = (v >> 4) & 0x3FFF, (v >> 18) & 0x3FFF, 4
    else:
        v = int.from_bytes(body[:5], "little")
        regen, comp, pos = (v >> 4) & 0x3FFFF, (v >> 22) & 0x3FFFF, 5
    payload = body[pos : pos + comp]
    weights, consumed = huf.parse_weights(payload)
    dt = huf.build_dtable(weights)
    payload = payload[consumed:]
    if len(payload) < 6:
        return None
    s1 = int.from_bytes(payload[0:2], "little")
    s2 = int.from_bytes(payload[2:4], "little")
    s3 = int.from_bytes(payload[4:6], "little")
    sbody = payload[6:]
    s4 = len(sbody) - s1 - s2 - s3
    if s4 <= 0:
        return None
    seg = (regen + 3) // 4
    nsym = [seg, seg, seg, regen - 3 * seg]
    if nsym[3] <= 0:
        return None
    offs = [0, s1, s1 + s2, s1 + s2 + s3]
    sizes = [s1, s2, s3, s4]
    streams, tbits = [], []
    for o, sz in zip(offs, sizes):
        chunk = sbody[o : o + sz]
        if not chunk or chunk[-1] == 0:
            return None
        sentinel = chunk[-1].bit_length() - 1
        streams.append(chunk)
        tbits.append((len(chunk) - 1) * 8 + sentinel)
    packed = np.zeros(2048, np.int32)
    size = 1 << dt.table_log
    packed[:size] = (dt.symbol.astype(np.int32) << 4) | dt.nb_bits.astype(np.int32)
    return (streams, tbits, nsym, packed, dt.table_log, regen), pos + comp, regen


def _dense_tables(dts) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    sym = np.zeros((3, TSIZE_MAX), np.int32)
    nb = np.zeros((3, TSIZE_MAX), np.int32)
    ns = np.zeros((3, TSIZE_MAX), np.int32)
    logs = np.zeros(3, np.int32)
    for i, dt in enumerate(dts):  # order LL, OF, ML
        size = dt.table_size
        sym[i, :size] = dt.symbol
        nb[i, :size] = dt.nb_bits
        ns[i, :size] = dt.new_state
        logs[i] = dt.table_log
    return sym, nb, ns, logs


def _parse_block_plan(
    body: bytes,
    prev_tables: SeqDecodeTables | None,
    prev_huf,
    device_literals: bool = False,
) -> tuple[_BlockPlan, SeqDecodeTables | None, object]:
    litdev = None
    if device_literals:
        parsed = _parse_litdev(body)
        if parsed is not None:
            litdev, consumed, regen = parsed

    class _L:
        pass

    if litdev is not None:
        lit = _L()
        lit.data = b""
        lit.consumed = consumed
        lit.huff_table = prev_huf
        nlit_val = litdev[5]
    else:
        lit = decode_literals_section(body, prev_huf)
        nlit_val = len(lit.data)
    rest = body[lit.consumed :]
    nbseq, pos = read_nbseq(rest)
    if nbseq == 0:
        return (
            _BlockPlan(lit.data, nlit_val, b"", 0, None, 0, litdev),
            prev_tables,
            lit.huff_table,
        )
    modes = rest[pos]
    pos += 1
    ll_mode = (modes >> 6) & 3
    of_mode = (modes >> 4) & 3
    ml_mode = (modes >> 2) & 3
    dt_ll, c = read_sequence_table(
        rest[pos:], ll_mode, prev_tables.ll if prev_tables else None,
        LL_DEFAULT_NORM, LL_DEFAULT_LOG, 35,
    )
    pos += c
    dt_of, c = read_sequence_table(
        rest[pos:], of_mode, prev_tables.of if prev_tables else None,
        OF_DEFAULT_NORM, OF_DEFAULT_LOG, 31,
    )
    pos += c
    dt_ml, c = read_sequence_table(
        rest[pos:], ml_mode, prev_tables.ml if prev_tables else None,
        ML_DEFAULT_NORM, ML_DEFAULT_LOG, 52,
    )
    pos += c
    stream = rest[pos:]
    if not stream or stream[-1] == 0:
        raise ValueError("corrupt sequence bitstream (bad sentinel)")
    sentinel = stream[-1].bit_length() - 1
    total_bits = (len(stream) - 1) * 8 + sentinel
    plan = _BlockPlan(
        lit.data, nlit_val, stream, total_bits,
        _dense_tables((dt_ll, dt_of, dt_ml)), nbseq, litdev,
    )
    return plan, SeqDecodeTables(dt_ll, dt_of, dt_ml), lit.huff_table


def decompress_batch_tpu(
    frames: list[bytes],
    max_block: int = 128 * 1024,
    window_cap: int | None = None,
    verify_checksum: bool = True,
) -> list[bytes]:
    """Decompress a batch of zstd frames with device-side block decode.

    window_cap: history visible to cross-block matches. Default (None)
    derives it from the frames' headers (Window_Descriptor / content size,
    ceiling 1 GB), so any valid frame decodes; passing a smaller cap trades
    correctness on long-window frames for memory.
    """
    from ..ops.decode_jax import (
        SeqTables,
        decode_sequences_device,
        execute_sequences_device,
    )
    from .manager import _bucket

    nf = len(frames)
    outputs: list[bytearray] = [bytearray() for _ in range(nf)]
    cursors = []
    hdrs = []
    for f in frames:
        pos = 0
        while True:
            magic = int.from_bytes(f[pos : pos + 4], "little")
            if SKIPPABLE_MAGIC_MIN <= magic <= SKIPPABLE_MAGIC_MAX:
                pos += 8 + int.from_bytes(f[pos + 4 : pos + 8], "little")
                continue
            break
        hdr = parse_frame_header(f[pos:])
        hdrs.append(hdr)
        cursors.append(pos + hdr.header_size)
    if window_cap is None:
        need = max(
            min(h.window_size or h.content_size or (1 << 30), 1 << 30) for h in hdrs
        )
        window_cap = max(4096, -(-need // 4096) * 4096)
    done = [False] * nf
    seq_tables: list[SeqDecodeTables | None] = [None] * nf
    huf_tables = [None] * nf

    # Phase 1 — parse EVERY block of every frame up front. Section parsing
    # depends only on the compressed bytes (never on decoded output: Repeat
    # FSE tables chain through the HOST-parsed table state), so the device
    # loop below runs with no host round-trip between block rounds
    # (round-3 review weak #2; reference decodes block-by-block on-GPU the
    # same way, manager.cu:3560-3640). Raw/RLE blocks become literal-only
    # rounds (nseq == 0).
    rounds: list[dict] = []
    while not all(done):
        entry: dict = {}
        for i, f in enumerate(frames):
            if done[i]:
                continue
            pos = cursors[i]
            if pos + 3 > len(f):
                raise ValueError(f"truncated frame {i}: missing block header")
            bh = int.from_bytes(f[pos : pos + 3], "little")
            pos += 3
            last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
            if pos + (1 if btype == BLOCK_RLE else bsize) > len(f):
                raise ValueError(f"truncated frame {i}: block body exceeds input")
            if btype == BLOCK_RAW:
                entry[i] = f[pos : pos + bsize]
                pos += bsize
            elif btype == BLOCK_RLE:
                entry[i] = bytes([f[pos]]) * bsize
                pos += 1
            elif btype == BLOCK_COMPRESSED:
                body = f[pos : pos + bsize]
                pos += bsize
                plan, seq_tables[i], huf_tables[i] = _parse_block_plan(
                    body, seq_tables[i], huf_tables[i]
                )
                entry[i] = plan
            else:
                raise ValueError("reserved block type")
            cursors[i] = pos
            if last:
                done[i] = True
        rounds.append(entry)

    # Phase 2 — device-resident block loop: the history window and repcode
    # state stay on device between rounds; the host uploads each round's
    # parsed sections and drains finished rounds' outputs in batches (the
    # async dispatch queue overlaps those fetches with later rounds).
    B = _bucket(nf, lo=1)
    rep_dev = jnp.tile(jnp.asarray(REPCODE_INIT, np.int32)[None], (B, 1))
    win_dev = jnp.zeros((B, 1), jnp.uint8)
    Wcur = 1
    have_ub = 0
    round_outs: list = []

    def _drain(n_keep: int):
        while len(round_outs) > n_keep:
            r0, out_d, len_d = round_outs.pop(0)
            out_h, len_h = jax.device_get((out_d, len_d))
            for i in rounds[r0]:
                outputs[i] += out_h[i, : len_h[i]].tobytes()

    for r, entry in enumerate(rounds):
        plans_r = {i: p for i, p in entry.items() if isinstance(p, _BlockPlan)}
        swidth = _bucket(
            max(max((len(p.stream) for p in plans_r.values()), default=1), 64),
            lo=64,
        )
        streams = np.zeros((B, swidth), np.uint8)
        tbits = np.zeros(B, np.int32)
        sym = np.zeros((B, 3, TSIZE_MAX), np.int32)
        nb = np.zeros((B, 3, TSIZE_MAX), np.int32)
        ns = np.zeros((B, 3, TSIZE_MAX), np.int32)
        logs = np.zeros((B, 3), np.int32)
        nseq = np.zeros(B, np.int32)
        lits = np.zeros((B, max_block), np.uint8)
        nlit = np.zeros(B, np.int32)
        any_seqs = False
        for i, p in entry.items():
            if isinstance(p, _BlockPlan):
                streams[i, : len(p.stream)] = np.frombuffer(p.stream, np.uint8)
                tbits[i] = p.total_bits
                nseq[i] = p.nbseq
                any_seqs = any_seqs or p.nbseq > 0
                lits[i, : p.nlit] = np.frombuffer(p.lits, np.uint8)
                nlit[i] = p.nlit
                if p.tables is not None:
                    sym[i], nb[i], ns[i], logs[i] = p.tables
            else:
                lits[i, : len(p)] = np.frombuffer(p, np.uint8)
                nlit[i] = len(p)

        nseq_j = jnp.asarray(nseq)
        nlit_j = jnp.asarray(nlit)
        lits_j = jnp.asarray(lits)
        if any_seqs:
            tables = SeqTables(
                jnp.asarray(sym), jnp.asarray(nb), jnp.asarray(ns), jnp.asarray(logs)
            )
            ll, ml, off, rep_fin = decode_sequences_device(
                jnp.asarray(streams), jnp.asarray(tbits), tables,
                nseq_j, rep_dev, MAX_SEQS_DEC,
            )
            # Rows without sequences pass rep through unchanged inside the
            # decoder, so the carry needs no masking.
            rep_dev = rep_fin
            out, out_len = execute_sequences_device(
                lits_j, nlit_j, ll, ml, off, nseq_j, win_dev, max_block, Wcur,
            )
        else:
            out = lits_j
            out_len = nlit_j
        round_outs.append((r, out, out_len))
        _drain(4)

        if r + 1 < len(rounds):
            have_ub = min(window_cap, have_ub + max_block)
            Wnext = _bucket(max(have_ub, 4096), lo=4096)
            win_dev = _carry_window(win_dev, out, out_len.astype(jnp.int32), Wnext)
            Wcur = Wnext
    _drain(0)

    results = []
    for i, f in enumerate(frames):
        out = bytes(outputs[i])
        hdr = hdrs[i]
        if hdr.has_checksum and verify_checksum:
            stored = int.from_bytes(f[cursors[i] : cursors[i] + 4], "little")
            if stored != content_checksum(out):
                raise ValueError(f"content checksum mismatch (frame {i})")
        if hdr.content_size is not None and len(out) != hdr.content_size:
            raise ValueError(
                f"content size mismatch (frame {i}): {len(out)} != {hdr.content_size}"
            )
        results.append(out)
    return results


class DecompressPlan:
    """Prepared inference-path decompression: host parse + uploads done ONCE.

    Counterpart of the reference's preallocated/async inference API
    (reference manager.h:193-273: `decompress_to_preallocated`,
    `decompress_batch_preallocated`, `decompress_async_no_sync` — built for
    ML weight/activation loading where the same compressed frames decode
    repeatedly into device buffers). `execute()` runs ONLY device work on
    the plan's device-resident inputs — no host parsing, no H2D transfers —
    so steady-state repeated decodes go at device speed.
    """

    def __init__(self, runners, nf, inv, checksums=None):
        self._runners = runners  # [(zero-arg device fn, group size), ...]
        self._nf = nf
        # Upload the regrouping permutation once — execute() must stay free
        # of H2D transfers (its documented steady-state contract).
        if inv is not None:
            inv = jnp.asarray(inv)
        self._inv = inv  # None when a single group covers all frames
        # Per-frame stored frame checksums (low 4 bytes of XXH64), None where
        # the frame carries none — for the opt-in execute() verification.
        self._checksums = checksums or [None] * nf

    def execute(self, verify_checksum: bool = False):
        """Device-only decode. Returns (out (B, max_block) u8, lengths (B,)).

        verify_checksum=True additionally fetches the outputs to the host and
        checks each frame's stored XXH64 content checksum (frames without one
        are skipped) — raising ValueError on mismatch. This costs a D2H
        transfer per call; leave it off in steady-state inference loops.
        """

        if self._inv is None:
            out, out_len = self._runners[0][0]()
            out, out_len = out[: self._nf], out_len[: self._nf]
        else:
            parts = []
            for run, cnt in self._runners:
                out_g, len_g = run()
                parts.append((out_g[:cnt], len_g[:cnt]))
            inv = self._inv
            out = jnp.concatenate([p[0] for p in parts], axis=0)[inv]
            out_len = jnp.concatenate([p[1] for p in parts], axis=0)[inv]
        if verify_checksum and any(c is not None for c in self._checksums):
            from ..format.xxhash import content_checksum

            out_h, len_h = jax.device_get((out, out_len))
            for i, stored in enumerate(self._checksums):
                if stored is None:
                    continue
                got = content_checksum(out_h[i, : int(len_h[i])].tobytes())
                if got != stored:
                    raise ValueError(
                        f"content checksum mismatch (frame {i}): "
                        f"stored {stored:#010x} != computed {got:#010x}"
                    )
        return out, out_len


def decompress_batch_to_device(frames: list[bytes], max_block: int = 128 * 1024):
    """One-shot inference-path decompression (prepare + execute).

    Returns (out (B, max_block) uint8 jax.Array, lengths (B,) jax.Array) —
    both device-resident; slicing/reshaping composes with downstream jitted
    consumers without a host copy. For repeated decodes of the same frames
    use `prepare_decompress_batch(...).execute()`.
    """
    return prepare_decompress_batch(frames, max_block).execute()


def _prepare_multiblock_plan(
    frames: list[bytes], max_block: int
) -> DecompressPlan:
    """Prepared plan for MULTI-BLOCK frames: every block of every frame is
    parsed and uploaded at prepare time; execute() chains the block rounds
    entirely on device (window + repcode carry, one gather-assembly into a
    contiguous (B, max_out) buffer) — the reference's preallocated batch
    decompress handles arbitrary frames the same way (manager.h:193-273).
    """

    from ..format.accel import parse_accel_tail
    from ..ops.decode_jax import (
        SeqTables,
        decode_sequences_device,
        execute_sequences_device,
    )
    from .manager import _bucket

    nf = len(frames)
    frames = [
        f[:parse_accel_tail(f)[1]] if parse_accel_tail(f)[0] is not None else f
        for f in frames
    ]
    cursors = []
    hdrs = []
    for f in frames:
        pos = 0
        while True:
            magic = int.from_bytes(f[pos : pos + 4], "little")
            if SKIPPABLE_MAGIC_MIN <= magic <= SKIPPABLE_MAGIC_MAX:
                pos += 8 + int.from_bytes(f[pos + 4 : pos + 8], "little")
                continue
            break
        hdr = parse_frame_header(f[pos:])
        hdrs.append(hdr)
        cursors.append(pos + hdr.header_size)
    # The chained-round carry window is capped at 4 MiB (device memory
    # budget). A frame whose declared window (bounded by its content size
    # when known) exceeds the cap could reference history the plan no longer
    # holds and decode to garbage — refuse it loudly instead
    # (decompress_batch_tpu handles windows up to 1 GiB).
    PLAN_WINDOW_CAP = 1 << 22
    for i, h in enumerate(hdrs):
        need = h.window_size or h.content_size or 0
        if h.content_size is not None:
            need = min(need, h.content_size)
        if need > PLAN_WINDOW_CAP:
            raise ValueError(
                f"frame {i}: window size {need} exceeds the prepared-plan cap "
                f"({PLAN_WINDOW_CAP}); use decompress_batch_tpu for long-window "
                "frames"
            )
    window_cap = max(
        4096,
        -(-min(
            max(h.window_size or h.content_size or (1 << 22) for h in hdrs),
            PLAN_WINDOW_CAP,
        ) // 4096) * 4096,
    )
    done = [False] * nf
    seq_tables: list = [None] * nf
    huf_tables = [None] * nf
    rounds: list[dict] = []
    while not all(done):
        entry: dict = {}
        for i, f in enumerate(frames):
            if done[i]:
                continue
            pos = cursors[i]
            if pos + 3 > len(f):
                raise ValueError(f"truncated frame {i}: missing block header")
            bh = int.from_bytes(f[pos : pos + 3], "little")
            pos += 3
            last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
            if pos + (1 if btype == BLOCK_RLE else bsize) > len(f):
                raise ValueError(f"truncated frame {i}: block body exceeds input")
            if btype == BLOCK_RAW:
                entry[i] = f[pos : pos + bsize]
                pos += bsize
            elif btype == BLOCK_RLE:
                entry[i] = bytes([f[pos]]) * bsize
                pos += 1
            elif btype == BLOCK_COMPRESSED:
                body = f[pos : pos + bsize]
                pos += bsize
                plan, seq_tables[i], huf_tables[i] = _parse_block_plan(
                    body, seq_tables[i], huf_tables[i]
                )
                entry[i] = plan
            else:
                raise ValueError("reserved block type")
            cursors[i] = pos
            if last:
                done[i] = True
        rounds.append(entry)

    B = _bucket(nf, lo=1)
    staged = []
    for entry in rounds:
        plans_r = [p for p in entry.values() if isinstance(p, _BlockPlan)]
        swidth = _bucket(
            max(max((len(p.stream) for p in plans_r), default=1), 64), lo=64
        )
        streams = np.zeros((B, swidth), np.uint8)
        tbits = np.zeros(B, np.int32)
        sym = np.zeros((B, 3, TSIZE_MAX), np.int32)
        nb = np.zeros((B, 3, TSIZE_MAX), np.int32)
        ns = np.zeros((B, 3, TSIZE_MAX), np.int32)
        logs = np.zeros((B, 3), np.int32)
        nseq = np.zeros(B, np.int32)
        lits = np.zeros((B, max_block), np.uint8)
        nlit = np.zeros(B, np.int32)
        any_seqs = False
        for i, p in entry.items():
            if isinstance(p, _BlockPlan):
                streams[i, : len(p.stream)] = np.frombuffer(p.stream, np.uint8)
                tbits[i] = p.total_bits
                nseq[i] = p.nbseq
                any_seqs = any_seqs or p.nbseq > 0
                lits[i, : p.nlit] = np.frombuffer(p.lits, np.uint8)
                nlit[i] = p.nlit
                if p.tables is not None:
                    sym[i], nb[i], ns[i], logs[i] = p.tables
            else:
                lits[i, : len(p)] = np.frombuffer(p, np.uint8)
                nlit[i] = len(p)
        staged.append({
            "streams": jnp.asarray(streams),
            "tbits": jnp.asarray(tbits),
            "tables": SeqTables(
                jnp.asarray(sym), jnp.asarray(nb), jnp.asarray(ns),
                jnp.asarray(logs),
            ),
            "nseq": jnp.asarray(nseq),
            "lits": jnp.asarray(lits),
            "nlit": jnp.asarray(nlit),
            "any_seqs": any_seqs,
        })

    nr = len(rounds)
    MO = _bucket(
        max(max((h.content_size or nr * max_block) for h in hdrs), 1), lo=4096
    )

    def run():
        rep = jnp.tile(jnp.asarray(REPCODE_INIT, np.int32)[None], (B, 1))
        win = jnp.zeros((B, 1), jnp.uint8)
        Wcur = 1
        have_ub = 0
        outs = []
        lens = []
        for r, st in enumerate(staged):
            if st["any_seqs"]:
                ll, ml, off, rep = decode_sequences_device(
                    st["streams"], st["tbits"], st["tables"], st["nseq"],
                    rep, MAX_SEQS_DEC,
                )
                out, out_len = execute_sequences_device(
                    st["lits"], st["nlit"], ll, ml, off, st["nseq"], win,
                    max_block, Wcur,
                )
            else:
                out, out_len = st["lits"], st["nlit"]
            outs.append(out)
            lens.append(out_len.astype(jnp.int32))
            if r + 1 < nr:
                have_ub = min(window_cap, have_ub + max_block)
                Wnext = _bucket(max(have_ub, 4096), lo=4096)
                win = _carry_window(win, out, out_len.astype(jnp.int32), Wnext)
                Wcur = Wnext
        return _assemble_rounds(
            jnp.stack(outs), jnp.stack(lens), MO
        )

    checksums = [
        int.from_bytes(frames[i][cursors[i] : cursors[i] + 4], "little")
        if hdrs[i].has_checksum and cursors[i] + 4 <= len(frames[i])
        else None
        for i in range(nf)
    ]
    return DecompressPlan([(run, nf)], nf, None, checksums)


@functools.partial(jax.jit, static_argnums=(2,))
def _assemble_rounds(outs, lens, MO: int):
    """(R, B, M) round outputs -> contiguous (B, MO) + total lengths."""
    R, B, M = outs.shape
    cum = jnp.cumsum(lens, axis=0)  # (R, B) inclusive
    start = cum - lens              # (R, B) exclusive
    j = jnp.arange(MO, dtype=jnp.int32)[None, :]
    # round of output position j: number of rounds fully before j
    rsel = jnp.sum((j[None] >= cum[:, :, None]).astype(jnp.int32), axis=0)  # (B, MO)
    rsel_c = jnp.clip(rsel, 0, R - 1)
    st = jnp.take_along_axis(start.T, rsel_c, axis=1)  # (B, MO) start of that round
    pos = jnp.clip(j - st, 0, M - 1)
    flat = outs.transpose(1, 0, 2).reshape(B, R * M)
    out = jnp.take_along_axis(flat, rsel_c * M + pos, axis=1)
    total = cum[-1]
    return jnp.where(j < total[:, None], out, 0).astype(jnp.uint8), total


def prepare_decompress_batch(
    frames: list[bytes], max_block: int = 128 * 1024
) -> DecompressPlan:
    """Parse frames, build decode tables, and upload everything to the device.

    Single-block frames decode in one device dispatch per size group; batches containing multi-block frames chain block
    rounds on device with window/repcode carry (_prepare_multiblock_plan).
    """

    from ..format.accel import parse_accel_tail
    from ..ops.decode_jax import (
        SeqTables,
        decode_sequences_device,
        decode_sequences_device_chunked,
        execute_sequences_device as execute_sequences,
    )
    from .manager import _bucket

    # Route batches containing multi-block frames to the chained-round plan.
    for f in frames:
        pos = 0
        while True:
            magic = int.from_bytes(f[pos : pos + 4], "little")
            if SKIPPABLE_MAGIC_MIN <= magic <= SKIPPABLE_MAGIC_MAX:
                pos += 8 + int.from_bytes(f[pos + 4 : pos + 8], "little")
                continue
            break
        h = parse_frame_header(f[pos:])
        bh = int.from_bytes(f[pos + h.header_size : pos + h.header_size + 3], "little")
        if not (bh & 1):
            return _prepare_multiblock_plan(frames, max_block)

    nf = len(frames)
    plans: list[_BlockPlan | None] = []
    raws: list[bytes | None] = []
    bodies: list[bytes | None] = []
    metas: list = []  # per frame: accel block record or None
    checksums: list = []  # per frame stored XXH64 low-4-bytes (or None)
    accel_stride = None
    lit_stride = None
    for f in frames:
        meta, frame_end = parse_accel_tail(f)
        rec = None
        if meta is not None and len(meta.blocks) == 1:
            f = f[:frame_end]
            rec = meta.blocks[0]
            accel_stride = meta.stride if accel_stride in (None, meta.stride) else -1
            lit_stride = (
                meta.lit_stride if lit_stride in (None, meta.lit_stride) else -1
            )
        elif meta is not None:
            f = f[:frame_end]
        hdr = parse_frame_header(f)
        pos = hdr.header_size
        bh = int.from_bytes(f[pos : pos + 3], "little")
        if not (bh & 1):
            raise ValueError("decompress_batch_to_device: multi-block frame")
        btype, bsize = (bh >> 1) & 3, bh >> 3
        if (hdr.content_size or 0) > max_block or bsize > max_block:
            raise ValueError(
                "decompress_batch_to_device: block exceeds max_block "
                f"({hdr.content_size or bsize} > {max_block})"
            )
        body = f[pos + 3 : pos + 3 + (1 if btype == BLOCK_RLE else bsize)]
        ck_pos = pos + 3 + (1 if btype == BLOCK_RLE else bsize)
        checksums.append(
            int.from_bytes(f[ck_pos : ck_pos + 4], "little")
            if hdr.has_checksum and ck_pos + 4 <= len(f)
            else None
        )
        if btype == BLOCK_RAW:
            plans.append(None)
            raws.append(body)
            bodies.append(None)
            metas.append(None)
        elif btype == BLOCK_RLE:
            plans.append(None)
            raws.append(body[:1] * bsize)
            bodies.append(None)
            metas.append(None)
        else:
            plan, _, _ = _parse_block_plan(body, None, None, device_literals=rec is not None)
            plans.append(plan)
            raws.append(None)
            bodies.append(body)
            metas.append(rec)
    # Chunk-parallel decode only when every compressed block has checkpoints
    # at one common stride.
    use_accel = (
        accel_stride is not None
        and accel_stride > 0
        and all(m is not None for p, m in zip(plans, metas) if p is not None and p.nbseq > 0)
    )
    # Device-literal eligibility: a litdev parse AND enough checkpoint
    # records for its chunk count (records cover ceil(seg/stride)-1 chunks
    # by construction; seg <= stride needs none).
    C = accel_stride if (accel_stride and accel_stride > 0) else 0
    CL = lit_stride if (lit_stride and lit_stride > 0) else 0
    litdev_set = set()
    if C and CL:
        for i, p in enumerate(plans):
            if p is None or p.litdev is None or metas[i] is None:
                continue
            seg = (p.litdev[5] + 3) // 4
            if metas[i][4].shape[1] >= max(0, -(-seg // CL) - 1):
                litdev_set.add(i)

    def _prepare_subbatch(idxs: list[int]):
        """Stage + upload one size-class group; returns a zero-arg device fn."""
        ng = len(idxs)
        B = _bucket(max(ng, 1), lo=1)
        swidth = _bucket(
            max(max((len(plans[i].stream) for i in idxs if plans[i] is not None), default=1), 64),
            lo=64,
        )
        all_dev = all(plans[i] is not None and i in litdev_set for i in idxs)
        host_lit_max = max(
            [len(raws[i]) for i in idxs if plans[i] is None]
            + [plans[i].nlit for i in idxs if plans[i] is not None and i not in litdev_set]
            + [1]
        )
        lit_w = min(_bucket(max(host_lit_max, 64), lo=64), max_block)
        streams = np.zeros((B, swidth), np.uint8)
        tbits = np.zeros(B, np.int32)
        sym = np.zeros((B, 3, TSIZE_MAX), np.int32)
        nb = np.zeros((B, 3, TSIZE_MAX), np.int32)
        ns = np.zeros((B, 3, TSIZE_MAX), np.int32)
        logs = np.zeros((B, 3), np.int32)
        nseq = np.zeros(B, np.int32)
        lits = np.zeros((B, lit_w), np.uint8)
        nlit = np.zeros(B, np.int32)
        for bi, i in enumerate(idxs):
            p = plans[i]
            if p is None:
                r = raws[i]
                lits[bi, : len(r)] = np.frombuffer(r, np.uint8)
                nlit[bi] = len(r)
                continue
            streams[bi, : len(p.stream)] = np.frombuffer(p.stream, np.uint8)
            tbits[bi] = p.total_bits
            nseq[bi] = p.nbseq
            nlit[bi] = p.nlit
            if i not in litdev_set:
                if p.litdev is not None:
                    # Parsed lazily but no usable checkpoints: host-decode now.
                    p.lits = decode_literals_section(bodies[i], None).data
                lits[bi, : p.nlit] = np.frombuffer(p.lits, np.uint8)
            if p.tables is not None:
                sym[bi], nb[bi], ns[bi], logs[bi] = p.tables

        # --- Upload everything ONCE; run() below is device-only. ---
        tables = SeqTables(
            jnp.asarray(sym), jnp.asarray(nb), jnp.asarray(ns), jnp.asarray(logs)
        )
        streams_j = jnp.asarray(streams)
        tbits_j = jnp.asarray(tbits)
        nseq_j = jnp.asarray(nseq)
        nlit_j = jnp.asarray(nlit)
        zwin = jnp.zeros((B, 1), jnp.uint8)
        if use_accel:
            max_nc = max(
                (-(-int(nseq[bi]) // C) for bi, i in enumerate(idxs) if plans[i] is not None),
                default=1,
            )
            NC = _bucket(max(max_nc, 1), lo=1)
            ckb = np.zeros((B, max(NC - 1, 1)), np.int32)
            cks = np.zeros((B, max(NC - 1, 1)), np.int32)
            ckr = np.ones((B, max(NC - 1, 1), 3), np.int32)
            for bi, i in enumerate(idxs):
                rec = metas[i]
                if rec is None:
                    continue
                bits_a, st_a, rep_a = rec[1], rec[2], rec[3]
                n = min(len(bits_a), NC - 1)
                ckb[bi, :n] = bits_a[:n].astype(np.int64).astype(np.int32)
                cks[bi, :n] = st_a[:n].astype(np.int64).astype(np.int32)
                ckr[bi, :n] = rep_a[:n].astype(np.int64).astype(np.int32)
            ckb_j, cks_j, ckr_j = jnp.asarray(ckb), jnp.asarray(cks), jnp.asarray(ckr)

            def _decode_seqs():
                return decode_sequences_device_chunked(
                    streams_j, tbits_j, tables, nseq_j,
                    ckb_j, cks_j, ckr_j, C, NC, MAX_SEQS_DEC,
                )
        else:
            rep0_j = jnp.asarray(np.tile(np.asarray(REPCODE_INIT, np.int32), (B, 1)))

            def _decode_seqs():
                return decode_sequences_device(
                    streams_j, tbits_j, tables, nseq_j, rep0_j, MAX_SEQS_DEC,
                )

        group_litdev = [i for i in idxs if i in litdev_set]
        _decode_lits = None
        regen_j = None
        if group_litdev:
            from ..ops.decode_jax import (
                assemble_literals_4stream,
                decode_huffman_device,
            )

            R0 = B * 4
            lsw = _bucket(
                max(max(len(s) for i in group_litdev for s in plans[i].litdev[0]), 64),
                lo=64,
            )
            max_sym = max(max(plans[i].litdev[2]) for i in group_litdev)
            NCL = _bucket(max(-(-max_sym // CL), 1), lo=1)
            lstreams = np.zeros((R0, lsw), np.uint8)
            ltbits = np.zeros(R0, np.int32)
            lnsym = np.zeros(R0, np.int32)
            dtab = np.zeros((B, 2048), np.uint16)
            tlog = np.zeros(B, np.int32)
            lck = np.zeros((R0, max(NCL - 1, 1)), np.int32)
            regen = np.zeros(B, np.int32)
            dev_mask = np.zeros(B, bool)
            for bi, i in enumerate(idxs):
                if i not in litdev_set:
                    continue
                sts, tb, nsy, packed, tl_b, rg = plans[i].litdev
                dev_mask[bi] = True
                dtab[bi] = packed.astype(np.uint16)
                tlog[bi] = tl_b
                regen[bi] = rg
                lc = metas[i][4]
                for s in range(4):
                    r = bi * 4 + s
                    lstreams[r, : len(sts[s])] = np.frombuffer(sts[s], np.uint8)
                    ltbits[r] = tb[s]
                    lnsym[r] = nsy[s]
                    n = min(lc.shape[1], NCL - 1)
                    if n:
                        lck[r, :n] = lc[s, :n].astype(np.int64).astype(np.int32)
            lstreams_j = jnp.asarray(lstreams)
            ltbits_j = jnp.asarray(ltbits)
            dtab_j = jnp.asarray(dtab).astype(jnp.int32)
            tlog_j = jnp.asarray(tlog)
            lnsym_j = jnp.asarray(lnsym)
            lck_j = jnp.asarray(lck)
            regen_j = jnp.asarray(regen)
            dev_mask_j = jnp.asarray(dev_mask)

            def _decode_lits():
                return decode_huffman_device(
                    lstreams_j, ltbits_j, dtab_j, tlog_j, lnsym_j, CL, NCL, lck_j,
                )

        if all_dev and _decode_lits is not None:
            # Whole group decodes literals on device: the executor reads the
            # 4-stream symbol rows directly (no assembled literal buffer, one
            # fewer full-output gather).
            zlit = jnp.zeros((B, 1), jnp.uint8)

            def run():
                ll, ml, off, _ = _decode_seqs()
                syms = _decode_lits()
                return execute_sequences(
                    zlit, nlit_j, ll, ml, off, nseq_j, zwin, max_block, 1,
                    lit_src=(syms, regen_j),
                )

            return run
        lits_j = jnp.asarray(lits)
        if lit_w < max_block:
            lits_j = jnp.pad(lits_j, ((0, 0), (0, max_block - lit_w)))

        def run():
            ll, ml, off, _ = _decode_seqs()
            lits_b = lits_j
            if _decode_lits is not None:
                syms = _decode_lits()
                lits_dev = assemble_literals_4stream(syms, regen_j, max_block)
                lits_b = jnp.where(dev_mask_j[:, None], lits_dev, lits_j)
            return execute_sequences(
                lits_b, nlit_j, ll, ml, off, nseq_j, zwin, max_block, 1,
            )

        return run

    # Group frames by decode size class (chunk-count buckets): blocks with
    # few sequences/literals stop padding to the batch max — at stride 64 a
    # 2K-seq block in a batch with a 32K-seq block otherwise runs 16x the
    # scan rows it needs. Raw/RLE and host-literal frames form their own
    # group so all-device groups take the fused executor path.
    groups: dict = {}
    for i in range(nf):
        p = plans[i]
        if p is None:
            key = ("host", 0, 0)
        else:
            nc = _bucket(max(-(-p.nbseq // C), 1), lo=1) if (use_accel and C) else 0
            if i in litdev_set:
                seg = (p.litdev[5] + 3) // 4
                key = ("dev", nc, _bucket(max(-(-seg // CL), 1), lo=1))
            else:
                key = ("host", nc, 0)
        groups.setdefault(key, []).append(i)

    if len(groups) <= 1:
        return DecompressPlan(
            [(_prepare_subbatch(list(range(nf))), nf)], nf, None, checksums
        )
    runners = []
    order = []
    for key in sorted(groups):
        idxs = groups[key]
        runners.append((_prepare_subbatch(idxs), len(idxs)))
        order.extend(idxs)
    inv = np.empty(nf, np.int32)
    inv[np.asarray(order)] = np.arange(nf, dtype=np.int32)
    return DecompressPlan(runners, nf, inv, checksums)
