"""Dictionary training (COVER-style) and dictionary compression.

Counterpart of the reference's dictionary subsystem
(reference src/cuda_zstd_dictionary.cu: `train_dictionary_gpu` :179 —
concatenate samples, `count_byte_frequencies_kernel` :32, d-mer hash counting
:48, `select_top_patterns_kernel` :82; format include/cuda_zstd_dictionary.h).

Training is vectorized numpy (sorting + sliding-window scoring — the same
primitives the GPU kernels use, without a device round-trip for what is an
offline operation). Produced dictionaries are RAW-CONTENT dictionaries:
decodable by stock libzstd via ZSTD_DCtx_loadDictionary / zstandard's
DICT_TYPE_RAWCONTENT — content-only, every byte usable as match source.
`write_structured_dictionary` wraps the same content in the magic-0xEC30A437
envelope (reference dictionary.h:28,56-65) for tools that require an ID.

Compression with a dictionary preloads its tail into the LZ77 window
(reference manager.cu:1699-1775) — see ops/pipeline.py compress_blocks_dict.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .constants import DICT_MAGIC

DICT_SIZE_MIN = 256
DICT_SIZE_MAX = 128 * 1024


@dataclass
class CoverParams:
    """Training knobs (reference dictionary.h:36-50)."""

    d: int = 8           # d-mer length scored during selection
    segment: int = 256   # candidate segment length (k in COVER terms)
    max_samples_bytes: int = 4 << 20
    level: int = 3


@dataclass
class Dictionary:
    """Trained dictionary: raw content + optional ID."""

    content: bytes
    dict_id: int = 0

    def __len__(self) -> int:
        return len(self.content)

    def as_zstandard(self):
        """zstandard handle for decoding frames made with this dictionary."""
        import zstandard

        return zstandard.ZstdCompressionDict(
            self.content, dict_type=zstandard.DICT_TYPE_RAWCONTENT
        )


def _dmer_counts(data: np.ndarray, d: int) -> np.ndarray:
    """count[i] = frequency of the d-mer starting at i (0 past the end)."""
    n = len(data)
    if n < d:
        return np.zeros(n, dtype=np.int64)
    # 8-byte d-mers as u64 keys (d <= 8).
    key = np.zeros(n - d + 1, dtype=np.uint64)
    for k in range(d):
        key |= data[k : n - d + 1 + k].astype(np.uint64) << np.uint64(8 * k)
    order = np.argsort(key, kind="stable")
    sk = key[order]
    # run-length counts over the sorted keys
    boundary = np.empty(len(sk), dtype=bool)
    boundary[0] = True
    boundary[1:] = sk[1:] != sk[:-1]
    run_id = np.cumsum(boundary) - 1
    run_sizes = np.bincount(run_id)
    counts_sorted = run_sizes[run_id]
    counts = np.zeros(n, dtype=np.int64)
    counts[order] = counts_sorted
    return counts


def train_dictionary(
    samples: list[bytes],
    dict_size: int = 16384,
    params: CoverParams | None = None,
) -> Dictionary:
    """COVER-style selection of high-coverage segments from the samples."""
    params = params or CoverParams()
    dict_size = max(DICT_SIZE_MIN, min(DICT_SIZE_MAX, dict_size))
    if not samples:
        raise ValueError("no samples")
    blob = b"\x00".join(samples)  # separator avoids cross-sample d-mers
    blob = blob[: params.max_samples_bytes]
    data = np.frombuffer(blob, dtype=np.uint8)
    n = len(data)
    seg = min(params.segment, max(64, dict_size // 4))
    if n < seg:
        return Dictionary(blob[:dict_size], _dict_id(blob[:dict_size]))

    counts = _dmer_counts(data, params.d)
    # A d-mer that appears once covers nothing; score repeats only.
    score1 = np.where(counts > 1, counts, 0).astype(np.float64)
    # Sliding-window segment scores (cumsum trick).
    cs = np.concatenate([[0.0], np.cumsum(score1)])
    seg_scores = cs[seg:] - cs[:-seg]  # score of segment starting at i

    # Greedy top-segment selection with overlap suppression.
    order = np.argsort(-seg_scores, kind="stable")
    taken = np.zeros(n, dtype=bool)
    chosen: list[tuple[float, int]] = []
    total = 0
    for start in order:
        if total >= dict_size:
            break
        if seg_scores[start] <= 0:
            break
        if taken[start : start + seg].any():
            continue
        taken[start : start + seg] = True
        chosen.append((float(seg_scores[start]), int(start)))
        total += seg
    if not chosen:
        content = blob[:dict_size]
        return Dictionary(content, _dict_id(content))
    # Most valuable segments go LAST (closest to the window edge => cheapest
    # offsets), mirroring zstd dictionary layout conventions.
    chosen.sort(key=lambda t: t[0])
    content = b"".join(blob[s : s + seg] for _, s in chosen)[:dict_size]
    return Dictionary(content, _dict_id(content))


def _dict_id(content: bytes) -> int:
    """Deterministic non-zero ID (reference uses a simple rolling hash,
    dictionary.h:247-252)."""
    h = 2166136261
    for b in content[:1024]:
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return (h % 0xFFFFFFFE) + 1


def write_structured_dictionary(d: Dictionary) -> bytes:
    """Magic-envelope form: magic + dict_id + content (entropy tables omitted —
    decoders fall back to predefined tables, which is what our frames use)."""
    return DICT_MAGIC.to_bytes(4, "little") + d.dict_id.to_bytes(4, "little") + d.content


def read_dictionary(data: bytes) -> Dictionary:
    if len(data) >= 8 and int.from_bytes(data[:4], "little") == DICT_MAGIC:
        return Dictionary(data[8:], int.from_bytes(data[4:8], "little"))
    return Dictionary(data, 0)


# --- Dictionary compression -----------------------------------------------------------


def compress_with_dict(
    items: list[bytes], dictionary: Dictionary, config=None
) -> list[bytes]:
    """Compress small records against a shared dictionary, one device dispatch.

    Frames are emitted WITHOUT a dictionary ID (raw-content semantics): the
    decoder must supply the same dictionary (zstandard: dict_data=...,
    DICT_TYPE_RAWCONTENT).
    """
    import jax
    import jax.numpy as jnp

    from .api.config import CompressionConfig
    from .api.manager import _bucket
    from .constants import BLOCK_RLE
    from .format.frame import write_frame_header
    from .ops.pipeline import PipelineConfig, compress_blocks_dict

    cfg = config or CompressionConfig.from_level(3)
    # Dict capacity: static pow2 bucket over the dictionary length.
    dcap = 1024
    while dcap < min(len(dictionary.content), DICT_SIZE_MAX):
        dcap *= 2
    dtail = dictionary.content[-dcap:]
    dlen = len(dtail)

    N = cfg.block_size
    pcfg = PipelineConfig(
        block_size=N, hash_log=cfg.hash_log, depth=cfg.search_depth,
        cap=cfg.compare_cap, min_match=cfg.min_match, dict_cap=dcap,
    )
    spans = []
    rows = []
    lens = []
    darr = np.frombuffer(dtail, dtype=np.uint8)
    for data in items:
        n = len(data)
        nb = max(1, -(-n // N))
        spans.append((len(rows), nb))
        arr = np.frombuffer(data, dtype=np.uint8)
        for b in range(nb):
            chunk = arr[b * N : min((b + 1) * N, n)]
            row = np.zeros(dcap + N, dtype=np.uint8)
            row[dcap - dlen : dcap] = darr
            row[dcap : dcap + len(chunk)] = chunk
            rows.append(row)
            lens.append(len(chunk))
    B = len(rows)
    Bpad = _bucket(B)
    blocks_np = np.zeros((Bpad, dcap + N), dtype=np.uint8)
    if B:
        blocks_np[:B] = np.stack(rows)
    lens_np = np.zeros(Bpad, dtype=np.int32)
    lens_np[:B] = lens
    dlens_np = np.full(Bpad, dlen, dtype=np.int32)

    contents, clens, btypes = jax.device_get(
        compress_blocks_dict(
            jnp.asarray(blocks_np), jnp.asarray(lens_np), jnp.asarray(dlens_np), pcfg
        )
    )

    outs = []
    for (first, nb), data in zip(spans, items):
        # Window must cover dictionary + content (offsets reach into the dict),
        # which also disables the single-segment shortcut.
        wlog = max(10, (dlen + max(len(data), 1) - 1).bit_length())
        parts = [write_frame_header(len(data), window_log=wlog)]
        for kk in range(nb):
            b = first + kk
            last = 1 if kk == nb - 1 else 0
            btype, clen = int(btypes[b]), int(clens[b])
            if btype == BLOCK_RLE:
                parts.append(((int(lens_np[b]) << 3) | (BLOCK_RLE << 1) | last).to_bytes(3, "little"))
                parts.append(contents[b, :1].tobytes())
            else:
                parts.append(((clen << 3) | (btype << 1) | last).to_bytes(3, "little"))
                parts.append(contents[b, :clen].tobytes())
        outs.append(b"".join(parts))
    return outs


def decompress_with_dict(data: bytes, dictionary: Dictionary, max_output_size: int | None = None) -> bytes:
    """Decode a dictionary frame (host path via libzstd; falls back to the
    format-layer decoder with the dictionary as window history)."""
    try:
        import zstandard

        dctx = zstandard.ZstdDecompressor(dict_data=dictionary.as_zstandard())
        from .format.frame import parse_frame_header

        if max_output_size is None:
            hdr = parse_frame_header(data)
            max_output_size = hdr.content_size or 0
        if max_output_size:
            return dctx.decompress(data, max_output_size=max_output_size)
        return dctx.decompress(data)
    except ImportError:
        from .format.frame import decompress_frame_with_window

        return decompress_frame_with_window(data, dictionary.content)
