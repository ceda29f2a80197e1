"""Host-side staging: FIPS-180 padding, big-endian word packing, bucketing.

The port's copy of ``vk_merkle_roots_tpu/packing.py``, with the same wire
format, buckets and orders.  It replaces the reference's ``Batch`` staging
buffers (``Batches.cpp:64-121`` packs raw strings word-aligned with
``{start,size}`` metadata and leaves padding to the shader,
SHA-256.comp:207-285).  The device kernels stay perfectly regular instead: the host pre-pads every leaf to whole 64-byte message blocks
(0x80 bit, zero fill, 64-bit big-endian bit length), converts to big-endian
u32 words, and groups leaves into *buckets* by block count so each kernel
kernel sees one block count (or one rung).  Everything is vectorized NumPy — no per-leaf
Python loop on the hot path.

The bucket outputs concatenate to a leaf order different from the input
order; ``PackedLeaves.inverse_order`` is the gather that restores it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .constants import (
    BLOCK_BYTES,
    MAX_LEAF_BYTES,
    TILE,
    TILE_LANE,
    TILE_SUB,
    padded_block_count,
)


def quantized_tiles(n: int) -> int:
    """Tile count for ``n`` leaves, padded to a power of two so compiled
    kernels are shared across batches instead of recompiling per exact
    count (rows past ``n`` are zero and their digests are never gathered).
    The JAX package's rule, kept by :func:`pack_spans`; the CUDA kernels take
    any tile count, and the engine's flush pass (:func:`pack_flush`) packs
    ``ceil(n / 1024)`` tiles."""
    t = -(-n // TILE)
    return 1 << (t - 1).bit_length() if t > 1 else 1


@dataclass
class Bucket:
    """All leaves whose padded message is exactly ``nblocks`` blocks long —
    or, for a *stream* bucket (``counts is not None``), all leaves whose
    padded block count lands in the same quantized-capacity rung: rows are
    padded with zero blocks to ``nblocks`` (the rung capacity) and
    ``counts[i]`` records leaf i's real block count for in-kernel
    predication.

    ``words`` is the tile-major device wire format: shape
    ``(quantized_tiles(count), nblocks*16, 8, 128)`` uint32, holding word w
    of leaf r at ``[r // 1024, w, (r % 1024) // 128, r % 128]`` — one leaf
    per lane, the layout the leaf kernels read (the lanes of a warp load
    consecutive words), so nothing is ever transposed on the device."""

    nblocks: int
    words: np.ndarray  # (tiles, nblocks*16, 8, 128) uint32 big-endian words
    count: int
    counts: np.ndarray | None = None  # (count,) int32 real block counts

    def leaf_words(self, i: int) -> np.ndarray:
        """(nblocks*16,) big-endian words of leaf ``i`` — test/debug view."""
        return np.asarray(self.words[i // TILE, :, (i % TILE) // TILE_LANE, i % TILE_LANE])


@dataclass
class PackedLeaves:
    """Bucketed, padded, word-packed leaves plus the restore permutation."""

    buckets: list[Bucket]
    order: np.ndarray  # original leaf index of row i of the bucket concat
    inverse_order: np.ndarray  # bucket-concat row holding original leaf i
    count: int
    total_bytes: int  # payload bytes (pre-padding)
    # Long leaves routed to the host hasher (see pack_spans
    # ``max_device_blocks``): (data, offsets, lengths) spans, ordered after
    # every device bucket in the concat that ``order`` indexes.
    host_spans: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None


def split_lines(buffer: np.ndarray | bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split a newline-separated byte buffer into (data, offsets, lengths).

    Matches the reference's line protocol (Inputs.cpp:75-101 reads to '\\n' or
    EOF): a trailing fragment without a final newline still counts as a line;
    empty lines are *kept* here (callers filter, as Vkmr.cpp:40-43 does).
    """
    data = np.frombuffer(buffer, dtype=np.uint8) if isinstance(buffer, (bytes, bytearray, memoryview)) else buffer
    if data.size == 0:
        return data, np.zeros(0, np.int64), np.zeros(0, np.int64)
    newlines = np.flatnonzero(data == 0x0A)
    if newlines.size and newlines[-1] == data.size - 1:
        starts = np.concatenate(([0], newlines[:-1] + 1))
        ends = newlines
    else:
        starts = np.concatenate(([0], newlines + 1))
        ends = np.concatenate((newlines, [data.size]))
    return data, starts.astype(np.int64), (ends - starts).astype(np.int64)


# Leaves whose padded message is at most this many blocks get an *exact*
# bucket per block count: each compiles to a fully-unrolled kernel (the
# fastest form, and only 8 shapes exist).  Longer leaves go to quantized
# stream buckets (see stream_capacity), hashed by the stream kernel, whose
# leaves each loop over their own block count.
UNROLL_MAX_BLOCKS = 8

_STREAM_LADDER_BASE = 10


def stream_capacity(nblocks: int) -> int:
    """Quantized block capacity for a stream bucket: a geometric ladder with
    ratio <= 5/4, so wasted (predicated-off) compressions stay under 20%
    while the number of distinct compiled shapes stays logarithmic in the
    leaf-length range (cf. the reference's single data-dependent block loop,
    SHA-256.comp:207-285).  The rungs are the JAX package's, so both packers
    give the same buckets; the stream kernel takes every rung of a flush in
    one launch."""
    cap = _STREAM_LADDER_BASE
    while cap < nblocks:
        cap += -(-cap // 4)  # next rung = ceil(cap * 5/4)
    return cap


def _rows_to_tiles(rows: np.ndarray, tiles: int) -> np.ndarray:
    """(n, W) leaf-major word rows -> (tiles, W, 8, 128) tile-major wire
    format (fallback path; the native packers scatter directly)."""
    n, wcount = rows.shape
    if n != tiles * TILE:
        padded = np.zeros((tiles * TILE, wcount), np.uint32)
        padded[:n] = rows
        rows = padded
    return np.ascontiguousarray(
        rows.reshape(tiles, TILE_SUB, TILE_LANE, wcount).transpose(0, 3, 1, 2)
    )


def _pack_stream_tiles(
    data: np.ndarray, offs: np.ndarray, lens: np.ndarray, cap_blocks: int
) -> np.ndarray:
    """Pack leaves into tile-major rows of ``cap_blocks`` message blocks:
    FIPS padding at each leaf's real block boundary, zero blocks after.
    Python loop per leaf is fine in the fallback — stream leaves are
    >512 B each, so the loop count is small relative to the bytes moved."""
    from .native.lib import native_pack_stream_bucket_tiles

    tiles = quantized_tiles(int(lens.size))
    out = native_pack_stream_bucket_tiles(data, offs, lens, cap_blocks, tiles)
    if out is not None:
        return out
    n = int(lens.size)
    buf = np.zeros((n, cap_blocks * BLOCK_BYTES), dtype=np.uint8)
    for i in range(n):
        length = int(lens[i])
        row = buf[i]
        row[:length] = data[int(offs[i]) : int(offs[i]) + length]
        row[length] = 0x80
        end = padded_block_count(length) * BLOCK_BYTES
        row[end - 8 : end] = np.frombuffer((length * 8).to_bytes(8, "big"), np.uint8)
    rows = buf.view(">u4").astype(np.uint32).reshape(n, cap_blocks * 16)
    return _rows_to_tiles(rows, tiles)


def pack_spans(
    data: np.ndarray,
    offsets: np.ndarray,
    lengths: np.ndarray,
    max_device_blocks: int | None = None,
) -> PackedLeaves:
    """Pack leaves given as (offset, length) spans over one u8 buffer.

    Leaves up to ``UNROLL_MAX_BLOCKS`` blocks get exact per-block-count
    buckets (fully-unrolled kernels).  Longer leaves get quantized *stream*
    buckets hashed by the single-compression block-loop kernel — so leaves
    of any length stay on the device, like the reference's mapping shader
    streaming arbitrarily many blocks per string (SHA-256.comp:207-285).
    ``max_device_blocks``, when set, routes still-longer leaves to
    ``host_spans`` for the host SHA-256 (SHA-NI): past that point a sparse
    batch cannot fill the 1024 lanes of a tile and the serial host hash is
    honestly faster; it also bounds the packed row pitch."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    offsets = np.asarray(offsets, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    count = int(lengths.size)
    if count == 0:
        return PackedLeaves([], np.zeros(0, np.int64), np.zeros(0, np.int64), 0, 0)
    lmax = int(lengths.max(initial=0))
    if lmax > MAX_LEAF_BYTES:
        raise ValueError(f"leaf exceeds MAX_LEAF_BYTES={MAX_LEAF_BYTES}")

    try:
        from .native.lib import native_pack_bucket_tiles
    except Exception:
        native_pack_bucket_tiles = None

    # Fast path: every leaf lands in the same exact bucket (uniform-ish
    # batches — the engine's steady state).  Skips the per-bucket NumPy
    # machinery (unique/isin/index gathers, ~40% of a uniform flush's pack
    # time) and returns an identity order.
    if (
        native_pack_bucket_tiles is not None
        and padded_block_count(lmax) <= UNROLL_MAX_BLOCKS
        and (max_device_blocks is None or max_device_blocks >= padded_block_count(lmax))
    ):
        b = padded_block_count(lmax)
        if int(lengths.min()) + 9 > (b - 1) * BLOCK_BYTES:  # same block count
            tiles = quantized_tiles(count)
            words = native_pack_bucket_tiles(data, offsets, lengths, b, tiles)
            if words is not None:
                order = np.arange(count, dtype=np.int64)
                return PackedLeaves(
                    [Bucket(b, words, count)], order, order, count,
                    int(lengths.sum()),
                )

    nblocks = (lengths + 9 + BLOCK_BYTES - 1) // BLOCK_BYTES
    host_spans = None
    host_idx = np.zeros(0, np.int64)
    device_blocks = np.unique(nblocks)
    if max_device_blocks is not None:
        host_idx = np.flatnonzero(nblocks > max_device_blocks)
        if host_idx.size:
            host_spans = (data, offsets[host_idx], lengths[host_idx])
            device_blocks = device_blocks[device_blocks <= max_device_blocks]
    buckets: list[Bucket] = []
    order_parts: list[np.ndarray] = []
    for b in device_blocks[device_blocks <= UNROLL_MAX_BLOCKS]:
        idx = np.flatnonzero(nblocks == b)
        lens = lengths[idx]
        offs = offsets[idx]
        pitch = int(b) * BLOCK_BYTES
        tiles = quantized_tiles(int(idx.size))
        words = None
        if native_pack_bucket_tiles is not None:
            words = native_pack_bucket_tiles(data, offs, lens, int(b), tiles)
        if words is None:
            buf = np.zeros((idx.size, pitch), dtype=np.uint8)
            total = int(lens.sum())
            if total:
                # Ragged gather/scatter: copy each leaf's bytes into its row.
                row = np.repeat(np.arange(idx.size, dtype=np.int64), lens)
                cum = np.concatenate(([0], np.cumsum(lens)[:-1]))
                within = np.arange(total, dtype=np.int64) - np.repeat(cum, lens)
                src = np.repeat(offs, lens) + within
                buf.reshape(-1)[row * pitch + within] = data[src]
            # FIPS-180 padding: 0x80 directly after the payload, bit length in
            # the final 8 bytes (big-endian; top word zero — exact buckets are
            # <= UNROLL_MAX_BLOCKS blocks, far below 2^29 bytes).
            buf.reshape(-1)[np.arange(idx.size, dtype=np.int64) * pitch + lens] = 0x80
            be = buf.view(">u4").reshape(idx.size, pitch // 4)
            be[:, -1] = (lens << 3).astype(np.uint32)
            words = _rows_to_tiles(np.ascontiguousarray(be).astype(np.uint32), tiles)
        buckets.append(Bucket(int(b), words, int(idx.size)))
        order_parts.append(idx)

    # Stream buckets: group long leaves by quantized capacity rung.
    long_blocks = device_blocks[device_blocks > UNROLL_MAX_BLOCKS]
    if long_blocks.size:
        caps = np.array([stream_capacity(int(b)) for b in long_blocks])
        for cap in np.unique(caps):
            members = long_blocks[caps == cap]
            idx = np.flatnonzero(np.isin(nblocks, members))
            # Sort by real block count so the native packer's 16-leaf groups
            # are length-homogeneous: each group only writes word planes up
            # to its longest member, leaving the rung's zero tail untouched.
            idx = idx[np.argsort(nblocks[idx], kind="stable")]
            words = _pack_stream_tiles(data, offsets[idx], lengths[idx], int(cap))
            buckets.append(
                Bucket(int(cap), words, int(idx.size), counts=nblocks[idx].astype(np.int32))
            )
            order_parts.append(idx)

    if host_spans is not None:
        order_parts.append(host_idx)
    order = np.concatenate(order_parts)
    inverse_order = np.empty(count, dtype=np.int64)
    inverse_order[order] = np.arange(count, dtype=np.int64)
    return PackedLeaves(
        buckets, order, inverse_order, count, int(lengths.sum()), host_spans
    )


def merge_chunks(chunks):
    """Merge popped ``(data, offsets, lengths)`` chunks into one span set, so
    a whole flush packs (and is bit-reversal permuted) in one ``pack_spans``
    call.  One chunk is returned as it is.  Several copy their covering byte
    range when the spans are dense (the streaming reader's layout); sparse
    spans over a large shared buffer are gathered span by span, so the copy
    is O(payload), not O(covered range).  The port's copy of
    ``vk_merkle_roots_tpu/models/tpu.py::TpuSha256D._merge_chunks`` (:690)."""
    if len(chunks) == 1:
        return chunks[0]
    datas, offs_parts, lens_parts = [], [], []
    base = 0
    for data, offs, lens in chunks:
        lo = int(offs.min())
        hi = int((offs + lens).max())
        total = int(lens.sum())
        if hi - lo <= 4 * total:
            datas.append(data[lo:hi])
            offs_parts.append(offs - lo + base)
            lens_parts.append(lens)
            base += hi - lo
        else:
            cum = np.concatenate(([0], np.cumsum(lens)[:-1]))
            within = np.arange(total, dtype=np.int64) - np.repeat(cum, lens)
            datas.append(data[np.repeat(offs, lens) + within])
            offs_parts.append(cum + base)
            lens_parts.append(lens)
            base += total
    return np.concatenate(datas), np.concatenate(offs_parts), np.concatenate(lens_parts)


def pack_flush(chunks, perm: np.ndarray | None, max_device_blocks: int | None = None) -> tuple[PackedLeaves, bool]:
    """Pack one engine flush: its ``(data, offsets, lengths)`` chunks joined
    and gathered through ``perm`` (chunk order when ``perm`` is None) into
    one ``PackedLeaves``, and whether the native flush pass packed it.

    The pass (``vkmr_pack_flush``) reads each leaf where it lies, in one
    call that holds no interpreter lock and starts no OpenMP team: the
    buckets, ``order`` and ``inverse_order`` of ``pack_spans``, but each
    bucket ``ceil(count / 1024)`` tiles, not :func:`quantized_tiles`, all in
    one allocation.  It declines a flush when the library is not loaded or a
    leaf needs more than ``UNROLL_MAX_BLOCKS`` or ``max_device_blocks``
    blocks; that flush is ``pack_spans`` of :func:`merge_chunks`, permuted."""
    from .native.lib import native_pack_flush

    got = native_pack_flush(chunks, perm, UNROLL_MAX_BLOCKS if max_device_blocks is None else max_device_blocks)
    if got is None:
        data, offs, lens = merge_chunks(chunks)
        if perm is not None:
            offs, lens = offs[perm], lens[perm]
        return pack_spans(data, offs, lens, max_device_blocks), False
    words, order, inverse, rows, word_offsets, total = got
    buckets = []
    for b in range(1, UNROLL_MAX_BLOCKS + 1):
        count = int(rows[b - 1])
        if count:
            tiles, lo = -(-count // TILE), int(word_offsets[b - 1])
            bucket = words[lo : lo + tiles * b * 16 * TILE].reshape(tiles, b * 16, TILE_SUB, TILE_LANE)
            buckets.append(Bucket(b, bucket, count))
    if len(buckets) == 1:  # one bucket keeps the input order, as pack_spans' fast path says
        inverse = order
    return PackedLeaves(buckets, order, inverse, int(order.size), total), True


def pack_leaves(leaves: list[bytes]) -> PackedLeaves:
    """Pack a Python list of byte strings (convenience path for tests and the
    per-leaf ``Add`` API; the streaming path uses ``split_lines``+``pack_spans``
    on a single buffer)."""
    if not leaves:
        return PackedLeaves([], np.zeros(0, np.int64), np.zeros(0, np.int64), 0, 0)
    lengths = np.fromiter((len(x) for x in leaves), dtype=np.int64, count=len(leaves))
    offsets = np.concatenate(([0], np.cumsum(lengths)[:-1]))
    data = np.frombuffer(b"".join(leaves), dtype=np.uint8)
    return pack_spans(data, offsets, lengths)


def reference_padded_words(leaf: bytes) -> np.ndarray:
    """Scalar (slow) padding of one leaf — the oracle for ``pack_spans``."""
    n = padded_block_count(len(leaf))
    buf = bytearray(n * BLOCK_BYTES)
    buf[: len(leaf)] = leaf
    buf[len(leaf)] = 0x80
    buf[-8:] = (len(leaf) * 8).to_bytes(8, "big")
    return np.frombuffer(bytes(buf), dtype=">u4").astype(np.uint32)
