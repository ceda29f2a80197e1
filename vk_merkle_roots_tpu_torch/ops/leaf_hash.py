"""Leaf hashing ("mapping"): SHA-256d of every packed leaf, word-major.

Port of ``vk_merkle_roots_tpu/ops/leaf_hash.py``.  The host packer
(:mod:`..packing`) emits the tile-major wire format,
``(tiles, nblocks*16, 8, 128)`` uint32 with word w of leaf r at
``(r // 1024)*W*1024 + w*1024 + r % 1024``, which the CUDA kernels read.

Two kernels, each taking every bucket of its kind in a flush in one launch,
behind a wrapper that launches it for CUDA tensors and runs the plain
PyTorch version for CPU tensors:

* :func:`exact_hash_buckets_into`
  (``csrc/leaf_hash.cu::leaf_hash_exact_kernel``) replaces the Pallas
  ``_leaf_kernel`` (``leaf_hash.py:61``), one grid per exact bucket there;
* :func:`stream_hash_buckets_into`
  (``csrc/leaf_hash.cu::leaf_hash_stream_kernel``) replaces the Pallas
  ``_stream_kernel`` (``leaf_hash.py:129``), one grid per stream rung there.

A bucket is a :class:`LeafBucket`; the wrapper orders a flush's buckets
longest first into the kernel's table (:func:`launch_tables`).

The engine's flushes of short leaves take the compact wire instead
(:class:`..packing.WireFlush`): one copy of a row table and the raw bytes
from a reused, page-locked :class:`WireSlot`, then K1's second form
(:func:`wire_hash_into`, the same kernel name), which pads each leaf on the
device and writes its digest at its row's column.
:func:`exact_hash_into` and :func:`stream_hash_into` are the one-bucket
forms.  All write SHA-256d digests word-major into an ``(8, ld)`` int32
tensor at each bucket's column, the counterpart of ``bucket_hash_append``
(``leaf_hash.py:117``): the engine hashes straight into its slice buffer.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..constants import TILE
from ..packing import UNROLL_MAX_BLOCKS, PackedLeaves, WireFlush
from ..utils.timing import StageTimes
from . import sha256_core as core

MAX_TABLE_BUCKETS = 32  # kMaxBuckets of csrc/leaf_hash.cu; more buckets take more launches
EXACT_CTA_THREADS = 128  # kExactThreads: one leaf per thread
WARP = 32  # kStreamThreads: a stream CTA is one warp


class LeafBucket(NamedTuple):
    """One packed bucket as the leaf kernels take it."""

    words: torch.Tensor  # int32 wire words (tiles, nblocks*16, 8, 128)
    nblocks: int  # blocks per leaf (exact) or the rung's cap blocks (stream)
    count: int  # leaves
    col: int  # output column of the first leaf
    counts: torch.Tensor | None = None  # stream rungs: int32 real block count per leaf


class _TableBucket(ctypes.Structure):
    _fields_ = [("words", ctypes.c_void_p), ("counts", ctypes.c_void_p), ("out_col", ctypes.c_longlong),
                ("nblocks", ctypes.c_int), ("count", ctypes.c_int), ("cta_begin", ctypes.c_int),
                ("pad", ctypes.c_int)]


class LeafTable(ctypes.Structure):
    """``LeafTable`` of ``csrc/leaf_hash.cu``: the kernel's one parameter."""

    _fields_ = [("out", ctypes.c_void_p), ("ld", ctypes.c_longlong), ("n", ctypes.c_int),
                ("leaves_per_cta", ctypes.c_int), ("b", _TableBucket * MAX_TABLE_BUCKETS)]


def stream_leaves_per_warp(n_leaves: int, sms: int) -> int:
    """Leaves each stream warp takes: the flush's stream leaves spread over
    the card's 4 x ``sms`` warp schedulers, one warp each, 1..32 lanes busy."""
    return max(1, min(WARP, -(-n_leaves // (4 * sms))))


def launch_tables(buckets, out: torch.Tensor, leaves_per_cta: int) -> list[tuple[LeafTable, int]]:
    """The kernel tables of a flush's non-empty ``buckets``, one per launch,
    with each launch's CTA count.  Buckets with the most blocks come first and
    take the lowest CTAs; past :data:`MAX_TABLE_BUCKETS` they go on in
    another table."""
    order = sorted((b for b in buckets if b.count), key=lambda b: -b.nblocks)
    tables = []
    for lo in range(0, len(order), MAX_TABLE_BUCKETS):
        part = order[lo : lo + MAX_TABLE_BUCKETS]
        table = LeafTable(out=out.data_ptr(), ld=out.stride(0), n=len(part), leaves_per_cta=leaves_per_cta)
        ctas = 0
        for j, b in enumerate(part):
            counts = b.counts.data_ptr() if b.counts is not None else None
            table.b[j] = _TableBucket(b.words.data_ptr(), counts, b.col, b.nblocks, b.count, ctas, 0)
            ctas += -(-b.count // leaves_per_cta)
        if ctas >= 1 << 31:
            raise ValueError(f"{ctas} CTAs exceed one launch's grid")
        tables.append((table, ctas))
    return tables


def _check(words: torch.Tensor, out: torch.Tensor, wcount: int, count: int, offset: int) -> None:
    if words.dtype != torch.int32 or out.dtype != torch.int32:
        raise TypeError(f"want int32 words and output, got {words.dtype} and {out.dtype}")
    if words.device != out.device:
        raise ValueError(f"words on {words.device} but output on {out.device}")
    if words.dim() != 4 or words.shape[1:] != (wcount, 8, 128) or not words.is_contiguous():
        raise ValueError(f"want contiguous (tiles, {wcount}, 8, 128) words, got {tuple(words.shape)}")
    if count < 0 or count > words.shape[0] * TILE or count >= 1 << 31:
        raise ValueError(f"count={count} exceeds the {words.shape[0]} packed tiles")
    if out.dim() != 2 or out.shape[0] != 8 or out.stride(1) != 1:
        raise ValueError(f"want an (8, ld) output with unit column stride, got {tuple(out.shape)}")
    if offset < 0 or offset + count > out.shape[1]:
        raise ValueError(f"columns [{offset}, {offset + count}) exceed the output's {out.shape[1]}")


def _leaf_columns(words: torch.Tensor, count: int) -> torch.Tensor:
    """(tiles, W, 8, 128) wire words -> (W, count) int64 word columns."""
    wcount = words.shape[1]
    cols = words.permute(1, 0, 2, 3).reshape(wcount, -1)[:, :count]
    return core.to_words(cols)


def exact_hash_plain(words: torch.Tensor, nblocks: int, count: int) -> torch.Tensor:
    """Plain version of the exact-bucket kernel: (8, count) int32 digests."""
    cols = _leaf_columns(words, count)
    blocks = [[cols[b * 16 + t] for t in range(16)] for b in range(nblocks)]
    return core.from_words(torch.stack(core.leaf_digest_words(blocks)))


def stream_hash_plain(words: torch.Tensor, counts: torch.Tensor, count: int) -> torch.Tensor:
    """Plain version of the stream kernel: each leaf's state advances only
    through its own ``counts`` real blocks.  (8, count) int32 digests."""
    cols = _leaf_columns(words, count)
    counts = counts[:count].to(torch.int64)
    state = core.initial_state(cols[0])
    for b in range(int(counts.max()) if count else 0):
        new = core.compress(state, [cols[b * 16 + t] for t in range(16)])
        active = counts > b
        state = tuple(torch.where(active, n, s) for n, s in zip(new, state))
    return core.from_words(torch.stack(core.finalize_sha256d(state)))


def _launch(name: str, fn: str, buckets, out: torch.Tensor, leaves_per_cta: int) -> None:
    with torch.cuda.device(out.device):
        for table, ctas in launch_tables(buckets, out, leaves_per_cta):
            _build.launch(name, fn, ctypes.addressof(table), ctas, _build.stream_of(out), entries=table.n)


def exact_hash_buckets_into(buckets, out: torch.Tensor) -> None:
    """SHA-256d of every leaf of a flush's exact buckets (1..8 blocks each),
    bucket ``b`` into ``out[:, b.col:b.col + b.count]``: one kernel launch on
    the card (per :data:`MAX_TABLE_BUCKETS` buckets), the plain version
    bucket by bucket on the CPU."""
    for b in buckets:
        if not 1 <= b.nblocks <= UNROLL_MAX_BLOCKS or b.counts is not None:
            raise ValueError(f"exact buckets hold 1..{UNROLL_MAX_BLOCKS} blocks and no block counts")
        _check(b.words, out, b.nblocks * 16, b.count, b.col)
    buckets = [b for b in buckets if b.count]
    if not buckets:
        return
    if out.device.type == "cpu":
        _build.plain_calls["leaf_hash_exact"] += 1
        for b in buckets:
            out[:, b.col : b.col + b.count] = exact_hash_plain(b.words, b.nblocks, b.count)
        return
    _launch("leaf_hash_exact", "vkmr_leaf_hash_exact", buckets, out, EXACT_CTA_THREADS)


def _check_block_counts(counts, count: int, cap_blocks: int) -> None:
    """Host-side check of per-leaf block counts (numpy or a CPU tensor)."""
    if count and (int(counts[:count].max()) > cap_blocks or int(counts[:count].min()) < 1):
        raise ValueError(f"block counts must lie in [1, {cap_blocks}]")


def stream_hash_buckets_into(buckets, out: torch.Tensor) -> None:
    """SHA-256d of every leaf of a flush's stream rungs, rung ``b`` (rows of
    ``b.nblocks`` blocks, leaf i real for ``b.counts[i]`` of them) into
    ``out[:, b.col:b.col + b.count]``: one kernel launch on the card (per
    :data:`MAX_TABLE_BUCKETS` rungs), the plain version rung by rung on the
    CPU.

    CPU counts are checked to lie in [1, nblocks].  CUDA counts are not read
    back (that would stall the stream): the kernel clamps each to
    [0, nblocks], so a bad count cannot read past its row, and
    :func:`leaf_hashes` checks the packer's counts before the upload."""
    for b in buckets:
        _check(b.words, out, b.nblocks * 16, b.count, b.col)
        c = b.counts
        if c is None or c.dtype != torch.int32 or c.device != out.device or c.dim() != 1:
            raise ValueError("want int32 per-leaf block counts on the output's device")
        if c.numel() < b.count or not c.is_contiguous():
            raise ValueError(f"want {b.count} contiguous block counts, got {c.numel()}")
    buckets = [b for b in buckets if b.count]
    if not buckets:
        return
    if out.device.type == "cpu":
        _build.plain_calls["leaf_hash_stream"] += 1
        for b in buckets:
            _check_block_counts(b.counts, b.count, b.nblocks)
            out[:, b.col : b.col + b.count] = stream_hash_plain(b.words, b.counts, b.count)
        return
    sms = torch.cuda.get_device_properties(out.device).multi_processor_count
    per_warp = stream_leaves_per_warp(sum(b.count for b in buckets), sms)
    _launch("leaf_hash_stream", "vkmr_leaf_hash_stream", buckets, out, per_warp)


def exact_hash_into(words: torch.Tensor, nblocks: int, count: int, out: torch.Tensor, offset: int) -> None:
    """SHA-256d of the first ``count`` leaves of one exact bucket of
    ``nblocks`` blocks (``words``: int32 wire format), written to
    ``out[:, offset:offset + count]``."""
    exact_hash_buckets_into([LeafBucket(words, nblocks, count, offset)], out)


def stream_hash_into(
    words: torch.Tensor, counts: torch.Tensor, cap_blocks: int, count: int, out: torch.Tensor, offset: int
) -> None:
    """SHA-256d of the first ``count`` leaves of one stream rung of
    ``cap_blocks`` blocks (leaf i real for ``counts[i]`` of them), written to
    ``out[:, offset:offset + count]``."""
    stream_hash_buckets_into([LeafBucket(words, cap_blocks, count, offset, counts)], out)


class _WireBucket(ctypes.Structure):
    _fields_ = [("nblocks", ctypes.c_int), ("count", ctypes.c_int), ("row_begin", ctypes.c_int),
                ("cta_begin", ctypes.c_int)]


class WireTable(ctypes.Structure):
    """``WireTable`` of ``csrc/leaf_hash.cu``: the parameter of K1's compact
    wire form."""

    _fields_ = [("out", ctypes.c_void_p), ("ld", ctypes.c_longlong), ("bytes", ctypes.c_void_p),
                ("nbytes", ctypes.c_longlong), ("off", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                ("len", ctypes.c_void_p), ("n", ctypes.c_int), ("pad", ctypes.c_int),
                ("b", _WireBucket * UNROLL_MAX_BLOCKS)]


class WireSlot:
    """A staging buffer of the compact wire that an engine reuses flush after
    flush: page-locked on a CUDA device (torch's pinned host allocator, grown
    to a power of two and then kept), ordinary memory on the CPU.  On each
    card it copies to, it keeps a device buffer as large and an event, which
    :meth:`upload` records after its copy (one call into the kernel library,
    ``vkmr_wire_upload``) and :meth:`buffer` waits on before the slot is
    written again."""

    MIN_BYTES = 1 << 16

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self.host: torch.Tensor | None = None
        self._cards: dict[int, tuple[torch.Tensor, int]] = {}  # card -> (device buffer, event)
        self._pending: int | None = None  # the event after the last copy out of host

    def buffer(self, nbytes: int) -> np.ndarray:
        """The buffer, at least ``nbytes`` long, once the device has finished
        the last copy out of it: the flush pass calls this before it writes."""
        if self._pending is not None:
            _cuda_check("vkmr_event_wait", _build.load().vkmr_event_wait(self._pending))
            self._pending = None
        if self.host is None or self.host.numel() < nbytes:
            size = max(self.MIN_BYTES, 1 << (nbytes - 1).bit_length())
            self.host = torch.empty(size, dtype=torch.uint8, pin_memory=self.device.type == "cuda")
        return self.host.numpy()

    def upload(self, nbytes: int, device: torch.device) -> torch.Tensor:
        """A tensor on ``device`` whose first ``nbytes`` are the buffer's: on a
        CUDA device one copy, not waited for, with the event after it; on the
        CPU the buffer itself."""
        if device.type != "cuda":
            return self.host
        lib = _build.load()
        with torch.cuda.device(device):
            buf, event = self._cards.get(device.index, (None, None))
            if buf is None or buf.numel() < self.host.numel():
                buf = torch.empty(self.host.numel(), dtype=torch.uint8, device=device)
                if event is None:
                    event = lib.vkmr_event_new()
                    if not event:
                        raise RuntimeError("cudaEventCreate failed for a wire slot")
                    weakref.finalize(self, lib.vkmr_event_free, event)
                self._cards[device.index] = (buf, event)
            stream = torch.cuda.current_stream(device).cuda_stream
            _cuda_check("vkmr_wire_upload",
                        lib.vkmr_wire_upload(buf.data_ptr(), self.host.data_ptr(), nbytes, stream, event))
        self._pending = event
        return buf


def _cuda_check(fn: str, rc: int) -> None:
    if rc != 0:
        msg = _build.load().vkmr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{fn} failed: {msg} (error {rc})")


def _check_wire(unit: WireFlush, out: torch.Tensor) -> None:
    if out.dtype != torch.int32 or out.dim() != 2 or out.shape[0] != 8 or not out.is_contiguous():
        raise ValueError(f"want a contiguous (8, ld) int32 output, got {tuple(out.shape)} {out.dtype}")
    if unit.rows.shape != (UNROLL_MAX_BLOCKS,) or int(unit.rows.sum()) != unit.count or unit.count >= 1 << 31:
        raise ValueError(f"rows {unit.rows} do not add up to the {unit.count} rows of the table")
    table = 10 * unit.count
    if unit.bytes_at < table or unit.bytes_at % 16 or unit.byte_len % 4:
        raise ValueError(f"a byte region at {unit.bytes_at} of {unit.byte_len} bytes over a {table}-byte table")
    if unit.nbytes != unit.bytes_at + unit.byte_len or unit.nbytes > unit.buf.size:
        raise ValueError(f"{unit.nbytes} bytes in use of a {unit.buf.size}-byte buffer")


def wire_tables(unit: WireFlush, dev: torch.Tensor, out: torch.Tensor) -> tuple[WireTable, int]:
    """K1's table for the compact unit ``unit`` copied to ``dev``, and its
    CTA count: buckets with the most blocks first, as :func:`launch_tables`
    orders them."""
    base, n = dev.data_ptr(), unit.count
    table = WireTable(out=out.data_ptr(), ld=out.stride(0), bytes=base + unit.bytes_at, nbytes=unit.byte_len,
                      off=base, dst=base + 4 * n, len=base + 8 * n)
    begins = np.concatenate(([0], np.cumsum(unit.rows)[:-1]))
    ctas = 0
    for b in range(UNROLL_MAX_BLOCKS, 0, -1):
        count = int(unit.rows[b - 1])
        if count:
            table.b[table.n] = _WireBucket(b, count, int(begins[b - 1]), ctas)
            table.n += 1
            ctas += -(-count // EXACT_CTA_THREADS)
    return table, ctas


def wire_hash_plain(unit: WireFlush, out: torch.Tensor) -> None:
    """Plain version of K1's compact wire form: each row padded on the host
    from the same table and bytes, with the kernel's clamps, and compressed
    with ``sha256_core``; its digest goes to ``out[:, column]`` unless the
    column is at or past ``out``'s width."""
    off, lens, cols = (x.astype(np.int64) for x in (unit.offsets, unit.lengths, unit.columns))
    region, nbytes = unit.region, unit.byte_len
    row = 0
    for b in range(1, UNROLL_MAX_BLOCKS + 1):
        count = int(unit.rows[b - 1])
        rows, row = slice(row, row + count), row + count
        if not count:
            continue
        o = np.minimum(off[rows], nbytes)
        n = np.minimum(np.minimum(lens[rows], nbytes - o), b * 64 - 9)
        pitch = b * 64
        buf = np.zeros((count, pitch), np.uint8)
        total = int(n.sum())
        if total:
            within = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(n) - n, n)
            buf.reshape(-1)[np.repeat(np.arange(count) * pitch, n) + within] = region[np.repeat(o, n) + within]
        buf[np.arange(count), n] = 0x80
        words = buf.view(">u4").astype(np.uint32)
        words[:, -1] = (n << 3).astype(np.uint32)
        w = core.to_words(torch.from_numpy(np.ascontiguousarray(words.T).view(np.int32)))
        digs = core.from_words(torch.stack(core.leaf_digest_words([[w[k * 16 + t] for t in range(16)]
                                                                   for k in range(b)])))
        keep = cols[rows] < out.shape[1]
        out[:, torch.from_numpy(cols[rows][keep])] = digs[:, torch.from_numpy(keep)]


def wire_hash_into(unit: WireFlush, out: torch.Tensor, times: StageTimes | None = None) -> None:
    """SHA-256d of every leaf of a compact unit, each into ``out[:, c]`` at
    its row's column c: the unit's one copy from its slot (the ``upload``
    span, with the slot bytes in use), then one K1 launch on the card; the
    plain version on the CPU, from the same buffer."""
    _check_wire(unit, out)
    if times is None:
        dev = unit.slot.upload(unit.nbytes, out.device)
    else:
        with times.span("upload", unit.nbytes):
            dev = unit.slot.upload(unit.nbytes, out.device)
    if out.device.type == "cpu":
        _build.plain_calls["leaf_hash_exact"] += 1
        wire_hash_plain(unit, out)
        return
    with torch.cuda.device(out.device):
        table, ctas = wire_tables(unit, dev, out)
        if ctas:
            _build.launch("leaf_hash_exact", "vkmr_leaf_hash_wire", ctypes.addressof(table), ctas,
                          _build.stream_of(out), entries=table.n)


def to_device_words(arr: np.ndarray, device) -> torch.Tensor:
    """Host uint32 (or int32) array -> int32 tensor on ``device`` (same bits)."""
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int32)).to(device)


def _upload_nbytes(packed: PackedLeaves) -> int:
    """Bytes :func:`flush_buckets` copies to the device: the packed words
    and the int32 block counts."""
    return sum(b.words.nbytes + (4 * b.counts.size if b.counts is not None else 0) for b in packed.buckets)


def host_leaf_digest_cols(data, offsets, lengths) -> np.ndarray:
    """(8, n) uint32 digest columns of long leaves hashed on the host
    (native SHA-NI when built, hashlib otherwise) — the counterpart of
    ``leaf_hash.py::_host_leaf_digest_cols`` (:221), without the tile
    padding, which only bounded XLA compiles."""
    from .. import oracle
    from ..native.lib import native_leaf_hashes_spans

    n = int(lengths.size)
    out = native_leaf_hashes_spans(data, offsets, lengths)
    if out is None:
        out = np.empty((n, 32), np.uint8)
        for i in range(n):
            span = data[int(offsets[i]) : int(offsets[i]) + int(lengths[i])].tobytes()
            out[i] = np.frombuffer(oracle.leaf_hash(span), np.uint8)
    return np.ascontiguousarray(out.view(">u4").astype(np.uint32).reshape(n, 8).T)


def flush_buckets(packed: PackedLeaves, device, base: int = 0) -> tuple[list[LeafBucket], list[LeafBucket]]:
    """The exact buckets and the stream rungs of one packed flush as
    :class:`LeafBucket` s on ``device``, in packed order from column
    ``base``.  The packer's block counts are checked on the host before they
    are uploaded."""
    exact, stream = [], []
    for b in packed.buckets:
        words = to_device_words(b.words, device)
        if b.counts is None:
            exact.append(LeafBucket(words, b.nblocks, b.count, base))
        else:
            counts = np.ascontiguousarray(b.counts, np.int32)
            _check_block_counts(counts, b.count, b.nblocks)
            stream.append(LeafBucket(words, b.nblocks, b.count, base, torch.from_numpy(counts).to(device)))
        base += b.count
    return exact, stream


def leaf_hashes(
    packed: PackedLeaves | WireFlush, device, out: torch.Tensor | None = None, offset: int = 0,
    times: StageTimes | None = None,
) -> torch.Tensor:
    """Hash all packed leaves; returns (8, packed.count) int32 word-major
    digest columns in the original input order.  With ``out`` (an (8, ld)
    int32 tensor on ``device``) the digests land in
    ``out[:, offset:offset + count]`` and that view is returned.

    A compact unit (:class:`..packing.WireFlush`) is hashed by
    :func:`wire_hash_into` instead, each digest at its row's column: into
    ``out`` (``offset`` unused), which is returned whole, or into a fresh
    ``(8, count)`` tensor, whose columns the unit's must be.

    Port of ``leaf_hash.py::leaf_hashes`` (:243): the exact buckets hash in
    one K1 launch and the stream rungs in one K4 launch, each into its column
    range; ``host_spans`` hash on the host and are copied in after them, and
    one ``index_select`` on ``inverse_order`` restores the input order when
    the packer reordered the leaves.  In input order the kernels write
    straight into ``out``.  With ``times`` the copies of the packed words and
    block counts (:func:`flush_buckets`) are one ``upload`` span; the host
    digests and the inverse order, copied after the kernels are launched,
    are not in it."""
    device = torch.device(device)
    if isinstance(packed, WireFlush):
        if out is None:
            out = torch.empty((8, packed.count), dtype=torch.int32, device=device)
        wire_hash_into(packed, out, times)
        return out
    n = packed.count
    identity = packed.order is packed.inverse_order or np.array_equal(packed.inverse_order, np.arange(n))
    if out is not None and identity:
        dst, start = out, offset
    else:
        dst, start = torch.empty((8, n), dtype=torch.int32, device=device), 0
    if times is None:
        exact, stream = flush_buckets(packed, device, start)
    else:
        with times.span("upload", _upload_nbytes(packed)):
            exact, stream = flush_buckets(packed, device, start)
    exact_hash_buckets_into(exact, dst)
    stream_hash_buckets_into(stream, dst)
    if packed.host_spans is not None:
        base = start + sum(b.count for b in packed.buckets)
        host = host_leaf_digest_cols(*packed.host_spans)
        dst[:, base : base + host.shape[1]] = to_device_words(host, device)
    if identity:
        return dst[:, start : start + n]
    inv = torch.from_numpy(np.asarray(packed.inverse_order, np.int64)).to(device)
    digs = dst.index_select(1, inv)
    if out is None:
        return digs
    out[:, offset : offset + n] = digs
    return out[:, offset : offset + n]
