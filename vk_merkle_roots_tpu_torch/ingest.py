"""Streaming stdin ingest (the port's copy of ``vk_merkle_roots_tpu/ingest.py``).

Replaces the reference's byte-at-a-time ``fgetc`` reader
(``Inputs.cpp:75-101`` — a known host bottleneck)
with chunked binary reads split by newline.  Line semantics match the
reference exactly: lines are newline-separated, a trailing fragment without
a final newline is still a line, empty lines are surfaced so the caller can
warn and skip them (Vkmr.cpp:40-43).

Where the port's native host library loads, each read lands in a fresh
buffer and ``vkmr_split_lines`` finds its lines with the interpreter lock
released; otherwise vectorized NumPy splits them (``packing.split_lines``).
Both paths yield the same chunks, array for array.
"""

from __future__ import annotations

from collections import Counter
from typing import BinaryIO, Iterator

import numpy as np

from .native import lib as native
from .packing import split_lines

DEFAULT_CHUNK = 8 << 20

# Reads split in this process, by path: "native" (vkmr_split_lines) or
# "numpy" (packing.split_lines).  Read by the benchmark's
# ``ingest_native_share``.
split_reads: Counter = Counter()


def iter_line_spans(
    stream: BinaryIO, chunk_bytes: int = DEFAULT_CHUNK
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (data, offsets, lengths) span batches for newline-separated
    lines read from a binary stream.  Lengths may include 0 for empty
    lines — callers filter.  Each batch's ``data`` is a buffer of its own,
    never written again: a caller may keep it while later batches arrive."""
    if native.native_available():
        yield from _native_line_spans(stream, chunk_bytes)
    else:
        yield from _numpy_line_spans(stream, chunk_bytes)


def _native_line_spans(stream: BinaryIO, chunk_bytes: int):
    """One read of ``chunk_bytes`` into the tail of a fresh buffer whose
    head holds the incomplete line carried from the last read, then the
    native line scan of the new bytes; a batch is the buffer up to its last
    newline.  A line longer than the buffer grows it geometrically, so it
    costs O(line), as the list of pieces does in :func:`_numpy_line_spans`."""
    readinto = getattr(stream, "readinto", None)
    buf = np.empty(chunk_bytes, np.uint8)
    held = 0  # bytes at buf's head after the last newline read
    lines = None  # the last batch's line count: the next scan's room
    while True:
        if buf.size - held < chunk_bytes:
            grown = np.empty(max(2 * buf.size, held + chunk_bytes), np.uint8)
            grown[:held] = buf[:held]
            buf = grown
        room = buf[held : held + chunk_bytes]
        if readinto is not None:
            got = readinto(room) or 0
        else:
            block = stream.read(chunk_bytes) or b""
            got = len(block)
            room[:got] = np.frombuffer(block, np.uint8)
        if not got:
            break
        split_reads["native"] += 1
        n = held + got
        starts, lengths = native.native_split_lines(buf, n, held, None if lines is None else lines + lines // 8 + 64)
        if not starts.size:
            held = n
            continue
        lines = int(starts.size)
        end = int(starts[-1] + lengths[-1]) + 1
        yield buf[:end], starts, lengths
        # The caller may keep the batch (the engine's pending leaves do), so
        # the next read goes to a fresh buffer, never into this one.
        held = n - end
        fresh = np.empty(held + chunk_bytes, np.uint8)
        fresh[:held] = buf[end:n]
        buf = fresh
    if held:
        yield buf[:held], np.zeros(1, np.int64), np.array([held], np.int64)


def _numpy_line_spans(stream: BinaryIO, chunk_bytes: int):
    # The carry (bytes after the last newline) accumulates as a LIST of
    # chunks, joined only when a newline finally arrives: rebuilding a
    # bytes carry on every read would be O(line^2) for lines much larger
    # than the chunk size (a 1 GB host-routed leaf would memcpy ~64 GB).
    carry: list[bytes] = []
    while True:
        block = stream.read(chunk_bytes)
        if not block:
            break
        split_reads["numpy"] += 1
        if b"\n" not in block:
            carry.append(block)
            continue
        buf = b"".join(carry) + block if carry else block
        carry.clear()
        last_nl = buf.rfind(b"\n")
        complete, rest = buf[: last_nl + 1], buf[last_nl + 1 :]
        if rest:
            carry.append(rest)
        data, offs, lens = split_lines(complete)
        if lens.size:
            yield data, offs, lens
    if carry:
        data, offs, lens = split_lines(b"".join(carry))
        if lens.size:
            yield data, offs, lens
