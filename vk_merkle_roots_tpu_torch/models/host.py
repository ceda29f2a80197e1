"""Host half of the streaming engine: the pending-leaf FIFO, pack jobs and
the host Merkle reduce.

The port's copies of ``vk_merkle_roots_tpu/models/tpu.py``'s
``_PendingLeaves``, ``_PackJob`` and ``_InlinePack`` (:104-181) and of
``TpuSha256D._host_reduce`` (:1068), with the same behaviour.  Nothing here
touches a device; the chunk merge of a flush is :func:`..packing.merge_chunks`.
"""

from __future__ import annotations

import numpy as np

from .. import oracle
from ..native.lib import native_merkle_root


class PendingLeaves:
    """FIFO of leaf spans over shared byte buffers.  Popping an exact
    number of leaves may split a stored chunk: its offset and length arrays
    are sliced, its data buffer is shared, never copied."""

    def __init__(self) -> None:
        self._chunks: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self.count = 0
        self.nbytes = 0

    def push(self, data: np.ndarray, offsets: np.ndarray, lengths: np.ndarray) -> None:
        if lengths.size == 0:
            return
        self._chunks.append((data, offsets, lengths))
        self.count += int(lengths.size)
        self.nbytes += int(lengths.sum())

    def pop(self, n: int) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        out = []
        while n > 0 and self._chunks:
            data, offs, lens = self._chunks[0]
            if lens.size <= n:
                out.append(self._chunks.pop(0))
                n -= lens.size
                self.count -= int(lens.size)
                self.nbytes -= int(lens.sum())
            else:
                out.append((data, offs[:n], lens[:n]))
                self._chunks[0] = (data, offs[n:], lens[n:])
                self.count -= n
                self.nbytes -= int(lens[:n].sum())
                n = 0
        return out

    def push_front(self, chunks) -> None:
        """Return popped but unprocessed chunks to the head of the FIFO, in
        stream order (the rollback after a failed flush)."""
        for data, offs, lens in reversed(chunks):
            if lens.size == 0:
                continue
            self._chunks.insert(0, (data, offs, lens))
            self.count += int(lens.size)
            self.nbytes += int(lens.sum())


class PackJob:
    """One in-flight flush batch: its popped chunks (kept so a failure can
    return them to the FIFO in stream order), the pack result's future, and
    the slice column it was planned to start at."""

    __slots__ = ("chunks", "future", "take", "group_flush", "nbytes", "start")

    def __init__(self, chunks, future, take: int, group_flush: bool, nbytes: int, start: int) -> None:
        self.chunks = chunks
        self.future = future
        self.take = take
        self.group_flush = group_flush
        self.nbytes = nbytes
        self.start = start


class InlinePack:
    """Future shim for ``pack_ahead=0``, and for a drain with nothing
    queued: runs the pack on the caller's thread when its result is asked
    for."""

    __slots__ = ("_fn", "_args")

    def __init__(self, fn, *args) -> None:
        self._fn, self._args = fn, args

    def result(self):
        return self._fn(*self._args)

    def done(self) -> bool:
        return True  # ready: it runs on the caller's thread at result()


def host_reduce(rows: np.ndarray, height: int) -> bytes:
    """Merkle-reduce ``(n, 32)`` digest byte rows on the host: the native
    library when it loads, hashlib otherwise.  ``height=-1`` reduces to one
    node; ``height>=0`` runs exactly that many levels (the phantom
    full-height rule)."""
    root = native_merkle_root(rows, height=height)
    if root is not None:
        return root
    digs = [rows[i].tobytes() for i in range(rows.shape[0])]
    if height < 0:
        return oracle.merkle_root_of_digests(digs)
    return oracle.reduce_slice(digs, height)
