"""CUDA streaming engine: the device-backed ``Sha256dEngine`` of the port.

Port of ``vk_merkle_roots_tpu/models/tpu.py::TpuSha256D`` onto one
``torch.device``.  A CUDA device runs the hand-written kernels; the CPU
device runs their plain PyTorch versions (the ``TORCH`` engine, used by the
tests and only when named).

What carries over, with the same semantics:

* ``Add`` / ``AddMany`` / ``AddSpans`` ingest into a FIFO of spans;
* the pack-ahead pipeline: ``_submit_packs`` pops pending leaves and hands
  them to a packing thread against *planned* slice state, ``_dispatch_job``
  consumes packed batches strictly in order, so plan and reality agree (a
  drain with nothing queued packs on the caller's thread);
* group-bitrev slices: a flush of exactly one aligned power-of-two batch
  starts a slice whose digests are stored group-bit-reversed, so the full
  slice reduces with no device permutation
  (``ops.tree_reduce.reduce_grouped_body``);
* a bound on un-read slice roots, materialized in one stacked readback;
* ``Root()``: ragged tails up to ``host_tail_leaves`` reduce on the host,
  longer ones by binary decomposition on the device;
* the journal of full-slice roots with its stream-integrity chain,
  ``PreloadSliceRoots`` for resume, ``keep_digests`` snapshots with their
  ``<journal>.digests.<i>.npy`` sidecars (the same files, so either package
  resumes the other's journal) and ``Proof()``.  The journal and
  stream-digest methods and ``Proof()`` are ports of the JAX engine's
  (``models/tpu.py:319-454``, :1188); the host queue, pack jobs and host
  reduce are in :mod:`.host`, the packing of a flush in
  :func:`..packing.pack_flush`.

What changed: the slice buffer is one ``(8, 2^slice_log2)`` int32 tensor
with no slack region, because the leaf kernels write exact column counts; a
flush of short leaves goes to the card on the compact wire, its raw bytes
and a row table in one reused, page-locked slot (``ops.leaf_hash.WireSlot``,
one per flush packed ahead), and K1 writes each digest at its slice column,
the bit reversal of a grouped slice folded in; a flush the wire declines
(long leaves) is hashed in natural order and placed by an ``index_copy_``
in a grouped slice; the stages of
``Stats()`` are host spans (``StageTimes.span``), which a running profiler
also records as ``vkmr.<stage>`` ranges, and device time by layer comes from
the profiler's trace alone; an out-of-memory error is
``torch.cuda.OutOfMemoryError``; a ``keep_digests`` snapshot is un-permuted
on the device and read back once (the host tail reuses that readback); a
sidecar is written to a temporary file and renamed, and a torn one counts as
missing on resume; any failure of a pack job, not only ``MemoryError``,
returns its leaves to the queue before it propagates.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
from collections import deque

import numpy as np
import torch

from .. import oracle
from ..config import EngineConfig
from ..constants import MAX_LEAF_BYTES
from ..ops.leaf_hash import leaf_hashes
from ..ops.tree_reduce import (
    bitrev_index,
    merkle_root_of_digest_cols,
    reduce_grouped_body,
    reduce_perfect_block,
    slice_root,
)
from ..ops.leaf_hash import WireSlot
from ..packing import FlushColumns, WireFlush, pack_flush
from ..utils.bitmath import bit_reverse_indices, is_pow2
from ..utils.hexutil import words_to_digest
from ..utils.log import event
from ..utils.timing import StageTimes, StopWatch
from .base import Sha256dEngine
from .host import InlinePack, PackJob, PendingLeaves, host_reduce

_INFO = logging.INFO


def load_digest_sidecars(journal_path: str, roots: list[bytes], cap: int):
    """Load and verify the per-slice digest sidecars of a journal resume
    (counterpart of ``vk_merkle_roots_tpu/models/tpu.py:183``).

    Returns one ``(cap, 8)`` uint32 array per journaled root, or None when
    any sidecar is missing, unreadable or of the wrong shape (a crash can
    leave one torn): the resume then goes on root-only and ``Proof()``
    refuses for the journaled prefix.  A well-formed sidecar that does not
    reduce to its journal root raises instead of mis-proving."""
    digests = []
    for i, root in enumerate(roots):
        path = f"{journal_path}.digests.{i}.npy"
        try:
            d = np.load(path)
        except (OSError, ValueError, EOFError):
            return None
        if d.shape != (cap, 8):
            return None
        rows = np.ascontiguousarray(d.astype(">u4")).view(np.uint8).reshape(cap, 32)
        if host_reduce(rows, height=-1) != root:
            raise ValueError(f"digest sidecar {path} does not reduce to the journaled slice root"
                             " (stale or corrupted); refusing")
        digests.append(np.asarray(d, np.uint32))
    return digests


class CudaSha256D(Sha256dEngine):
    """Streaming SHA-256d Merkle-root engine on one torch device."""

    _ADDBUF_LEAVES = 4096
    _ADDBUF_BYTES = 4 << 20
    _SLICE_FLOOR_LOG2 = 10

    _SHARDED_REDUCE = False  # whether the engine reduces a slice across devices (MESH does)

    def __init__(self, device="cuda", name: str | None = None, config: EngineConfig | None = None) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.config = config or EngineConfig()
        if self.config.sharded_reduce and not self._SHARDED_REDUCE:
            raise ValueError("sharded_reduce (--sharded) is not supported by the one-device engine;"
                             " MeshCudaSha256D (the MESH engine) runs it")
        if name is None:
            name = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "TORCH"
        super().__init__(name)
        self._executor = None
        # One staging slot per flush packed ahead, taken in turn and kept
        # across streams: the flush that takes a slot back was submitted after
        # the dispatch that copied out of it.
        self._slots = [WireSlot(self.device) for _ in range(max(1, self.config.pack_ahead))]
        self._slot_turn = 0
        self.Reset()

    # -- state ---------------------------------------------------------------

    def _refresh_grouping(self) -> None:
        """Group-bitrev parameters for the current config: a power-of-two
        batch packs each full flush bit-reversed; other sizes keep the
        natural layout."""
        self._cap = 1 << self.config.slice_log2
        if is_pow2(self.config.batch_leaves):
            self._group_log2 = min(self.config.slice_log2, self.config.batch_leaves.bit_length() - 1)
            self._rev_group = bit_reverse_indices(self._group_log2)
        else:
            self._group_log2 = None
            self._rev_group = None
        # Layout of the current slice (None until its first append) and the
        # producer-side mirror for not-yet-dispatched pack jobs.
        self._slice_grouped: bool | None = None
        self._plan_grouped: bool | None = None

    # -- journal and resume ----------------------------------------------------

    def _init_stream_digest(self) -> None:
        self._stream_sha = hashlib.sha256()
        self._stream_bytes = 0  # cumulative payload bytes
        self._digested = 0  # leaves folded into the stream digest
        self._snaps: dict[int, tuple[int, str]] = {}  # slice -> (bytes, sha256 hex) at its last leaf

    def PreloadSliceRoots(self, roots: list[bytes], leaves_per_root: int | None = None, stream_sha=None,
                          stream_bytes: int = 0, digests: list[np.ndarray] | None = None) -> None:
        """Seed a fresh engine with full-slice roots already computed (resume
        from a journal): later input continues at the next slice.
        ``leaves_per_root`` defaults to the slice capacity.  ``stream_sha`` (a
        ``hashlib.sha256`` primed over the skipped stream prefix) and
        ``stream_bytes`` continue the journal's integrity chain.  ``digests``
        (one ``(leaves, 8)`` uint32 natural-order array per root, from the
        sidecars) let ``Proof()`` cover the journaled prefix; without them
        proofs of preloaded slices refuse."""
        if self._count or self._roots:
            raise RuntimeError("PreloadSliceRoots requires a fresh engine")
        per = leaves_per_root or self._cap
        self._roots = list(roots)
        self._journaled = self._preloaded = self._full_slices = len(roots)
        self._count = per * len(roots)
        self._digests_base = len(roots)
        if digests is not None:
            if len(digests) != len(roots):
                raise ValueError("digest sidecar count != journaled root count")
            self._slice_digests = [np.asarray(d, np.uint32) for d in digests]
            self._digests_base = 0
        if stream_sha is not None:
            self._stream_sha = stream_sha
        self._stream_bytes = stream_bytes
        self._digested = self._count
        event("resume", slices=len(roots), leaves=self._count)

    def SeedStreamDigest(self, stream_sha, stream_bytes: int) -> None:
        """Install the integrity-digest state of the input already skipped
        (the CLI calls it after checking the skipped prefix on resume)."""
        self._stream_sha = stream_sha
        self._stream_bytes = stream_bytes

    def _update_stream_digest(self, data, offsets, lengths) -> None:
        """Fold one ingested chunk into the running stream digest and note
        (cumulative bytes, hex digest) at every slice boundary.

        Leaf i of a chunk covers ``data[off[i]:off[i+1])`` (the framing bytes
        between the chunk's leaves included) and its last leaf exactly its
        own bytes, so a chunk split at a slice boundary by a resumed run
        covers the same bytes.  Overlapping or unordered spans hash each
        leaf's own span instead."""
        n = int(lengths.size)
        if n == 0:
            return
        ends = np.concatenate([offsets[1:], [offsets[-1] + lengths[-1]]])
        per_leaf = n > 1 and bool(np.any(offsets[1:] < offsets[:-1] + lengths[:-1]))
        cap = self._cap
        i = 0
        while i < n:
            j = min(n, i + cap - (self._digested % cap))
            if per_leaf:
                for k in range(i, j):
                    self._stream_sha.update(data[int(offsets[k]) : int(offsets[k] + lengths[k])])
            else:
                self._stream_sha.update(data[int(offsets[i]) : int(ends[j - 1])])
            self._stream_bytes += int(lengths[i:j].sum())
            self._digested += j - i
            if self._digested % cap == 0:
                self._snaps[self._digested // cap - 1] = (self._stream_bytes, self._stream_sha.hexdigest())
            i = j

    def _journal_materialized(self) -> None:
        """Append the full-slice roots now on the host, in slice order, to
        the journal, with the stream's bytes and SHA-256 at each slice's end.
        Only a prefix of materialized roots is written, so the journal is
        always a consistent resume point; the ragged tail is never written."""
        if not self.config.journal_path:
            return
        new = []
        i = self._journaled
        while i < min(len(self._roots), self._full_slices) and isinstance(self._roots[i], bytes):
            new.append((i, self._roots[i]))
            i += 1
        if not new:
            return
        with open(self.config.journal_path, "a") as fh:
            for idx, root in new:
                rec = {"slice": idx, "leaves": self._cap, "root": root.hex()}
                snap = self._snaps.get(idx)
                if snap is not None:
                    rec["bytes"], rec["sha256"] = snap
                fh.write(json.dumps(rec) + "\n")
        self._journaled = i

    def Reset(self) -> bool:
        # Let in-flight pack jobs finish reading their chunk buffers.
        for job in getattr(self, "_pack_jobs", ()):
            try:
                job.future.result()
            except BaseException:
                pass
        self._refresh_grouping()
        self._batch_cap = self.config.batch_leaves  # halves on device OOM
        self._buf: torch.Tensor | None = None
        self._fill = 0
        self._roots: list = []  # (8,) device tensors or host bytes, slice order
        self._pending = PendingLeaves()
        self._addbuf: list[bytes] = []
        self._addbuf_bytes = 0
        self._pack_jobs: deque[PackJob] = deque()
        self._inflight_nbytes = 0
        self._plan_fill = 0
        self._count = 0
        self._bytes = 0
        self._slice_digests: list[np.ndarray] = []  # (n, 8) uint32 natural order, keep_digests
        self._digests_base = 0  # slice number of _slice_digests[0]
        self._journaled = 0  # full-slice roots already in the journal
        self._preloaded = 0  # slices adopted from a journal
        self._full_slices = 0
        self._tail_done = False
        self._init_stream_digest()
        self.times = StageTimes()
        return True

    # -- ingest --------------------------------------------------------------

    def Add(self, data: bytes) -> bool:
        """Per-leaf ingest, coalesced into bulk ``AddMany`` runs."""
        if len(data) > MAX_LEAF_BYTES:
            return False
        self._addbuf.append(data)
        self._addbuf_bytes += len(data)
        if len(self._addbuf) >= self._ADDBUF_LEAVES or self._addbuf_bytes >= self._ADDBUF_BYTES:
            return self._flush_addbuf()
        return True

    def _flush_addbuf(self) -> bool:
        if not self._addbuf:
            return True
        leaves, self._addbuf, self._addbuf_bytes = self._addbuf, [], 0
        return self.AddMany(leaves)

    def AddMany(self, leaves) -> bool:
        leaves = list(leaves)
        if not leaves:
            return True
        lengths = np.fromiter((len(x) for x in leaves), dtype=np.int64, count=len(leaves))
        if lengths.max(initial=0) > MAX_LEAF_BYTES:
            return False
        offsets = np.concatenate(([0], np.cumsum(lengths)[:-1]))
        data = np.frombuffer(b"".join(leaves), dtype=np.uint8)
        return self.AddSpans(data, offsets, lengths)

    def AddSpans(self, data, offsets, lengths) -> bool:
        """Bulk ingest of (offset, length) spans over one buffer; lengths must
        be positive (the CLI drops empty lines)."""
        if self._addbuf and not self._flush_addbuf():
            return False
        lengths = np.asarray(lengths)
        if lengths.size and int(lengths.max()) > MAX_LEAF_BYTES:
            return False
        if self._tail_done and lengths.size:
            # The stream grew after Root(): the ragged tail's root and its
            # snapshot were only provisional, so the next Root() redoes them.
            if len(self._roots) > self._full_slices:
                self._roots.pop()
            if len(self._slice_digests) > self._full_slices - self._digests_base:
                self._slice_digests.pop()
            self._tail_done = False
        try:
            if self.config.journal_path:
                self._update_stream_digest(np.asarray(data, np.uint8), np.asarray(offsets), lengths)
            self._pending.push(np.asarray(data, np.uint8), np.asarray(offsets), lengths)
            self._count += int(lengths.size)
            self._bytes += int(lengths.sum())
            while (
                self._pending.count >= self.config.batch_leaves
                or self._pending.nbytes >= self.config.batch_bytes
                or self._pending.nbytes + self._inflight_nbytes > self.config.host_pending_bytes
            ):
                if not self._flush_some():
                    event("ingest_failed", reason="device_oom")
                    return False
            return True
        except MemoryError:
            event("ingest_failed", reason="host_oom")
            return False
        except torch.cuda.OutOfMemoryError:
            event("ingest_failed", reason="device_oom")
            return False

    # -- device pipeline -----------------------------------------------------

    def _ensure_buf(self) -> None:
        while self._buf is None:
            try:
                self._buf = torch.empty((8, self._cap), dtype=torch.int32, device=self.device)
            except torch.cuda.OutOfMemoryError:
                # Halve the slice until the device accepts it, but only
                # before any slice is committed or adopted from a journal
                # (both are in _roots; the root depends on the height) and
                # before journaling has digested a leaf (its integrity
                # snapshots are keyed to the old slice boundaries).
                if (self._roots or self._fill or (self.config.journal_path and self._digested)
                        or self.config.slice_log2 <= self._SLICE_FLOOR_LOG2):
                    raise
                self.config = dataclasses.replace(self.config, slice_log2=self.config.slice_log2 - 1)
                self._refresh_grouping()
                event("slice_oom_degrade", slice_log2=self.config.slice_log2)

    def _natural_cols(self, count: int) -> torch.Tensor:
        """The first ``count`` slice digests as natural-order columns,
        whatever the storage layout."""
        if not self._slice_grouped:
            return self._buf[:, :count]
        g = 1 << self._group_log2
        q, r = divmod(count, g)
        rev = bitrev_index(self._group_log2, self.device)
        parts = []
        if q:
            parts.append(self._buf[:, : q * g].reshape(8, q, g).index_select(2, rev).reshape(8, q * g))
        if r:
            parts.append(self._buf[:, q * g : (q + 1) * g].index_select(1, rev[:r]))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def _read_digests(self, count: int) -> np.ndarray:
        """The first ``count`` slice digests as natural-order ``(count, 8)``
        uint32 rows on the host: un-permuted and transposed on the device,
        then one readback."""
        return self._natural_cols(count).t().contiguous().cpu().numpy().view(np.uint32)

    def _save_digest_sidecar(self, idx: int, digs: np.ndarray) -> None:
        """Write a full slice's natural-order digests beside the journal as
        ``<journal>.digests.<idx>.npy`` (the JAX engine's name and format)
        when both journaling and ``keep_digests`` are on.  The array goes to
        a temporary file in the same directory, renamed over the final name,
        so a crash never leaves a torn sidecar under it."""
        if not (self.config.journal_path and self.config.keep_digests):
            return
        path = f"{self.config.journal_path}.digests.{idx}.npy"
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as fh:  # a handle: np.save would add ".npy" to a name
                np.save(fh, digs)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def _append(self, unit) -> None:
        """Hash one packed batch into the slice buffer at ``_fill``.  An
        engine that hashes a batch elsewhere overrides this and hands the
        digests to :meth:`_place`."""
        if isinstance(unit, WireFlush):  # K1 writes each digest at its slice column
            leaf_hashes(unit, self.device, out=self._buf, times=self.times)
            self._fill += unit.count
        elif self._slice_grouped:
            self._place(leaf_hashes(unit, self.device, times=self.times))
        else:
            leaf_hashes(unit, self.device, out=self._buf, offset=self._fill, times=self.times)
            self._fill += unit.count

    def _place(self, digs: torch.Tensor) -> None:
        """Copy one batch's (8, n) natural-order digest columns into the
        slice buffer from ``_fill``, at the columns of the slice's layout."""
        n = digs.shape[1]
        if self._slice_grouped:
            dest = FlushColumns(self._fill, self._rev_group).of(n)
            self._buf.index_copy_(1, torch.from_numpy(dest).to(self.device), digs)
        else:
            self._buf[:, self._fill : self._fill + n] = digs
        self._fill += n

    def _flush_columns(self, start: int, grouped: bool) -> FlushColumns:
        """Where the digests of a flush starting at slice column ``start``
        land in the slice buffer, whose layout is ``grouped`` or natural."""
        return FlushColumns(start, self._rev_group if grouped else None)

    def _pack_worker(self, chunks, columns: FlushColumns, slot: WireSlot):
        """Pack one flush batch into one unit (on the pack thread, or on the
        caller's when it would wait on the pack at once).  Touches only the
        chunks, the config and the slot.  Returns the unit, the pack's ms,
        and whether it went onto the compact wire
        (:func:`..packing.pack_flush`)."""
        sw = StopWatch()
        unit, wire = pack_flush(chunks, columns, self.config.device_max_blocks, slot)
        return unit, sw.Elapsed(), wire

    def _submit_packs(self, drain: bool = False) -> bool:
        """Producer half: pop pending leaves and hand them to the pack
        thread, up to ``pack_ahead`` batches ahead of dispatch, deciding batch
        geometry against the planned slice state.  Returns True when at
        least one job was submitted."""
        depth = max(1, self.config.pack_ahead)
        submitted = False
        while len(self._pack_jobs) < depth and self._pending.count > 0:
            full_take = min(self._cap - self._plan_fill, self._batch_cap)
            if not (
                drain
                or self._pending.count >= full_take
                or self._pending.nbytes >= self.config.batch_bytes
                or self._pending.nbytes > self.config.host_pending_bytes
            ):
                break
            take = min(self._pending.count, full_take)
            chunks = self._pending.pop(take)
            nbytes = sum(int(lens.sum()) for _, _, lens in chunks)
            group = (1 << self._group_log2) if self._group_log2 is not None else 0
            group_flush = (
                group > 0
                and take == group
                and self._plan_fill % group == 0
                and self._plan_grouped is not False
            )
            if self._plan_fill == 0:
                self._plan_grouped = group_flush
            start = self._plan_fill
            columns = self._flush_columns(start, bool(self._plan_grouped))
            slot = self._slots[self._slot_turn % len(self._slots)]
            self._slot_turn += 1
            self._plan_fill += take
            if self._plan_fill == self._cap:
                self._plan_fill = 0
                self._plan_grouped = None
            # A drain with nothing queued blocks on this pack at once: it runs
            # on the caller's thread, with no hand-off to the pack thread and
            # back (a Root() of a short stream packs no other way).
            if self.config.pack_ahead > 0 and (self._pack_jobs or not drain):
                if self._executor is None:
                    from concurrent.futures import ThreadPoolExecutor

                    self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="vkmr-pack")
                future = self._executor.submit(self._pack_worker, chunks, columns, slot)
            else:
                future = InlinePack(self._pack_worker, chunks, columns, slot)
            self._pack_jobs.append(PackJob(chunks, future, take, group_flush, nbytes, start))
            self._inflight_nbytes += nbytes
            submitted = True
        return submitted

    def _requeue_jobs(self, head_chunks) -> None:
        """Roll the pipeline back after a failure: unprocessed chunks return
        to the pending head in stream order and the plan resyncs."""
        tail = []
        while self._pack_jobs:
            job = self._pack_jobs.popleft()
            try:
                job.future.result()
            except BaseException:
                pass
            tail.extend(job.chunks)
        self._pending.push_front(list(head_chunks) + tail)
        self._inflight_nbytes = 0
        self._plan_fill = self._fill
        self._plan_grouped = self._slice_grouped

    def _flush_some(self, drain: bool = False) -> bool:
        """Top up the pack-ahead queue, dispatch the oldest packed batch
        (blocking on it only when the queue is full, nothing else
        progressed, or draining), then top up again.  Returns False only on
        device OOM at the minimum batch size."""
        if self._pending.count == 0 and not self._pack_jobs:
            return True
        self._ensure_buf()
        progressed = self._submit_packs(drain)
        while self._pack_jobs:
            must = drain or len(self._pack_jobs) >= max(1, self.config.pack_ahead) or not progressed
            if not must and not self._pack_jobs[0].future.done():
                break
            if not self._dispatch_job(self._pack_jobs.popleft()):
                return False
            progressed = True
            self._submit_packs(drain)
            if not drain:
                break
        return True

    def _dispatch_job(self, job) -> bool:
        """Consumer half: hash one packed batch into the slice, and reduce
        the slice when it is full.  Strictly in submission order."""
        take, group_flush = job.take, job.group_flush
        assert take <= self._cap - self._fill and job.start == self._fill, (take, job.start, self._cap, self._fill)
        if self._fill == 0:
            self._slice_grouped = group_flush
        try:
            with self.times.span("pack_wait"):  # also when the pack is done: one a flush
                unit, t_pack, wire = job.future.result()
        except BaseException:
            # Whatever the pack thread raised, its leaves and every queued
            # job's return to the pending head before the error propagates.
            if self._fill == 0:
                self._slice_grouped = None
            self._requeue_jobs(job.chunks)
            raise
        self._inflight_nbytes -= job.nbytes
        self.times.add("pack", t_pack, job.nbytes, throughput=True)
        if wire:  # the flushes on the compact wire
            self.times.add("pack_one_pass", t_pack, job.nbytes, throughput=True)
        try:
            with self.times.span("map_dispatch", job.nbytes):
                self._append(unit)
        except torch.cuda.OutOfMemoryError:
            if self._fill == 0:
                self._slice_grouped = None
            self._requeue_jobs(job.chunks)
            floor = min(1024, self.config.batch_leaves)
            if self._batch_cap <= floor:
                event("device_oom", batch_cap=self._batch_cap, fatal=True)
                return False
            self._batch_cap = max(self._batch_cap // 2, floor)
            event("device_oom_degrade", batch_cap=self._batch_cap)
            return True
        event("map_op", _level=_INFO, leaves=take, bytes=job.nbytes, pack_ms=round(t_pack, 3), grouped=group_flush)
        if self._fill == self._cap:
            self._reduce_full_slice()
        return True

    def _reduce_full_slice(self) -> None:
        if self.config.keep_digests:
            digs = self._read_digests(self._cap)
            self._slice_digests.append(digs)
            self._save_digest_sidecar(self._full_slices, digs)
        with self.times.span("reduce_dispatch", self._cap * 32):
            self._roots.append(self._reduce_slice_root(self._buf))
            self._full_slices += 1
            event("slice_reduced", _level=_INFO, slice=len(self._roots), leaves=self._cap,
                  bytes=self._cap * 32, grouped=bool(self._slice_grouped))
            self._fill = 0
            self._slice_grouped = None
        # Backpressure: past max_slices_in_flight un-read roots, read the
        # oldest half back in one stacked copy.
        live = self._live_roots()
        if len(live) > self.config.max_slices_in_flight:
            take = live[: max(1, len(live) // 2)]
            self._materialize_roots(take)
            event("backpressure_block", slices=len(take), through=take[-1] + 1)
            self._journal_materialized()

    def _reduce_slice_root(self, buf: torch.Tensor) -> torch.Tensor:
        """The (8,) root words of the full slice in ``buf`` (its layout is
        the current slice's), on ``buf``'s device and not yet read back."""
        if self._slice_grouped:
            return reduce_grouped_body(buf, self.config.slice_log2, self._group_log2)
        return reduce_perfect_block(buf, self.config.slice_log2)

    def _live_roots(self) -> list[int]:
        """Indices of the slice roots still on the device."""
        return [i for i, r in enumerate(self._roots) if not isinstance(r, bytes)]

    def _materialize_roots(self, take) -> None:
        """Read the given device roots back in one stacked copy (roots that
        another device reduced join the primary's stack first)."""
        if not take:
            return
        with self.times.span("materialize", len(take) * 32):
            stacked = torch.stack([self._roots[i].to(self.device) for i in take]).cpu().numpy().view(np.uint32)
        for j, i in enumerate(take):
            self._roots[i] = stacked[j].astype(">u4").tobytes()

    def Drain(self) -> bool:
        """Dispatch everything ingested so far (device work may still run)."""
        if not self._flush_addbuf():
            return False
        while self._pending.count > 0 or self._pack_jobs:
            if not self._flush_some(drain=True):
                return False
        return True

    # -- finalization --------------------------------------------------------

    def Root(self) -> str:
        with self.times.span("drain"):
            drained = self.Drain()
        if not drained:
            raise RuntimeError(f"device out of memory during finalization (batch cap {self._batch_cap} leaves)")
        with self.times.span("finalize"):
            root = None
            if self._fill > 0 and not (self._roots and self._tail_done):
                root = self._tail_root()
            if root is None and self._roots:
                self._materialize_roots(self._live_roots())
                self._journal_materialized()
                root = self._roots[0] if len(self._roots) == 1 else oracle.merkle_root_of_digests(self._roots)
        return root.hex() if root is not None else ""

    def _tail_root(self):
        """Reduce the ragged tail in a ``tail_host`` or ``tail_device`` span:
        returns the stream's root when the tail is the whole stream, else
        appends the tail's root to the slice roots and returns None."""
        single = not self._roots
        height = -1 if single else self.config.slice_log2
        host = self._fill <= self.config.host_tail_leaves
        with self.times.span("tail_host" if host else "tail_device", self._fill * 32):
            digs = None
            if self.config.keep_digests and not self._tail_done:
                digs = self._read_digests(self._fill)
                self._slice_digests.append(digs)
            if host:
                # Small ragged tails: one 32 B/leaf readback (the snapshot's,
                # when there is one) and a host reduce beat a chain of small
                # device reductions.
                if digs is None:
                    digs = self._read_digests(self._fill)
                rows = digs.astype(">u4").view(np.uint8).reshape(self._fill, 32)
                tail = host_reduce(rows, height)
            elif single:
                tail = merkle_root_of_digest_cols(self._natural_cols(self._fill), self._fill)
            else:
                tail = slice_root(self._natural_cols(self._fill), self._fill, height)
        self._tail_done = True
        if single:
            return tail
        self._roots.append(tail)
        return None

    def Proof(self, index: int) -> list[tuple[bytes, str]]:
        """Authentication path for leaf ``index`` against the stream root, as
        the JAX engine's ``Proof`` (``models/tpu.py:1188``) gives it: the
        path within the slice (at phantom full height when there are several
        slices) and then the path through the slice roots.  Requires
        ``keep_digests``; call after ``Root()``."""
        if not self.config.keep_digests:
            raise RuntimeError("Proof() requires EngineConfig.keep_digests=True")
        if not self._slice_digests:
            raise RuntimeError("Proof() must be called after Root()")
        if not 0 <= index < self._count:
            raise IndexError(f"leaf index {index} out of range [0, {self._count})")
        s, local = divmod(index, self._cap)
        if s < self._digests_base:
            raise RuntimeError(f"proof unavailable for leaf {index}: slice {s} was resumed "
                               f"from a journal without its digest sidecar")
        digs = self._slice_digests[s - self._digests_base]
        rows = [words_to_digest(digs[i]) for i in range(digs.shape[0])]
        if self._digests_base + len(self._slice_digests) == 1:
            return oracle.merkle_proof_of_digests(rows, local)
        self._materialize_roots(self._live_roots())
        path = oracle.merkle_proof_of_digests(rows, local, height=self.config.slice_log2)
        return path + oracle.merkle_proof_of_digests(self._roots, s)

    def Stats(self) -> dict:
        return {
            "leaves": self._count + len(self._addbuf),
            "bytes": self._bytes + self._addbuf_bytes,
            "slices_completed": self._full_slices,
            "slice_log2": self.config.slice_log2,
            "device": str(self.device),
            "stages": self.times.summary(),
        }
