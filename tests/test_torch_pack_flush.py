"""The engine's packing of a flush (``packing.pack_flush``): its native pass
onto the compact wire (one call a flush: a row table and the raw bytes in
one slot) against the general path (``merge_chunks`` then ``pack_spans``)
and the slice's columns, its fallback to that path as one packed unit a
flush, the ``pack_one_pass`` stage, and the TORCH engine's roots through
both against the oracle."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from vk_merkle_roots_tpu_torch import oracle
from vk_merkle_roots_tpu_torch.config import EngineConfig
from vk_merkle_roots_tpu_torch.models.cuda import CudaSha256D
from vk_merkle_roots_tpu_torch.native import lib as native
from vk_merkle_roots_tpu_torch.native.lib import native_available, native_rndm_stream, native_wire_flush
from vk_merkle_roots_tpu_torch.ops.leaf_hash import WireSlot
from vk_merkle_roots_tpu_torch.packing import (
    FlushColumns,
    PackedLeaves,
    WireFlush,
    merge_chunks,
    pack_flush,
    pack_spans,
    split_lines,
)
from vk_merkle_roots_tpu_torch.utils.bitmath import bit_reverse_indices

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGES = (1, 55, 56, 119, 120, 503)  # each side of the 1/2, 2/3 and 8/9-block bounds


@pytest.fixture(autouse=True)
def _library():
    if not native_available():
        pytest.fail("the native host library did not build; the flush pass needs it")


def _rndm(count, seed=1712489279):
    """``rndm <seed> <count> 127`` as spans over the stream's one buffer."""
    data, offs, lens = split_lines(np.frombuffer(native_rndm_stream(seed, count, 127), np.uint8))
    keep = lens > 0
    return data, offs[keep], lens[keep]


def _edges(count):
    lens = np.resize(np.array(EDGES, np.int64), count)
    data = np.random.default_rng(count).integers(0, 256, int(lens.sum()), dtype=np.uint8)
    return data, np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64), lens


def _one_bucket(count):
    lens = np.random.default_rng(count).integers(56, 120, count).astype(np.int64)  # all 2 blocks
    data = np.random.default_rng(count + 1).integers(0, 256, int(lens.sum()), dtype=np.uint8)
    return data, np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64), lens


def _chunked(spans, parts):
    """The spans as the engine pops them: ``parts`` chunks of uneven sizes
    over the shared buffer."""
    data, offs, lens = spans
    n = len(lens)
    cuts = sorted({0, n, *(int(n * f * f) for f in np.linspace(0, 1, parts + 1)[1:-1])})
    return [(data, offs[a:b], lens[a:b]) for a, b in zip(cuts, cuts[1:])]


def _sparse(count):
    """Chunks of spans scattered over one large shared buffer, out of
    order, with gaps (as ``AddSpans`` may hand them in)."""
    rng = np.random.default_rng(count + 7)
    buf = rng.integers(0, 256, 1 << 20, dtype=np.uint8)
    lens = rng.integers(1, 127, count).astype(np.int64)
    offs = rng.integers(0, buf.size - 256, count).astype(np.int64)
    half = count // 2
    return [(buf, offs[:half], lens[:half]), (buf[3:], offs[half:], lens[half:])]


# (id, chunks maker, bit-reversed)
CASES = [
    *[(f"rndm{n}-{p}chunk", (lambda n=n, p=p: _chunked(_rndm(n), p)), False)
      for n in (1, 1023, 1024, 1025, 1 << 16) for p in (1, 5)],
    *[(f"rndm{n}-{p}chunk-bitrev", (lambda n=n, p=p: _chunked(_rndm(n), p)), True)
      for n in (1, 1024, 1 << 16) for p in (1, 5)],
    ("edges-1chunk", lambda: _chunked(_edges(3000), 1), False),
    ("edges-4chunk-bitrev", lambda: _chunked(_edges(4096), 4), True),
    ("sparse", lambda: _sparse(1000), False),
    ("sparse-bitrev", lambda: _sparse(2048), True),
    ("one-bucket", lambda: _chunked(_one_bucket(2500), 3), False),
    ("one-bucket-bitrev", lambda: _chunked(_one_bucket(1 << 12), 1), True),
]


def _general(chunks, max_blocks=2048):
    return pack_spans(*merge_chunks(chunks), max_blocks)


def _columns(n, bitrev):
    """A flush starting a grouped slice (its one group bit-reversed), or at
    column 3 of a natural one."""
    return FlushColumns(0, bit_reverse_indices(n.bit_length() - 1)) if bitrev else FlushColumns(3)


@pytest.mark.parametrize("make,bitrev", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_pass_equals_merge_and_pack_spans(make, bitrev):
    """The compact unit's rows are ``pack_spans``' order, bucket for bucket,
    each row's bytes in the region are its leaf's, and each row's column is
    its leaf's column in the slice."""
    chunks = make()
    n = sum(len(lens) for _, _, lens in chunks)
    assert not bitrev or n == 1 << (n.bit_length() - 1)
    columns = _columns(n, bitrev)
    (got, wire), want = pack_flush(chunks, columns, 2048, WireSlot("cpu")), _general(chunks)
    assert wire and isinstance(got, WireFlush)
    assert (got.count, got.total_bytes, want.host_spans) == (want.count, want.total_bytes, None)
    assert [(b + 1, int(r)) for b, r in enumerate(got.rows) if r] == [(b.nblocks, b.count) for b in want.buckets]
    data, offs, lens = merge_chunks(chunks)
    assert np.array_equal(got.lengths, lens[want.order])
    assert np.array_equal(got.columns, columns.of(n)[want.order])
    region = got.region
    for r in np.linspace(0, n - 1, min(n, 300)).astype(np.int64):
        o, leaf = int(got.offsets[r]), int(want.order[r])
        assert region[o : o + lens[leaf]].tobytes() == data[offs[leaf] : offs[leaf] + lens[leaf]].tobytes()
    spans = [(int((o + x).max() - o.min()), int(x.sum())) for _, o, x in chunks]
    region_len = sum(covered if covered <= 4 * payload else payload for covered, payload in spans)
    assert got.byte_len == -(-region_len // 4) * 4  # each chunk's covered range, or its spans when sparse


def test_buckets_share_one_allocation_and_zero_their_last_tile():
    """The table and the bytes of a unit share one buffer, the slot's, from
    flush to flush, and the region's tail past the last byte is zero."""
    slot = WireSlot("cpu")
    chunks = _chunked(_edges(2500), 3)
    first, _ = pack_flush(chunks, FlushColumns(0), 2048, slot)
    assert sum(r > 0 for r in first.rows) == 4 and first.buf.ctypes.data == slot.host.data_ptr()
    assert first.byte_len - first.total_bytes < 4 and not first.region[first.total_bytes :].any()
    again, _ = pack_flush(_chunked(_edges(2000), 2), FlushColumns(0), 2048, slot)
    assert again.buf.ctypes.data == first.buf.ctypes.data  # no fresh buffer a flush
    assert first.nbytes == 16 * -(-10 * 2500 // 16) + first.byte_len


@pytest.mark.parametrize("start,count", [(5, 20), (14, 9), (16, 16), (0, 7)])
def test_columns_of_a_partial_flush_into_a_grouped_slice_are_the_places(start, count):
    """A partial flush into a grouped slice: the pass's columns are the
    positions ``_place`` writes natural digests to (``FlushColumns.of``),
    the group base plus the bit reversal of the in-group index."""
    data, offs, lens = _rndm(count, seed=start + 11)
    rev = bit_reverse_indices(3)
    unit, wire = pack_flush([(data, offs, lens)], FlushColumns(start, rev), 2048, WireSlot("cpu"))
    pos = np.arange(start, start + count)
    want = (pos // 8) * 8 + rev[pos % 8]
    assert wire and np.array_equal(np.sort(unit.columns), np.sort(want))
    assert np.array_equal(unit.columns, want[_general([(data, offs, lens)]).order])


@pytest.mark.parametrize("lens,max_blocks", [
    ((10, 504, 20), 2048),  # a leaf of 9 blocks: a stream rung
    ((10, 100, 3000), 2048),
    ((10, 120, 20), 2),  # 3 blocks over device_max_blocks
    ((10, 20), 0),
])
def test_pass_declines_what_the_exact_buckets_do_not_hold(lens, max_blocks):
    """The pass declines the flush, which is then the general path's one
    packed unit, in natural order."""
    lens = np.array(lens, np.int64)
    data = np.ones(int(lens.sum()), np.uint8)
    offs = np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64)
    for chunks in ([(data, offs, lens)], [(data, offs[:1], lens[:1]), (data, offs[1:], lens[1:])]):
        assert native_wire_flush(chunks, 0, None, max_blocks, WireSlot("cpu")) is None
        got, wire = pack_flush(chunks, FlushColumns(0), max_blocks, WireSlot("cpu"))
        want = pack_spans(data, offs, lens, max_blocks)
        assert not wire and isinstance(got, PackedLeaves)
        assert np.array_equal(got.order, want.order) and np.array_equal(got.inverse_order, want.inverse_order)
        assert [(b.nblocks, b.count) for b in got.buckets] == [(b.nblocks, b.count) for b in want.buckets]
        assert all(np.array_equal(g.words, w.words) for g, w in zip(got.buckets, want.buckets))


@pytest.mark.parametrize("offs,lens", [((0, 90), (10, 20)), ((-1, 0), (10, 20)), ((0, 5), (10, -3))])
def test_pass_declines_spans_outside_their_chunk(offs, lens):
    data = np.ones(100, np.uint8)
    chunks = [(data, np.array(offs, np.int64), np.array(lens, np.int64))]
    assert native_wire_flush(chunks, 0, None, 2048, WireSlot("cpu")) is None


def test_pass_rejects_a_permutation_of_another_size():
    """A group permutation must have a power of two of entries, each inside
    its group: the first raises, the second declines the flush."""
    data, offs, lens = _rndm(64)
    with pytest.raises(ValueError, match="permutation"):
        pack_flush([(data, offs, lens)], FlushColumns(0, np.arange(48)), 2048, WireSlot("cpu"))
    outside = bit_reverse_indices(5)
    outside[3] = 32
    assert native_wire_flush([(data, offs, lens)], 0, outside, 2048, WireSlot("cpu")) is None


def _engine(**kw):
    return CudaSha256D(device="cpu", config=EngineConfig(**{"slice_log2": 4, "host_tail_leaves": 8192, **kw}))


def _leaves(seed, count, lo=1, hi=126):
    rng = np.random.default_rng(seed)
    return [rng.integers(32, 127, size=int(n), dtype=np.uint8).tobytes() for n in rng.integers(lo, hi + 1, count)]


def _add(engine, leaves):
    lens = np.array([len(x) for x in leaves], np.int64)
    offs = np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64)
    return engine.AddSpans(np.frombuffer(b"".join(leaves), np.uint8), offs, lens)


def _add_in_chunks(engine, leaves, per):
    for i in range(0, len(leaves), per):
        assert _add(engine, leaves[i : i + per])


# (batch_leaves, chunk size, leaves, pack_ahead): 8 is a power of two, so
# full flushes are grouped (bit-reversed); 6 keeps the natural layout.
ENGINE = [(8, 3, 45, 2), (8, 8, 37, 0), (6, 4, 40, 2), (6, 1, 23, 0), (8, 5, 45, 1), (6, 3, 40, 1)]


@pytest.mark.parametrize("batch,per,count,pack_ahead", ENGINE)
def test_engine_roots_through_the_pass_equal_the_oracle(batch, per, count, pack_ahead):
    leaves = _leaves(batch * 100 + count, count)
    e = _engine(batch_leaves=batch, pack_ahead=pack_ahead)
    _add_in_chunks(e, leaves, per)
    assert e.Root() == oracle.merkle_root_sliced(leaves, 4).hex()
    stages = e.Stats()["stages"]
    assert stages["pack_one_pass"]["count"] == stages["pack"]["count"] == stages["map_dispatch"]["count"]
    assert stages["pack_one_pass"]["bytes"] == stages["pack"]["bytes"] == sum(map(len, leaves))
    assert "GB_per_s" in stages["pack_one_pass"]


@pytest.mark.parametrize("kw,lens", [
    ({}, (520, 1100)),  # 9+ blocks: stream rungs
    ({"device_max_blocks": 2}, (121, 126)),  # 3 blocks: host hashing
])
def test_long_leaves_take_the_general_path_and_stay_exact(kw, lens):
    leaves = _leaves(sum(lens), 30, 1, 110)
    leaves[1:8:3] = _leaves(lens[0], 3, *lens)  # in the first of four flushes only
    e = _engine(batch_leaves=8, **kw)
    _add_in_chunks(e, leaves, 5)
    assert e.Root() == oracle.merkle_root_sliced(leaves, 4).hex()
    stages = e.Stats()["stages"]
    assert (stages["pack"]["count"], stages["pack_one_pass"]["count"]) == (4, 3)


# (id, engine settings, long leaf lengths, native library loaded)
DECLINED = [
    ("stream-rung", {}, (520, 1100), True),  # 9+ blocks
    ("host-hashed", {"device_max_blocks": 2}, (121, 126), True),  # 3 blocks
    ("stream-rung-no-library", {}, (520, 1100), False),
    ("host-hashed-no-library", {"device_max_blocks": 2}, (121, 126), False),
]


@pytest.mark.parametrize("kw,lens,library", [c[1:] for c in DECLINED], ids=[c[0] for c in DECLINED])
def test_a_declined_flush_of_several_chunks_is_one_packed_unit(monkeypatch, kw, lens, library):
    """A flush the pass declines (a long leaf, or no native library) packs
    and dispatches as one unit, however many chunks it spans: 12-leaf
    batches are not grouped, and chunks of 5 put each 12-leaf flush over
    three chunks."""
    if not library:
        monkeypatch.setattr(native, "_load", lambda: None)
    leaves = _leaves(sum(lens) + library, 40, 1, 110)
    leaves[6] = _leaves(lens[0], 1, *lens)[0]  # in the second chunk of the first flush
    e = _engine(batch_leaves=12, **kw)
    _add_in_chunks(e, leaves, 5)
    assert e.Root() == oracle.merkle_root_sliced(leaves, 4).hex()
    stages = e.Stats()["stages"]
    flushes = 5  # 12 + 4 leaves a 16-leaf slice, twice, then 8 at Root()
    assert stages["map_dispatch"]["count"] == stages["pack"]["count"] == flushes
    assert stages.get("pack_one_pass", {"count": 0})["count"] == (flushes - 1 if library else 0)


def test_pack_one_pass_counts_every_flush_of_short_leaves_and_none_of_long():
    short = _engine(batch_leaves=16)
    _add_in_chunks(short, _leaves(3, 40), 7)
    short.Root()
    stages = short.Stats()["stages"]
    assert stages["pack_one_pass"]["count"] == stages["pack"]["count"] == 3
    long = _engine(batch_leaves=16)
    _add_in_chunks(long, _leaves(4, 20, 504, 700), 7)
    long.Root()
    stages = long.Stats()["stages"]
    assert stages["pack"]["count"] == 2 and "pack_one_pass" not in stages


# (leaves, chunk size): one flush, all at Root(); flushes packed ahead too.
DRAINS = [(5, 5), (7, 2), (45, 3), (64, 16)]


@pytest.mark.parametrize("count,per", DRAINS)
def test_a_drain_with_nothing_queued_packs_on_the_callers_thread(monkeypatch, count, per):
    """Root() packs a flush on its own thread when no pack is queued ahead of
    it (it would wait on that pack at once); the flushes packed while leaves
    arrive run on the pack thread. A stream short enough for one flush never
    starts the pack thread. The root is the oracle's either way."""
    real = CudaSha256D._pack_worker
    phase, ran = ["add"], []

    def recording(self, *args):
        ran.append((phase[0], threading.current_thread() is threading.main_thread()))
        return real(self, *args)

    monkeypatch.setattr(CudaSha256D, "_pack_worker", recording)
    leaves = _leaves(count * 10 + per, count)
    e = _engine(batch_leaves=8, pack_ahead=2)
    _add_in_chunks(e, leaves, per)
    phase[0] = "root"
    assert e.Root() == oracle.merkle_root_sliced(leaves, 4).hex()
    assert all(not inline for when, inline in ran if when == "add")
    if count < 8:
        assert ran == [("root", True)] and e._executor is None
    else:
        assert any(when == "add" for when, _ in ran)


def test_a_failed_dispatch_of_a_several_chunk_flush_requeues_all_its_chunks(monkeypatch):
    """One packed unit covers every chunk of a flush the pass took: an
    out-of-memory dispatch returns all of them to the queue, in order."""
    import vk_merkle_roots_tpu_torch.models.cuda as cuda_mod

    real = cuda_mod.leaf_hashes
    failures = [1]

    def flaky(packed, device, **kw):
        if failures[0]:
            failures[0] -= 1
            raise torch.cuda.OutOfMemoryError("fake: flush does not fit")
        return real(packed, device, **kw)

    monkeypatch.setattr(cuda_mod, "leaf_hashes", flaky)
    leaves = _leaves(11, 30)
    e = _engine(batch_leaves=12, pack_ahead=0)
    assert _add(e, leaves[:4]) and _add(e, leaves[4:8])
    assert not _add(e, leaves[8:12])  # the flush of three chunks fails; at the floor batch, softly
    assert failures == [0] and e._fill == 0 and e._pending.count == 12
    _add_in_chunks(e, leaves[12:], 4)
    assert e.Root() == oracle.merkle_root_sliced(leaves, 4).hex()


def test_the_pass_starts_no_thread():
    """The flush pass runs on its caller's thread: packing a 2^16-leaf
    bit-reversed flush adds no thread to a fresh process (an OpenMP team
    would stay, parked), where one call of the bucket packer does when the
    library was built with OpenMP."""
    code = (
        "import os, numpy as np\n"
        "from vk_merkle_roots_tpu_torch.native import lib\n"
        "from vk_merkle_roots_tpu_torch.ops.leaf_hash import WireSlot\n"
        "from vk_merkle_roots_tpu_torch.packing import FlushColumns, pack_flush, split_lines\n"
        "from vk_merkle_roots_tpu_torch.utils.bitmath import bit_reverse_indices\n"
        "d, o, l = split_lines(np.frombuffer(lib.native_rndm_stream(7, 1 << 16, 127), np.uint8))\n"
        "slot, cols = WireSlot('cpu'), FlushColumns(0, bit_reverse_indices(16))\n"
        "threads = lambda: len(os.listdir('/proc/self/task'))\n"
        "before = threads()\n"
        "for _ in range(3):\n"
        "    assert pack_flush([(d, o, l)], cols, 2048, slot)[1]\n"
        "after = threads()\n"
        "lib.native_pack_bucket_tiles(d, o, l, 2, 64)\n"
        "print(before, after, threads(), lib._load()._name.endswith('_omp.so'))\n"
    )
    env = {**os.environ, "OMP_NUM_THREADS": "4", "OPENBLAS_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    before, after, with_team, omp = out.stdout.split()
    assert int(after) == int(before)
    if omp == "True":
        assert int(with_team) > int(after)  # the check can see a team
