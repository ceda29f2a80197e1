"""The engine's packing of a flush (``packing.pack_flush``): its native pass
(one call a flush) against the general path (``merge_chunks`` then
``pack_spans``), its fallback to that path as one packed unit a flush, the
``pack_one_pass`` stage, and the TORCH engine's roots through both against
the oracle."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from vk_merkle_roots_tpu_torch import oracle
from vk_merkle_roots_tpu_torch.config import EngineConfig
from vk_merkle_roots_tpu_torch.constants import TILE
from vk_merkle_roots_tpu_torch.models.cuda import CudaSha256D
from vk_merkle_roots_tpu_torch.native import lib as native
from vk_merkle_roots_tpu_torch.native.lib import native_available, native_pack_flush, native_rndm_stream
from vk_merkle_roots_tpu_torch.packing import merge_chunks, pack_flush, pack_spans, split_lines
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


def _general(chunks, perm, max_blocks=2048):
    data, offs, lens = merge_chunks(chunks)
    if perm is not None:
        offs, lens = offs[perm], lens[perm]
    return pack_spans(data, offs, lens, max_blocks)


@pytest.mark.parametrize("make,bitrev", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_pass_equals_merge_and_pack_spans(make, bitrev):
    """Orders equal, and each bucket's words equal the general path's first
    ``ceil(count / 1024)`` tiles (its power-of-two tail is zeros only)."""
    chunks = make()
    n = sum(len(lens) for _, _, lens in chunks)
    perm = bit_reverse_indices(n.bit_length() - 1) if bitrev else None
    assert not bitrev or n == 1 << (n.bit_length() - 1)
    (got, one_pass), want = pack_flush(chunks, perm, 2048), _general(chunks, perm)
    assert one_pass
    assert (got.count, got.total_bytes, got.host_spans) == (want.count, want.total_bytes, None)
    assert np.array_equal(got.order, want.order) and np.array_equal(got.inverse_order, want.inverse_order)
    assert [(b.nblocks, b.count, b.counts) for b in got.buckets] == [(b.nblocks, b.count, None) for b in want.buckets]
    for g, w in zip(got.buckets, want.buckets):
        tiles = -(-g.count // TILE)
        assert g.words.shape == (tiles, g.nblocks * 16, 8, 128) and g.words.dtype == np.uint32
        assert np.array_equal(g.words, w.words[:tiles])
        assert not w.words[tiles:].any()
    assert (got.order is got.inverse_order) == (len(got.buckets) == 1)


def test_buckets_share_one_allocation_and_zero_their_last_tile():
    chunks = _chunked(_edges(2500), 3)
    got, _ = pack_flush(chunks, None, 2048)
    assert len(got.buckets) == 4 and len({id(b.words.base) for b in got.buckets}) == 1
    for b in got.buckets:
        last = b.words[-1].reshape(b.nblocks * 16, TILE)
        assert last[:, b.count % TILE or TILE :].sum() == 0
        assert (last[:, : (b.count - 1) % TILE + 1] != 0).any(axis=0).all()  # every real row has its 0x80


@pytest.mark.parametrize("lens,max_blocks", [
    ((10, 504, 20), 2048),  # a leaf of 9 blocks: a stream rung
    ((10, 100, 3000), 2048),
    ((10, 120, 20), 2),  # 3 blocks over device_max_blocks
    ((10, 20), 0),
])
def test_pass_declines_what_the_exact_buckets_do_not_hold(lens, max_blocks):
    """The pass declines the flush, which is then the general path's one
    packed unit."""
    lens = np.array(lens, np.int64)
    data = np.ones(int(lens.sum()), np.uint8)
    offs = np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64)
    for chunks in ([(data, offs, lens)], [(data, offs[:1], lens[:1]), (data, offs[1:], lens[1:])]):
        assert native_pack_flush(chunks, None, max_blocks) is None
        got, one_pass = pack_flush(chunks, None, max_blocks)
        want = pack_spans(data, offs, lens, max_blocks)
        assert not one_pass
        assert np.array_equal(got.order, want.order) and np.array_equal(got.inverse_order, want.inverse_order)
        assert [(b.nblocks, b.count) for b in got.buckets] == [(b.nblocks, b.count) for b in want.buckets]
        assert all(np.array_equal(g.words, w.words) for g, w in zip(got.buckets, want.buckets))


@pytest.mark.parametrize("offs,lens", [((0, 90), (10, 20)), ((-1, 0), (10, 20)), ((0, 5), (10, -3))])
def test_pass_declines_spans_outside_their_chunk(offs, lens):
    data = np.ones(100, np.uint8)
    assert native_pack_flush([(data, np.array(offs, np.int64), np.array(lens, np.int64))], None, 2048) is None


def test_pass_rejects_a_permutation_of_another_size():
    data, offs, lens = _rndm(64)
    with pytest.raises(ValueError, match="permutation"):
        pack_flush([(data, offs, lens)], bit_reverse_indices(5), 2048)


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
ENGINE = [(8, 3, 45, 2), (8, 8, 37, 0), (6, 4, 40, 2), (6, 1, 23, 0)]


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

    def recording(self, chunks, group_flush):
        ran.append((phase[0], threading.current_thread() is threading.main_thread()))
        return real(self, chunks, group_flush)

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
        "from vk_merkle_roots_tpu_torch.packing import pack_flush, split_lines\n"
        "from vk_merkle_roots_tpu_torch.utils.bitmath import bit_reverse_indices\n"
        "d, o, l = split_lines(np.frombuffer(lib.native_rndm_stream(7, 1 << 16, 127), np.uint8))\n"
        "threads = lambda: len(os.listdir('/proc/self/task'))\n"
        "before = threads()\n"
        "for _ in range(3):\n"
        "    assert pack_flush([(d, o, l)], bit_reverse_indices(16), 2048)[1]\n"
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
