"""The port's leaf hashing (vk_merkle_roots_tpu_torch.ops.leaf_hash) on the
CPU against the JAX package's leaf_hashes(backend="xla") and hashlib,
column for column, on exact, stream and host-routed leaves and on the
compact wire; and the kernel tables the wrappers build for a flush."""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from vk_merkle_roots_tpu.ops.leaf_hash import leaf_hashes as jax_leaf_hashes
from vk_merkle_roots_tpu.packing import pack_spans as jax_pack_spans
from vk_merkle_roots_tpu_torch import _build, oracle
from vk_merkle_roots_tpu_torch.ops import leaf_hash as lh
from vk_merkle_roots_tpu_torch.packing import FlushColumns, pack_flush, pack_spans, stream_capacity
from vk_merkle_roots_tpu_torch.utils.bitmath import bit_reverse_indices
from vk_merkle_roots_tpu_torch.utils.hexutil import words_to_digest

torch.set_num_threads(1)


def _spans(leaves):
    lengths = np.array([len(x) for x in leaves], np.int64)
    offsets = np.concatenate(([0], np.cumsum(lengths)[:-1])).astype(np.int64)
    return np.frombuffer(b"".join(leaves), np.uint8), offsets, lengths


def _leaves(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes() for n in lengths]


def _cols_np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _assert_oracle(cols: np.ndarray, leaves):
    assert [words_to_digest(cols[:, i]) for i in range(len(leaves))] == [
        oracle.leaf_hash(x) for x in leaves
    ]


@pytest.mark.parametrize(
    "name,lengths_fn,max_blocks",
    [
        # 1..4 blocks: several exact buckets, the packer reorders leaves.
        ("exact", lambda r: r.integers(1, 240, size=700), None),
        # Uniform block count: the packer's single-bucket identity fast path.
        ("uniform", lambda r: r.integers(56, 119, size=1500), None),
        # Exact + stream (9..13 blocks) + host-routed (> 12 blocks).
        ("mixed", lambda r: np.concatenate([r.integers(1, 120, 300), r.integers(520, 820, 40)]), 12),
    ],
)
def test_leaf_hashes_match_jax(name, lengths_fn, max_blocks):
    lengths = lengths_fn(np.random.default_rng(len(name)))
    np.random.default_rng(7).shuffle(lengths)
    leaves = _leaves(11, lengths)
    packed = pack_spans(*_spans(leaves), max_device_blocks=max_blocks)
    if name == "mixed":
        assert any(b.counts is not None for b in packed.buckets) and packed.host_spans is not None
    if name == "uniform":
        assert packed.order is packed.inverse_order
    got = lh.leaf_hashes(packed, "cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (8, len(leaves))
    jax_packed = jax_pack_spans(*_spans(leaves), max_device_blocks=max_blocks)
    want = np.asarray(jax_leaf_hashes(jax_packed, backend="xla"))[:, : len(leaves)]
    assert np.array_equal(_cols_np(got), want)
    _assert_oracle(_cols_np(got), leaves)


@pytest.mark.parametrize("reorder", [False, True])
def test_leaf_hashes_into_slice_buffer(reorder):
    """With out/offset the digests land in their column range only."""
    lengths = np.full(300, 70) if not reorder else np.random.default_rng(3).integers(1, 200, 300)
    leaves = _leaves(5, lengths)
    packed = pack_spans(*_spans(leaves))
    buf = torch.full((8, 1000), -7, dtype=torch.int32)
    view = lh.leaf_hashes(packed, "cpu", out=buf, offset=123)
    assert view.data_ptr() == buf[:, 123].data_ptr()
    _assert_oracle(_cols_np(buf[:, 123:423].contiguous()), leaves)
    assert bool((buf[:, :123] == -7).all()) and bool((buf[:, 423:] == -7).all())


def test_cpu_tensors_take_the_plain_path():
    leaves = _leaves(9, [10, 700, 20])
    packed = pack_spans(*_spans(leaves))
    _build.reset_counts()
    lh.leaf_hashes(packed, "cpu")
    assert _build.plain_calls["leaf_hash_exact"] == 1
    assert _build.plain_calls["leaf_hash_stream"] == 1
    assert not _build.launches


def test_stream_plain_stops_at_each_leafs_count():
    """A stream bucket's zero tail blocks past a leaf's count never enter
    its state: same digests as hashing each leaf alone."""
    leaves = _leaves(13, [824, 900, 1000, 1079])  # 14..17 blocks: one rung of 17
    packed = pack_spans(*_spans(leaves))
    (b,) = [b for b in packed.buckets if b.counts is not None]
    words = lh.to_device_words(b.words, "cpu")
    counts = torch.from_numpy(b.counts)
    got = lh.stream_hash_plain(words, counts, b.count)
    order = packed.order[: b.count]
    _assert_oracle(_cols_np(got), [leaves[i] for i in order])


def test_wrappers_reject_bad_input():
    packed = pack_spans(*_spans(_leaves(1, [30] * 10)))
    b = packed.buckets[0]
    words = lh.to_device_words(b.words, "cpu")
    out = torch.empty((8, 10), dtype=torch.int32)
    with pytest.raises(TypeError):
        lh.exact_hash_into(words.to(torch.int64), 1, 10, out, 0)
    with pytest.raises(ValueError):
        lh.exact_hash_into(words, 2, 10, out, 0)  # word count is 16, not 32
    with pytest.raises(ValueError):
        lh.exact_hash_into(words, 1, 10, out, 1)  # columns past the output
    with pytest.raises(ValueError):
        lh.exact_hash_into(words, 9, 10, out, 0)
    with pytest.raises(ValueError):
        lh.exact_hash_into(words[:, :, :4], 1, 10, out, 0)
    long = pack_spans(*_spans(_leaves(2, [600, 610])))
    sb = long.buckets[0]
    swords = lh.to_device_words(sb.words, "cpu")
    bad = torch.tensor([sb.nblocks + 1, 1], dtype=torch.int32)
    with pytest.raises(ValueError):
        lh.stream_hash_into(swords, bad, sb.nblocks, 2, torch.empty((8, 2), dtype=torch.int32), 0)
    # leaf_hashes checks the packer's counts on the host, before any upload.
    sb.counts = np.array([sb.nblocks + 1, 1], np.int32)
    with pytest.raises(ValueError, match="block counts"):
        lh.leaf_hashes(long, "cpu")


def _flush(seed, stream_blocks=(9, 22), n_exact=400, n_stream=24):
    """Leaves of 1..8 blocks and of ``stream_blocks`` blocks, shuffled."""
    rng = np.random.default_rng(seed)
    lo, hi = stream_blocks
    lengths = np.concatenate([rng.integers(1, 8 * 64 - 8, n_exact), rng.integers(lo * 64 - 8, hi * 64 - 8, n_stream)])
    rng.shuffle(lengths)
    return _leaves(seed + 1, lengths)


def test_launch_tables_longest_first_with_column_offsets():
    packed = pack_spans(*_spans(_flush(41)))
    exact, stream = lh.flush_buckets(packed, "cpu", base=5)
    cols = [b.col for b in exact + stream]
    assert cols == list(np.cumsum([5] + [b.count for b in exact + stream])[:-1])
    assert [b.nblocks for b in exact] == list(range(1, 9)) and len({b.nblocks for b in stream}) >= 3
    out = torch.empty((8, 10 + packed.count), dtype=torch.int32)
    for buckets, per_cta in ((exact, lh.EXACT_CTA_THREADS), (stream, 3)):
        ((table, ctas),) = lh.launch_tables(buckets, out, per_cta)
        order = sorted(buckets, key=lambda b: -b.nblocks)
        entries = [table.b[j] for j in range(table.n)]
        assert table.n == len(buckets) and table.leaves_per_cta == per_cta
        assert table.out == out.data_ptr() and table.ld == out.stride(0)
        assert [e.nblocks for e in entries] == [b.nblocks for b in order]
        assert [e.nblocks for e in entries] == sorted((e.nblocks for e in entries), reverse=True)
        assert [(e.count, e.out_col, e.words) for e in entries] == [(b.count, b.col, b.words.data_ptr()) for b in order]
        assert [bool(e.counts) for e in entries] == [b.counts is not None for b in order]
        starts = np.cumsum([0] + [-(-b.count // per_cta) for b in order])
        assert [e.cta_begin for e in entries] == list(starts[:-1]) and ctas == starts[-1]


def test_launch_tables_split_past_the_table_size():
    words = torch.zeros((1, 16 * 10, 8, 128), dtype=torch.int32)
    counts = torch.ones(1024, dtype=torch.int32)
    out = torch.empty((8, 4096), dtype=torch.int32)
    n = lh.MAX_TABLE_BUCKETS + 9
    buckets = [lh.LeafBucket(words, 10, 1 + i % 40, 40 * i, counts) for i in range(n)] + \
              [lh.LeafBucket(words, 10, 0, 0, counts)]  # empty buckets take no entry
    tables = lh.launch_tables(buckets, out, 1)
    assert [t.n for t, _ in tables] == [lh.MAX_TABLE_BUCKETS, 9]
    for table, ctas in tables:
        assert table.b[0].cta_begin == 0 and ctas == sum(table.b[j].count for j in range(table.n))
    assert ctypes.sizeof(lh.LeafTable) <= 4096  # a kernel's parameter space


@pytest.mark.parametrize("n,sms,want", [(0, 132, 1), (1, 132, 1), (528, 132, 1), (529, 132, 2), (1024, 132, 2),
                                        (16896, 132, 32), (10**6, 132, 32), (100, 1, 25)])
def test_stream_leaves_per_warp(n, sms, want):
    assert lh.stream_leaves_per_warp(n, sms) == want


@pytest.mark.parametrize("seed,stream_blocks", [(51, (9, 14)), (52, (9, 23)), (53, (20, 36))])
def test_buckets_into_match_jax(seed, stream_blocks):
    """A flush's exact buckets (1..8 blocks) and its stream rungs through
    exact_hash_buckets_into / stream_hash_buckets_into on the CPU (their
    plain versions), byte-exact against the JAX package's
    leaf_hashes(backend="xla") and hashlib."""
    leaves = _flush(seed, stream_blocks)
    packed = pack_spans(*_spans(leaves))
    exact, stream = lh.flush_buckets(packed, "cpu")
    assert len(exact) == 8 and len(stream) >= 2
    assert all(stream_capacity(int(b.counts.max())) == b.nblocks for b in stream)
    out = torch.full((8, packed.count), -1, dtype=torch.int32)
    _build.reset_counts()
    lh.exact_hash_buckets_into(exact, out)
    lh.stream_hash_buckets_into(stream, out)
    assert dict(_build.plain_calls) == {"leaf_hash_exact": 1, "leaf_hash_stream": 1} and not _build.launches
    got = _cols_np(out)[:, packed.inverse_order]
    want = np.asarray(jax_leaf_hashes(jax_pack_spans(*_spans(leaves)), backend="xla"))[:, : len(leaves)]
    assert np.array_equal(got, want)
    _assert_oracle(got, leaves)


def test_bucket_wrappers_reject_bad_tables():
    packed = pack_spans(*_spans(_flush(61)))
    exact, stream = lh.flush_buckets(packed, "cpu")
    out = torch.empty((8, packed.count), dtype=torch.int32)
    with pytest.raises(ValueError):
        lh.exact_hash_buckets_into(exact + stream[:1], out)  # a rung is no exact bucket
    with pytest.raises(ValueError):
        lh.stream_hash_buckets_into([stream[0]._replace(counts=None)], out)
    with pytest.raises(ValueError):
        lh.exact_hash_buckets_into([exact[0]._replace(col=packed.count)], out)  # columns past the output
    with pytest.raises(TypeError):
        lh.exact_hash_buckets_into(exact, out.to(torch.int64))
    bad = stream[0].counts.clone()
    bad[0] = stream[0].nblocks + 1
    with pytest.raises(ValueError, match="block counts"):
        lh.stream_hash_buckets_into([stream[0]._replace(counts=bad)], out)



# K1's compact wire form (ops/leaf_hash.py::wire_hash_into), its plain
# version on the CPU: every bucket edge, at every byte offset mod 4, leaves
# from two chunks, and columns scattered by the group bit reversal.
WIRE_EDGES = (1, 55, 56, 119, 120, 183, 184, 247, 248, 311, 312, 375, 376, 439, 440, 503)


def _wire_unit(lengths, seed, columns, parts=2):
    """A compact unit of leaves of ``lengths`` whose offsets step through
    every residue mod 4, read from ``parts`` chunks over one buffer."""
    lengths = np.asarray(lengths, np.int64)
    rng = np.random.default_rng(seed)
    gaps = np.arange(lengths.size) % 4 + 1  # a newline and 0..3 more bytes after each leaf
    offsets = np.concatenate(([0], np.cumsum(lengths + gaps)[:-1])).astype(np.int64)
    data = rng.integers(0, 256, int(offsets[-1] + lengths[-1] + 8), dtype=np.uint8)
    cuts = np.linspace(0, lengths.size, parts + 1).astype(int)
    chunks = [(data, offsets[a:b], lengths[a:b]) for a, b in zip(cuts, cuts[1:])]
    unit, wire = pack_flush(chunks, columns, 2048, lh.WireSlot("cpu"))
    assert wire
    return unit, [data[o : o + n].tobytes() for o, n in zip(offsets, lengths)]


WIRE_CASES = [
    # id, lengths, columns: every edge at every residue, natural from column 0
    ("edges", np.repeat(WIRE_EDGES, 4), FlushColumns(0)),
    # the same 64 leaves as one grouped flush, bit-reversed over its group
    ("edges-bitrev", np.repeat(WIRE_EDGES, 4), FlushColumns(64, bit_reverse_indices(6))),
    # rndm-like leaves as a partial flush into a grouped slice, over groups of 16
    ("partial-grouped", np.random.default_rng(3).integers(1, 127, 90), FlushColumns(37, bit_reverse_indices(4))),
]


@pytest.mark.parametrize("lengths,columns", [c[1:] for c in WIRE_CASES], ids=[c[0] for c in WIRE_CASES])
def test_wire_form_matches_jax(lengths, columns):
    """K1's compact form on the CPU: each leaf's digest at its column, the
    JAX package's leaf_hashes(backend="xla") and hashlib; every other column
    untouched."""
    unit, leaves = _wire_unit(lengths, len(lengths), columns)
    assert set(np.asarray(unit.offsets) % 4) == {0, 1, 2, 3}
    if len(lengths) == 64:
        assert [int(r) for r in unit.rows] == [8] * 8
    cols = columns.of(len(leaves))
    out = torch.full((8, int(cols.max()) + 9), -7, dtype=torch.int32)
    _build.reset_counts()
    assert lh.leaf_hashes(unit, "cpu", out=out) is out
    assert dict(_build.plain_calls) == {"leaf_hash_exact": 1} and not _build.launches
    got = _cols_np(out)[:, cols]
    want = np.asarray(jax_leaf_hashes(jax_pack_spans(*_spans(leaves)), backend="xla"))[:, : len(leaves)]
    assert np.array_equal(got, want)
    _assert_oracle(got, leaves)
    untouched = np.ones(out.shape[1], bool)
    untouched[cols] = False
    assert bool((out[:, torch.from_numpy(untouched)] == -7).all())


def test_wire_rows_out_of_range_are_clamped():
    """A row whose column is at or past the output's width is not written; a
    row whose bytes run past the region, or past its bucket, hashes the
    bytes clamped to both, as K4 clamps its counts."""
    unit, leaves = _wire_unit(np.repeat(WIRE_EDGES, 2), 5, FlushColumns(0))
    n = len(leaves)
    rows = {b: int(sum(unit.rows[: b - 1])) for b in (1, 2)}  # first row of buckets 1 and 2
    unit.columns[rows[1] + 1] = n + 3  # past the width
    unit.offsets[rows[1] + 2] = unit.byte_len - 3  # a 55-byte leaf past the region: 3 bytes left
    unit.lengths[rows[2]] = 60000  # past its bucket of 2 blocks: 119 bytes
    out = torch.full((8, n), -7, dtype=torch.int32)
    lh.leaf_hashes(unit, "cpu", out=out)
    cols = _cols_np(out)
    lost = int(unit.columns[rows[1] + 1])
    assert lost >= n and sum(bool((out[:, c] == -7).all()) for c in range(n)) == 1
    region = unit.region
    assert words_to_digest(cols[:, unit.columns[rows[1] + 2]]) == oracle.leaf_hash(region[-3:].tobytes())
    o = int(unit.offsets[rows[2]])
    assert words_to_digest(cols[:, unit.columns[rows[2]]]) == oracle.leaf_hash(region[o : o + 119].tobytes())


def test_wire_form_checks_its_unit_and_output():
    unit, _ = _wire_unit([10, 20, 30], 1, FlushColumns(0))
    out = torch.empty((8, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        lh.wire_hash_into(unit, out.to(torch.int64))
    with pytest.raises(ValueError):
        lh.wire_hash_into(unit, torch.empty((8, 6), dtype=torch.int32)[:, ::2])
    with pytest.raises(ValueError):
        lh.wire_hash_into(dataclasses.replace(unit, count=4), out)
    with pytest.raises(ValueError):
        lh.wire_hash_into(dataclasses.replace(unit, nbytes=unit.nbytes + 4), out)
