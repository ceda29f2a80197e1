"""The port's CUDA kernels against their plain PyTorch versions and hashlib,
on a CUDA card.  Every test here needs the card and nvcc and skips without
them; run on the card with

    python -m pytest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

This file imports no JAX and nothing of the JAX package."""

import json

import numpy as np
import pytest
import torch

from vk_merkle_roots_tpu_torch import _build, oracle
from vk_merkle_roots_tpu_torch.config import EngineConfig
from vk_merkle_roots_tpu_torch.models.cuda import CudaSha256D, load_digest_sidecars
from vk_merkle_roots_tpu_torch.ops import leaf_hash as lh
from vk_merkle_roots_tpu_torch.ops import merkle
from vk_merkle_roots_tpu_torch.ops import perf_probe as pp
from vk_merkle_roots_tpu_torch.ops import tree_reduce as tr
from vk_merkle_roots_tpu_torch.packing import FlushColumns, pack_flush, pack_spans, split_lines, stream_capacity
from vk_merkle_roots_tpu_torch.utils.bitmath import bit_reverse_indices
from vk_merkle_roots_tpu_torch.utils.hexutil import words_to_digest

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _spans(leaves):
    lengths = np.array([len(x) for x in leaves], np.int64)
    offsets = np.concatenate(([0], np.cumsum(lengths)[:-1])).astype(np.int64)
    return np.frombuffer(b"".join(leaves), np.uint8), offsets, lengths


def _leaves(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes() for n in lengths]


def _u32(t):
    return t.cpu().contiguous().numpy().view(np.uint32)


@pytest.mark.parametrize("max_blocks", [None, 12, 2048])
def test_leaf_hashes_kernels_match_plain_and_hashlib(cuda, max_blocks):
    rng = np.random.default_rng(1)
    lengths = np.concatenate([rng.integers(1, 500, 2500), rng.integers(520, 3000, 60)])
    leaves = _leaves(2, lengths)
    packed = pack_spans(*_spans(leaves), max_device_blocks=max_blocks)
    got = lh.leaf_hashes(packed, cuda)
    torch.cuda.synchronize()
    assert np.array_equal(_u32(got), _u32(lh.leaf_hashes(packed, "cpu")))
    assert [words_to_digest(_u32(got)[:, i]) for i in range(len(leaves))] == [oracle.leaf_hash(x) for x in leaves]


def test_exact_flush_in_one_launch(cuda):
    """Exact buckets of 1..8 blocks, as one flush packs them, hash in one K1
    launch, byte-exact against the plain version and hashlib."""
    rng = np.random.default_rng(21)
    leaves = _leaves(22, rng.integers(1, 8 * 64 - 8, 9000))
    packed = pack_spans(*_spans(leaves))
    exact, stream = lh.flush_buckets(packed, cuda)
    assert not stream and sorted(b.nblocks for b in exact) == list(range(1, 9))
    out = torch.full((8, packed.count), -1, dtype=torch.int32, device=cuda)
    _build.reset_counts()
    lh.exact_hash_buckets_into(exact, out)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"leaf_hash_exact": 1}
    plain = torch.full((8, packed.count), -1, dtype=torch.int32)
    lh.exact_hash_buckets_into(lh.flush_buckets(packed, "cpu")[0], plain)
    assert np.array_equal(_u32(out), _u32(plain))
    cols = _u32(out)[:, packed.inverse_order]
    assert [words_to_digest(cols[:, i]) for i in range(len(leaves))] == [oracle.leaf_hash(x) for x in leaves]


def test_every_stream_rung_in_one_launch(cuda):
    """One leaf on every stream rung up to the 2048-block device limit, and
    one rung of more leaves than 4 x SMs, hash in one K4 launch, byte-exact
    against hashlib everywhere and against the plain version on the rungs
    up to 109 blocks (the plain version costs ~4k tensor ops a block)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    caps, cap = [], 10
    while cap < 2048:
        caps.append(cap)
        cap = stream_capacity(cap + 1)
    caps.append(cap)  # the rung of 2048 blocks
    rng = np.random.default_rng(23)
    lengths = [min(c, 2048) * 64 - 9 - int(rng.integers(0, 40)) for c in caps]
    lengths += list(rng.integers(9 * 64 - 8, 10 * 64 - 9, 4 * sms + 77))  # 9..10 blocks: the rung of 10
    leaves = _leaves(24, lengths)
    packed = pack_spans(*_spans(leaves), max_device_blocks=2048)
    exact, stream = lh.flush_buckets(packed, cuda)
    assert not exact and packed.host_spans is None and [b.nblocks for b in stream] == caps
    assert stream[0].count > 4 * sms and min(b.count for b in stream) == 1
    assert len(stream) <= lh.MAX_TABLE_BUCKETS
    out = torch.full((8, packed.count), -1, dtype=torch.int32, device=cuda)
    _build.reset_counts()
    lh.stream_hash_buckets_into(stream, out)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"leaf_hash_stream": 1}
    cols = _u32(out)
    got = cols[:, packed.inverse_order]
    assert [words_to_digest(got[:, i]) for i in range(len(leaves))] == [oracle.leaf_hash(x) for x in leaves]
    small = [b for b in lh.flush_buckets(packed, "cpu")[1] if b.nblocks <= 109]
    plain = torch.full((8, packed.count), -1, dtype=torch.int32)
    lh.stream_hash_buckets_into(small, plain)
    for b in small:
        assert np.array_equal(cols[:, b.col : b.col + b.count], _u32(plain)[:, b.col : b.col + b.count])


# K1's compact wire form: every bucket edge at every byte offset mod 4, from
# two chunks, natural, grouped and a partial flush into a grouped slice.
WIRE_EDGES = (1, 55, 56, 119, 120, 183, 184, 247, 248, 311, 312, 375, 376, 439, 440, 503)
WIRE_CASES = [
    ("edges", np.repeat(WIRE_EDGES, 4), FlushColumns(0)),
    ("edges-bitrev", np.repeat(WIRE_EDGES, 64), FlushColumns(1024, bit_reverse_indices(10))),
    ("partial-grouped", np.random.default_rng(3).integers(1, 127, 5000), FlushColumns(37, bit_reverse_indices(12))),
]


def _wire_unit(lengths, seed, columns, slot):
    """A compact unit of leaves of ``lengths`` whose offsets step through
    every residue mod 4, read from two chunks over one buffer."""
    lengths = np.asarray(lengths, np.int64)
    gaps = np.arange(lengths.size) % 4 + 1
    offsets = np.concatenate(([0], np.cumsum(lengths + gaps)[:-1])).astype(np.int64)
    data = np.random.default_rng(seed).integers(0, 256, int(offsets[-1] + lengths[-1] + 8), dtype=np.uint8)
    half = lengths.size // 2
    chunks = [(data, offsets[:half], lengths[:half]), (data, offsets[half:], lengths[half:])]
    unit, wire = pack_flush(chunks, columns, 2048, slot)
    assert wire and set(np.asarray(unit.offsets) % 4) == {0, 1, 2, 3}
    return unit, [data[o : o + n].tobytes() for o, n in zip(offsets, lengths)]


@pytest.mark.parametrize("lengths,columns", [c[1:] for c in WIRE_CASES], ids=[c[0] for c in WIRE_CASES])
def test_wire_form_matches_plain_and_hashlib(cuda, lengths, columns):
    """K1's compact form in one launch from a page-locked slot: each digest
    at its column, byte-exact against the plain version and hashlib, every
    other column untouched."""
    slot = lh.WireSlot(cuda)
    unit, leaves = _wire_unit(lengths, len(lengths), columns, slot)
    assert slot.host.is_pinned()
    cols = columns.of(len(leaves))
    out = torch.full((8, int(cols.max()) + 9), -7, dtype=torch.int32, device=cuda)
    _build.reset_counts()
    lh.leaf_hashes(unit, cuda, out=out)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"leaf_hash_exact": 1} and not _build.plain_calls
    plain = torch.full(tuple(out.shape), -7, dtype=torch.int32)
    lh.wire_hash_plain(unit, plain)
    assert np.array_equal(_u32(out), _u32(plain))
    got = _u32(out)[:, cols]
    assert [words_to_digest(got[:, i]) for i in range(len(leaves))] == [oracle.leaf_hash(x) for x in leaves]


def test_wire_rows_out_of_range_are_clamped_on_the_card(cuda):
    """Rows whose column is past the output, whose bytes run past the
    region or whose length is past its bucket: the kernel clamps them as its
    plain version does, and writes nothing outside its output."""
    slot = lh.WireSlot(cuda)
    unit, leaves = _wire_unit(np.repeat(WIRE_EDGES, 8), 9, FlushColumns(0), slot)
    n = len(leaves)
    first = np.concatenate(([0], np.cumsum(unit.rows)[:-1]))
    unit.columns[first[0] + 1] = n + 3
    unit.columns[first[7]] = 1 << 31
    unit.offsets[first[1]] = unit.byte_len - 3
    unit.offsets[first[2]] = 1 << 30
    unit.lengths[first[3]] = 60000
    guard = 4096
    flat = torch.full((8 * n + 2 * guard,), -7, dtype=torch.int32, device=cuda)
    out = flat[guard : guard + 8 * n].view(8, n)
    lh.leaf_hashes(unit, cuda, out=out)
    torch.cuda.synchronize()
    assert bool((flat[:guard] == -7).all()) and bool((flat[guard + 8 * n :] == -7).all())
    plain = torch.full((8, n), -7, dtype=torch.int32)
    lh.wire_hash_plain(unit, plain)
    assert np.array_equal(_u32(out), _u32(plain))
    assert sum(bool((plain[:, c] == -7).all()) for c in range(n)) == 2


class _DelayedCopies(CudaSha256D):
    """The engine with ~10 ms of device work queued before each flush: the
    card falls behind the host, so a flush's copy out of its slot is still
    queued when the pack thread takes the slot back for a later flush."""

    def _append(self, unit):
        torch.cuda._sleep(20_000_000)
        super()._append(unit)


def test_engine_streams_twice_through_reused_page_locked_slots(cuda):
    """A 2^21+12345-leaf rndm-127 stream, twice on one engine with pack_ahead
    2: both roots are the oracle's, every flush took the compact wire, and
    the second stream allocates no page-locked memory."""
    from vk_merkle_roots_tpu_torch.native.lib import native_rndm_stream

    n = (1 << 21) + 12345
    stream = native_rndm_stream(1712489279, n, 127)
    data, offs, lens = split_lines(stream)
    want = oracle.merkle_root_sliced([data[o : o + x].tobytes() for o, x in zip(offs, lens)], 20).hex()

    def pinned_blocks() -> int:
        stats = torch.cuda.host_memory_stats()
        key = next((k for k in ("num_host_alloc", "allocations.allocated") if k in stats), None)
        assert key is not None, sorted(stats)
        return stats[key]

    e = _DelayedCopies(device=cuda, config=EngineConfig(slice_log2=20, batch_leaves=1 << 16, pack_ahead=2))
    counts = []
    for _ in range(2):
        for lo in range(0, n, 100_000):  # reads of ~6.4 MB, as the CLI's
            assert e.AddSpans(data, offs[lo : lo + 100_000], lens[lo : lo + 100_000])
        assert e.Root() == want
        stages = e.Stats()["stages"]
        assert stages["pack_one_pass"]["count"] == stages["pack"]["count"] == stages["upload"]["count"]
        torch.cuda.synchronize()
        counts.append(pinned_blocks())
        e.Reset()
    assert counts[1] == counts[0] and all(s.host.is_pinned() for s in e._slots)


@pytest.mark.parametrize("long_every", [0, 64])
def test_engine_one_leaf_launch_of_each_kind_per_flush(cuda, long_every):
    """The engine on the smoke's two kinds of stream (rndm 127 B leaves; one
    leaf in 64 of 1-8 KB), cut to 2^18 leaves with 2^16-leaf slices: at most
    one K1 and one K4 launch per packed flush it hashes."""
    from vk_merkle_roots_tpu_torch.native.lib import native_rndm_stream

    stream = native_rndm_stream(1712489279, 1 << 18, 127)
    lines = stream.split(b"\n")[:-1]
    if long_every:
        rng = np.random.default_rng(25)
        for i in range(0, len(lines), long_every):
            lines[i] = rng.integers(32, 127, int(rng.integers(1024, 8193)), dtype=np.uint8).tobytes()
        stream = b"\n".join(lines) + b"\n"
    _build.reset_counts()
    e = CudaSha256D(device=cuda, config=EngineConfig(slice_log2=16, batch_leaves=1 << 14))
    assert e.AddSpans(*split_lines(stream))
    assert e.Root() == oracle.merkle_root(lines).hex()
    flushes = e.Stats()["stages"]["map_dispatch"]["count"]
    assert 0 < _build.launches["leaf_hash_exact"] <= flushes
    assert (0 < _build.launches["leaf_hash_stream"] <= flushes) if long_every else not _build.launches["leaf_hash_stream"]
    assert not _build.plain_calls


@pytest.mark.parametrize("groups", [1, 2, 64])
def test_fold_level_kernel_matches_plain(cuda, groups):
    x = torch.from_numpy(np.random.default_rng(groups).integers(0, 2**32, (8, 4096), dtype=np.uint32).view(np.int32))
    assert np.array_equal(_u32(tr.fold_level(x.to(cuda), groups)), _u32(tr.fold_level_plain(x, groups)))


@pytest.mark.parametrize("log2n", [0, 1, 7, 10])
def test_tail_kernel_matches_oracle(cuda, log2n):
    nat = np.random.default_rng(log2n).integers(0, 2**32, (8, 1 << log2n), dtype=np.uint32)
    x = torch.from_numpy(np.ascontiguousarray(nat[:, bit_reverse_indices(log2n)]).view(np.int32))
    root = words_to_digest(_u32(tr.tail_reduce(x.to(cuda))))
    assert root == oracle.merkle_root_of_digests([words_to_digest(nat[:, i]) for i in range(1 << log2n)])


def _block_entries(cuda, log2ns, seed, bitrev):
    """Tail entries of random digests on the card, their CPU twins and each
    block's hashlib root; ``bitrev[k]`` says how block k is stored."""
    rng = np.random.default_rng(seed)
    entries, cpu, want = [], [], []
    for k, log2n in enumerate(log2ns):
        nat = rng.integers(0, 2**32, (8, 1 << log2n), dtype=np.uint32)
        want.append(oracle.merkle_root_of_digests([words_to_digest(nat[:, i]) for i in range(1 << log2n)]))
        cols = nat[:, bit_reverse_indices(log2n)] if bitrev[k] else nat
        x = torch.from_numpy(np.ascontiguousarray(cols).view(np.int32))
        cpu.append(tr.TailEntry(x, log2n, bitrev[k]))
        entries.append(tr.TailEntry(x.to(cuda), log2n, bitrev[k]))
    return entries, cpu, want


def _roots(out):
    return [words_to_digest(r) for r in _u32(out)]


@pytest.mark.parametrize("bitrev", [False, True])
def test_tail_blocks_every_size_in_one_launch(cuda, bitrev):
    """Blocks of 1..1024 digests, natural or bit-reversed, in one K3 launch:
    byte-exact against the plain version and hashlib."""
    entries, cpu, want = _block_entries(cuda, range(11), 11 + bitrev, [bitrev] * 11)
    _build.reset_counts()
    out = tr.tail_reduce_blocks(entries)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"tail_reduce": 1}
    assert np.array_equal(_u32(out), _u32(tr.tail_reduce_blocks_plain(cpu)))
    assert _roots(out) == want


@pytest.mark.parametrize("n_blocks,launches", [(20, 1), (40, 2)])
def test_tail_table_of_many_blocks(cuda, n_blocks, launches):
    """A table of 20 blocks of mixed sizes and layouts takes one launch; 40
    take two, past the table's 32 entries; both agree with the plain version
    and hashlib."""
    rng = np.random.default_rng(n_blocks)
    log2ns = [int(k) for k in rng.integers(0, 11, n_blocks)]
    entries, cpu, want = _block_entries(cuda, log2ns, n_blocks, [bool(b) for b in rng.integers(0, 2, n_blocks)])
    _build.reset_counts()
    out = tr.tail_reduce_blocks(entries)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"tail_reduce": launches}
    assert np.array_equal(_u32(out), _u32(tr.tail_reduce_blocks_plain(cpu)))
    assert _roots(out) == want


def test_ragged_tail_in_one_tail_launch(cuda):
    """The 12345-digest tail of smoke stream 1 (8192 + 4096 + 32 + 16 + 8 +
    1): two gathers, five K2 levels and one K3 launch, the slice root equal
    to hashlib's at its own height and at a phantom height."""
    nat = np.random.default_rng(12345).integers(0, 2**32, (8, 12345), dtype=np.uint32)
    raw = [words_to_digest(nat[:, i]) for i in range(12345)]
    cols = torch.from_numpy(nat.view(np.int32)).to(cuda)
    for height in (14, 16):
        _build.reset_counts()
        got = tr.slice_root(cols, 12345, height)
        assert dict(_build.launches) == {"fold_level": 5, "tail_reduce": 1}
        assert got == oracle.reduce_slice(raw, height)
    entries, _ = tr.ragged_entries(cols, 12345)
    cpu = [e._replace(cols=e.cols.cpu()) for e in entries]
    assert np.array_equal(_u32(tr.tail_reduce_blocks(entries)), _u32(tr.tail_reduce_blocks_plain(cpu)))


def test_grouped_slice_tail_reads_natural_roots(cuda):
    """A grouped slice's 16 group roots go to K3 in natural order: the group
    levels, then one tail launch, no gather."""
    log2n, k = 14, 10
    digs = np.random.default_rng(16).integers(0, 2**32, (1 << log2n, 8), dtype=np.uint32)
    g = 1 << k
    idx = np.arange(1 << log2n)
    store = np.empty_like(digs)
    store[(idx // g) * g + bit_reverse_indices(k)[idx % g]] = digs
    x = torch.from_numpy(np.ascontiguousarray(store.T).view(np.int32)).to(cuda)
    _build.reset_counts()
    root = words_to_digest(_u32(tr.reduce_grouped_body(x, log2n, k)))
    assert dict(_build.launches) == {"fold_level": k, "tail_reduce": 1}
    assert root == oracle.merkle_root_of_digests([words_to_digest(d) for d in digs])


def test_engine_ragged_tail_costs_one_tail_launch(cuda):
    """A ragged tail above host_tail_leaves reduces on the card in exactly
    one K3 launch."""
    from vk_merkle_roots_tpu_torch.native.lib import native_rndm_stream

    n = (1 << 14) + 12345
    stream = native_rndm_stream(1712489279, n, 127)
    lines = stream.split(b"\n")[:-1]
    e = CudaSha256D(device=cuda, config=EngineConfig(slice_log2=14, batch_leaves=1 << 12))
    assert e.AddSpans(*split_lines(stream))
    assert e.Drain()
    _build.reset_counts()
    assert e.Root() == oracle.merkle_root(lines).hex()
    assert _build.launches["tail_reduce"] == 1 and not _build.plain_calls


@pytest.mark.parametrize("batch", [256, 300])
def test_engine_on_the_card_launches_only_kernels(cuda, batch):
    rng = np.random.default_rng(batch)
    leaves = _leaves(3, np.where(rng.random(5000) < 0.02, rng.integers(600, 3000, 5000), rng.integers(1, 128, 5000)))
    _build.reset_counts()
    e = CudaSha256D(device=cuda, config=EngineConfig(slice_log2=11, batch_leaves=batch, host_tail_leaves=0))
    assert e.AddMany(leaves)
    assert e.Root() == oracle.merkle_root(leaves).hex()
    assert not _build.plain_calls
    assert all(_build.launches[k] > 0 for k in ("leaf_hash_exact", "leaf_hash_stream", "fold_level", "tail_reduce"))


@pytest.mark.parametrize("batch", [256, 300])
def test_journal_resume_and_proofs_on_the_card(cuda, tmp_path, batch):
    """keep_digests and the journal on the card: snapshots (grouped slices
    and a partial scatter with batch 256, natural with 300) give proofs
    that verify, the sidecars give a resume with the same root and proofs
    of the journaled prefix, and nothing runs on a plain path."""
    n = 5000
    rng = np.random.default_rng(batch + 1)
    leaves = _leaves(4, np.where(rng.random(n) < 0.02, rng.integers(600, 3000, n), rng.integers(1, 128, n)))
    want = oracle.merkle_root(leaves).hex()
    cfg = EngineConfig(slice_log2=10, batch_leaves=batch, keep_digests=True, journal_path=str(tmp_path / "j.jsonl"))
    _build.reset_counts()
    e = CudaSha256D(device=cuda, config=cfg)
    assert e.AddMany(leaves)
    assert e.Root() == want
    for i in (0, 5, 1023, 1024, 3000, 4100, n - 1):
        assert oracle.verify_proof(oracle.leaf_hash(leaves[i]), e.Proof(i)).hex() == want
    assert not _build.plain_calls
    kernels = ["leaf_hash_exact", "leaf_hash_stream", "tail_reduce"] + (["fold_level"] if batch == 256 else [])
    assert all(_build.launches[k] > 0 for k in kernels), dict(_build.launches)
    with open(cfg.journal_path) as fh:
        roots = [bytes.fromhex(json.loads(line)["root"]) for line in fh]
    assert len(roots) == n // 1024
    e2 = CudaSha256D(device=cuda, config=EngineConfig(slice_log2=10, batch_leaves=batch, keep_digests=True))
    e2.PreloadSliceRoots(roots, digests=load_digest_sidecars(cfg.journal_path, roots, 1024))
    assert e2.AddMany(leaves[len(roots) * 1024 :])
    assert e2.Root() == want
    for i in (5, 2047, n - 1):
        assert oracle.verify_proof(oracle.leaf_hash(leaves[i]), e2.Proof(i)).hex() == want
    assert not _build.plain_calls


def test_wrappers_raise_on_cuda(cuda):
    out = torch.empty((8, 16), dtype=torch.int32, device=cuda)
    words = torch.zeros((1, 16, 8, 128), dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        lh.exact_hash_into(words, 1, 16, out, 0)
    with pytest.raises(ValueError):
        lh.exact_hash_into(words.to(torch.int32), 1, 16, out.cpu(), 0)
    with pytest.raises(ValueError):
        tr.tail_reduce(torch.zeros((8, 2048), dtype=torch.int32, device=cuda))
    x = torch.zeros((8, 16), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tr.tail_reduce_blocks([tr.TailEntry(x, 4, False), tr.TailEntry(x.cpu(), 4, False)])
    with pytest.raises(ValueError):
        tr.tail_reduce_blocks([tr.TailEntry(x, 3, True)])


@pytest.mark.parametrize("name", ["alu_probe", "rot_probe"])
def test_probe_kernels_match_plain(cuda, name):
    x = torch.from_numpy(pp.probe_input(pp.ALU_PROBE_SEED, 2).view(np.int32))
    kernel, plain = {"alu_probe": (pp.alu_probe, pp.alu_probe_plain),
                     "rot_probe": (pp.rot_probe, pp.rot_probe_plain)}[name]
    _build.reset_counts()
    got = kernel(x.to(cuda))
    torch.cuda.synchronize()
    assert _build.launches[name] == 1
    assert np.array_equal(_u32(got), _u32(plain(x)))


@pytest.mark.parametrize("count", [1, 5, 64, 1000])
def test_merkle_root_device_on_the_card(cuda, count):
    rng = np.random.default_rng(count)
    leaves = _leaves(count, np.where(rng.random(count) < 0.05, rng.integers(600, 3000, count),
                                     rng.integers(1, 200, count)))
    _build.reset_counts()
    assert merkle.merkle_root_device(leaves, cuda) == oracle.merkle_root(leaves)
    assert not _build.plain_calls
    fn = merkle.fused_root_fn(1024, 2, cuda)
    words = merkle.example_words(1024, 64, count)
    root = words_to_digest(_u32(fn(lh.to_device_words(words, cuda))))
    assert root == oracle.merkle_root(merkle.example_leaves(1024, 64, count))


def _card_list():
    """Every card when there are two or more, else the one card named twice."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(n)] if n >= 2 else [torch.device("cuda", 0)] * 2


@pytest.mark.parametrize("sharded", [False, True])
def test_mesh_engine_on_the_cards(cuda, sharded):
    """MESH round robin and sharded on the card list: the native host root,
    K1 on every listed card, one gather a full slice when sharded, no plain
    path."""
    from vk_merkle_roots_tpu_torch.models.cpu import CpuSha256D
    from vk_merkle_roots_tpu_torch.models.mesh import MeshCudaSha256D
    from vk_merkle_roots_tpu_torch.native.lib import native_rndm_stream

    devices = _card_list()
    stream = native_rndm_stream(5, (1 << 14) + 777, 127)
    ref = CpuSha256D()
    ref.AddSpans(*split_lines(stream))
    _build.reset_counts()
    e = MeshCudaSha256D(devices, config=EngineConfig(slice_log2=12, batch_leaves=1 << 10, sharded_reduce=sharded,
                                                     host_tail_leaves=0))
    assert e.AddSpans(*split_lines(stream))
    assert e.Root() == ref.Root()
    assert not _build.plain_calls
    assert all(_build.device_launches["leaf_hash_exact", d.index] > 0 for d in devices)
    if sharded:
        ndev = 1 << (len(devices).bit_length() - 1)
        assert e._mesh.gathers == [(ndev, 8)] * 4 and e._slice_rr == 0
    else:
        assert e._slice_rr == 4


def test_sharded_root_gather_audit_on_the_cards(cuda):
    """The sharded root of 2^16 leaves over the card list's power-of-two
    prefix: the oracle root, one gather of ndev x 32 B, K1-K3 on every card."""
    from vk_merkle_roots_tpu_torch.packing import pack_leaves
    from vk_merkle_roots_tpu_torch.parallel import mesh as pm
    from vk_merkle_roots_tpu_torch.parallel.distributed import demo_leaves

    devices = _card_list()
    devices = devices[: 1 << (len(devices).bit_length() - 1)]
    leaves = demo_leaves(7, 1 << 16, 24)
    mesh = pm.make_mesh(devices)
    _build.reset_counts()
    fn = pm.make_sharded_root_fn(mesh, 1 << 16, 1)
    root = words_to_digest(_u32(fn(pm.shard_words(mesh, pack_leaves(leaves).buckets[0].words))))
    assert root == oracle.merkle_root(leaves)
    assert mesh.gathers == [(len(devices), 8)] and not _build.plain_calls
    for name in ("leaf_hash_exact", "fold_level", "tail_reduce"):
        assert all(_build.device_launches[name, d.index] > 0 for d in devices)


def test_randomized_differential_on_the_card(cuda):
    """The first 8 trials of chip_smoke.py's phase 9 (tools/fuzz.py): the
    14-block device tail, the cluster tail, MESH round robin and sharded over
    the card list, and four drawn trials; every root the native host root,
    K1-K4 launched and no plain path run."""
    from vk_merkle_roots_tpu_torch.tools import fuzz

    summary = fuzz.run([fuzz.draw_trial(i) for i in range(8)], _card_list(), log=lambda line: None)
    assert summary["trials"] == 8 and summary["mismatches"] == 0, summary["failures"]
    assert not _build.plain_calls
    assert all(_build.launches[k] > 0 for k in ("leaf_hash_exact", "leaf_hash_stream", "fold_level", "tail_reduce"))
    assert summary["tail_table_max"] >= 14 and summary["tail_cluster_launches"] > 0
