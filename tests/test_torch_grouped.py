"""The engine cases of ``tests/test_grouped.py`` that had no counterpart on
the port, run on the port's streaming engine on the CPU device against the
oracle: group-bitrev slices in steady state, a first partial append that
keeps the natural layout, proofs, grow-after-root, a journal round trip, the
layout's invisibility, the slice-OOM walk refused after a commit, and a
grouped flush merging sparse spans."""

import json

import numpy as np
import pytest
import torch

from tests.conftest import random_leaves
from vk_merkle_roots_tpu_torch import oracle
from vk_merkle_roots_tpu_torch.config import EngineConfig
from vk_merkle_roots_tpu_torch.models.cuda import CudaSha256D

torch.set_num_threads(1)


def _grouped(**kw):
    kw.setdefault("slice_log2", 6)
    kw.setdefault("batch_leaves", 16)  # a power of two: grouping on
    return CudaSha256D(device="cpu", config=EngineConfig(**kw))


@pytest.mark.parametrize("count", [16, 64, 80, 200, 257])
def test_engine_grouped_steady_state(count):
    """Aligned power-of-two batches: every flush is a grouped append, across
    slice boundaries and a ragged tail."""
    leaves = random_leaves(np.random.default_rng(count), count, maxlen=40)
    e = _grouped()
    assert e.AddMany(leaves)
    assert e._slice_grouped in (True, None)  # grouped, or the slice already reduced
    assert e.Root() == oracle.merkle_root(leaves).hex()


def test_engine_partial_first_append_stays_natural():
    """A slice whose first append is smaller than a group keeps the natural
    layout."""
    leaves = random_leaves(np.random.default_rng(7), 7, maxlen=40)
    e = _grouped()
    assert e.AddMany(leaves)
    assert e.Root() == oracle.merkle_root(leaves).hex()
    assert e._slice_grouped is False


def test_engine_grouped_proofs():
    """keep_digests snapshots un-permute group-bitrev storage; proofs verify
    for leaves in full slices, the grouped tail and its partial flush."""
    leaves = random_leaves(np.random.default_rng(104), 150, maxlen=40)
    e = _grouped(keep_digests=True)
    assert e.AddMany(leaves)
    root = bytes.fromhex(e.Root())
    assert root == oracle.merkle_root(leaves)
    for i in (0, 5, 63, 64, 127, 128, 149):
        assert oracle.verify_proof(oracle.leaf_hash(leaves[i]), e.Proof(i)) == root


def test_engine_grouped_grow_after_root():
    leaves = random_leaves(np.random.default_rng(116), 100, maxlen=40)
    e = _grouped()
    assert e.AddMany(leaves[:80])
    assert e.Root() == oracle.merkle_root(leaves[:80]).hex()
    assert e.AddMany(leaves[80:])
    assert e.Root() == oracle.merkle_root(leaves).hex()


def test_engine_grouped_journal_roundtrip(tmp_path):
    """Journal and resume with grouping on."""
    leaves = random_leaves(np.random.default_rng(125), 200, maxlen=40)
    path = str(tmp_path / "j.jsonl")
    e = _grouped(journal_path=path)
    assert e.AddMany(leaves)
    want = e.Root()
    assert want == oracle.merkle_root(leaves).hex()
    with open(path) as fh:
        rows = [json.loads(line) for line in fh]
    assert [r["slice"] for r in rows] == [0, 1, 2]
    e2 = _grouped()
    e2.PreloadSliceRoots([bytes.fromhex(r["root"]) for r in rows])
    assert e2.AddMany(leaves[192:])
    assert e2.Root() == want


def test_engine_grouped_matches_nongrouped():
    """The same stream through a grouped (power-of-two batch) and a natural
    (other batch) engine gives the same root: the layout is invisible."""
    leaves = random_leaves(np.random.default_rng(142), 300, maxlen=50)
    a, b = _grouped(batch_leaves=32), _grouped(batch_leaves=30)
    assert a.AddMany(leaves) and b.AddMany(leaves)
    assert a.Root() == b.Root() == oracle.merkle_root(leaves).hex()
    assert a._group_log2 == 5 and b._group_log2 is None


def test_slice_oom_degrade_refused_after_commit(monkeypatch):
    """Once a slice has completed, a later out-of-memory slice allocation
    cannot change the tree's shape: ingest fails soft, the height stays."""
    rng = np.random.default_rng(181)
    e = _grouped(slice_log2=5)
    assert e.AddMany(random_leaves(rng, 40, maxlen=30))
    assert e.Drain() and e._full_slices >= 1
    e._buf = None  # force a new allocation

    def fail_empty(*shape, **kw):
        raise torch.cuda.OutOfMemoryError("fake: no memory")

    monkeypatch.setattr(torch, "empty", fail_empty)
    monkeypatch.setattr(CudaSha256D, "_SLICE_FLOOR_LOG2", 4)
    assert e.AddMany(random_leaves(rng, 20, maxlen=30)) is False
    assert e.config.slice_log2 == 5


def test_merge_chunks_sparse_spans():
    """A grouped flush merging chunks whose spans lie sparse over a large
    shared buffer gives the oracle root."""
    buf = np.random.default_rng(205).integers(0, 256, size=1 << 20, dtype=np.uint8)
    offsets = np.array([0, 300_000, 600_000, 900_000, 50, 200_001, 700_007, 999_000], np.int64)
    lengths = np.array([10, 20, 30, 40, 11, 21, 31, 24], np.int64)
    e = _grouped(slice_log2=4, batch_leaves=8)
    assert e.AddSpans(buf, offsets[:4], lengths[:4])
    assert e.AddSpans(buf, offsets[4:], lengths[4:])
    leaves = [buf[int(o) : int(o + n)].tobytes() for o, n in zip(offsets, lengths)]
    assert e.Root() == oracle.merkle_root(leaves).hex()
