"""The port's tree reduction (vk_merkle_roots_tpu_torch.ops.tree_reduce) on
the CPU against the JAX package (rolled XLA path) and the oracle: every fold
level, flat and grouped, the tail, perfect blocks, ragged slices with the
phantom-full-height rule, group-bitrev slices, and the one-launch tail's
tables of natural-order and bit-reversed blocks."""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk_merkle_roots_tpu import oracle
from vk_merkle_roots_tpu.ops import tree_reduce as jtr
from vk_merkle_roots_tpu_torch import _build
from vk_merkle_roots_tpu_torch.ops import tree_reduce as ttr
from vk_merkle_roots_tpu_torch.utils.bitmath import bit_reverse_indices
from vk_merkle_roots_tpu_torch.utils.hexutil import words_to_digest

torch.set_num_threads(1)


def _digests(seed, n):
    """(8, n) uint32 word-major columns + the digests as bytes."""
    d = np.random.default_rng(seed).integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    return np.ascontiguousarray(d.T), [words_to_digest(d[i]) for i in range(n)]


def _t(cols: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(cols).view(np.int32))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


@pytest.mark.parametrize("n", [2, 8, 64, 2048])
def test_fold_level_matches_jax(n):
    cols, _ = _digests(n, n)
    want = np.asarray(jtr._fold_level_xla_jit(jnp.asarray(cols)))
    assert np.array_equal(_np(ttr.fold_level(_t(cols))), want)


@pytest.mark.parametrize("n,groups", [(64, 4), (256, 16), (32, 16)])
def test_grouped_fold_level_matches_jax_per_group(n, groups):
    cols, _ = _digests(n + groups, n)
    got = _np(ttr.fold_level(_t(cols), groups=groups))
    m = n // groups
    want = np.concatenate(
        [np.asarray(jtr._fold_level_xla_jit(jnp.asarray(cols[:, g * m : (g + 1) * m]))) for g in range(groups)],
        axis=1,
    )
    assert np.array_equal(got, want)


def test_fold_level_rejects_bad_shapes():
    x = torch.zeros((8, 12), dtype=torch.int32)
    with pytest.raises(ValueError):
        ttr.fold_level(x)  # not a power of two
    with pytest.raises(ValueError):
        ttr.fold_level(torch.zeros((8, 8), dtype=torch.int32), groups=8)
    with pytest.raises(ValueError):
        ttr.fold_level(torch.zeros((8, 8), dtype=torch.int64))
    with pytest.raises(ValueError):
        ttr.tail_reduce(torch.zeros((8, 2048), dtype=torch.int32))


@pytest.mark.parametrize("log2n", [0, 1, 5, 10])
def test_tail_reduce_matches_oracle(log2n):
    n = 1 << log2n
    cols, raw = _digests(40 + log2n, n)
    fold_input = cols[:, bit_reverse_indices(log2n)]
    got = words_to_digest(_np(ttr.tail_reduce(_t(fold_input))))
    assert got == oracle.merkle_root_of_digests(raw)


@pytest.mark.parametrize("log2n", [0, 1, 2, 3, 5, 8, 11])
def test_perfect_block(log2n):
    cols, raw = _digests(log2n, 1 << log2n)
    got = words_to_digest(_np(ttr.reduce_perfect_block(_t(cols), log2n)))
    assert got == oracle.merkle_root_of_digests(raw)
    want = np.asarray(jtr.reduce_perfect_block(jnp.asarray(cols), log2n, "xla"))
    assert got == words_to_digest(want)


@pytest.mark.parametrize("count,height", [(1, 3), (3, 2), (5, 3), (7, 3), (100, 7), (100, 9)])
def test_ragged_slice_phantom_height(count, height):
    cols, raw = _digests(count * 31 + height, count)
    got = ttr.slice_root(_t(cols), count, height)
    assert got == oracle.reduce_slice(raw, height)
    assert got == jtr.slice_root(jnp.asarray(cols), count, height, "xla")


@pytest.mark.parametrize("count", [1, 2, 3, 5, 6, 7, 9, 100, 255, 256, 257])
def test_plain_merkle_root(count):
    cols, raw = _digests(1000 + count, count)
    assert ttr.merkle_root_of_digest_cols(_t(cols), count) == oracle.merkle_root_of_digests(raw)


def test_slice_root_count_out_of_range():
    cols, _ = _digests(0, 5)
    with pytest.raises(ValueError):
        ttr.slice_root(_t(cols), 5, 2)
    with pytest.raises(ValueError):
        ttr.slice_root(_t(cols), 0, 2)


def _store_grouped(digs: np.ndarray, k: int) -> np.ndarray:
    """Natural (n, 8) digest words -> group-bitrev storage (n, 8)."""
    n, g = digs.shape[0], 1 << k
    idx = np.arange(n)
    store = np.empty_like(digs)
    store[(idx // g) * g + bit_reverse_indices(k)[idx % g]] = digs
    return store


@pytest.mark.parametrize("log2n,k", [(4, 2), (6, 6), (8, 4), (10, 10), (11, 8), (12, 9)])
def test_reduce_grouped_matches_jax_and_oracle(log2n, k):
    n = 1 << log2n
    digs = np.random.default_rng(log2n * 16 + k).integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    want = oracle.merkle_root_of_digests([words_to_digest(digs[i]) for i in range(n)])
    x = np.ascontiguousarray(_store_grouped(digs, k).T)
    got = words_to_digest(_np(ttr.reduce_grouped_body(_t(x), log2n, k)))
    assert got == want
    if log2n <= 8:
        # Larger grid points compile for seconds on the JAX side, whose own
        # tests (test_grouped.py) already hold it to the same oracle root.
        assert got == words_to_digest(np.asarray(jtr.reduce_grouped_block(x, log2n, k, "xla")))
    assert np.array_equal(_np(ttr.group_bitrev_to_natural(_t(x), log2n, k)), digs.T)


@pytest.mark.parametrize("log2n", [1, 4, 9, 10, 11])
def test_bitrev_fold_words(log2n):
    cols, _ = _digests(log2n, 1 << log2n)
    want = np.asarray(jtr.bitrev_fold_words(jnp.asarray(cols), log2n))
    assert np.array_equal(_np(ttr.bitrev_fold_words(_t(cols), log2n)), want)


def test_fold_accepts_column_slices():
    """A column range of a wider buffer (row stride > width) folds like a
    contiguous copy: the kernel takes the row stride as its leading dim."""
    cols, _ = _digests(3, 64)
    wide = _t(cols)
    assert np.array_equal(_np(ttr.fold_level(wide[:, 16:48])), _np(ttr.fold_level(wide[:, 16:48].contiguous())))


def test_combine_ragged_matches_oracle():
    _, raw = _digests(77, 13)  # 13 = 8 + 4 + 1
    blocks = [
        (oracle.merkle_root_of_digests(raw[:8]), 3),
        (oracle.merkle_root_of_digests(raw[8:12]), 2),
        (raw[12], 0),
    ]
    assert ttr.combine_ragged(blocks, 5) == oracle.reduce_slice(raw, 5)


# -- the one-launch tail (tail_reduce_blocks) through its plain version -------

@lru_cache(maxsize=None)
def _jax_block_root(seed: int, log2n: int) -> bytes:
    cols, _ = _digests(seed, 1 << log2n)
    return words_to_digest(np.asarray(jtr.reduce_perfect_block(jnp.asarray(cols), log2n, "xla")))


@pytest.mark.parametrize("log2n", range(11))
def test_tail_blocks_natural_and_bitrev_match_jax(log2n):
    """A table of one natural-order and one bit-reversed block of the same
    digests: both roots equal the JAX package's reduce_perfect_block and
    hashlib's."""
    cols, raw = _digests(500 + log2n, 1 << log2n)
    rev = np.ascontiguousarray(cols[:, bit_reverse_indices(log2n)])
    _build.reset_counts()
    got = ttr.tail_reduce_blocks([ttr.TailEntry(_t(cols), log2n, False), ttr.TailEntry(_t(rev), log2n, True)])
    assert dict(_build.plain_calls) == {"tail_reduce": 1} and not _build.launches
    want = _jax_block_root(500 + log2n, log2n)
    assert want == oracle.merkle_root_of_digests(raw)
    assert [words_to_digest(r) for r in _np(got)] == [want, want]


def _ragged_cases():
    for count in (3, 100, 1025 + 57, (1 << 12) + 57):
        k = int(count - 1).bit_length()
        for height in (k, k + 1, k + 2):
            yield count, height


@pytest.mark.parametrize("count,height", list(_ragged_cases()))
def test_ragged_tail_entries_match_jax(count, height):
    """The perfect blocks of a ragged slice (blocks above 1024 digests folded
    to 1024 first) in one table: each block root equals the JAX package's
    reduce_perfect_block, and the slice root its slice_root and the
    oracle's, at the slice's own height and above."""
    cols, raw = _digests(count + height, count)
    entries, heights = ttr.ragged_entries(_t(cols), count)
    assert heights == sorted(heights, reverse=True) and sum(1 << k for k in heights) == count
    assert all(e.bitrev == (k > ttr.TAIL_MAX_LOG2) and e.log2n == min(k, ttr.TAIL_MAX_LOG2)
               for e, k in zip(entries, heights))
    roots = _np(ttr.tail_reduce_blocks(entries))
    start = 0
    for row, k in zip(roots, heights):
        block = jnp.asarray(cols[:, start : start + (1 << k)])
        assert words_to_digest(row) == words_to_digest(np.asarray(jtr.reduce_perfect_block(block, k, "xla")))
        start += 1 << k
    got = ttr.slice_root(_t(cols), count, height)
    assert got == oracle.reduce_slice(raw, height)
    assert got == jtr.slice_root(jnp.asarray(cols), count, height, "xla")


def test_tail_tables_longest_first_flags_and_split():
    """The kernel's tables: blocks with the most digests first (stable), each
    with its output row, layout flag, pointer and leading dimension; 40
    blocks split into tables of 32 and 8."""
    rng = np.random.default_rng(7)
    wide = _t(rng.integers(0, 2**32, size=(8, 4096), dtype=np.uint32))
    entries = []
    for k in range(40):
        log2n = int(rng.integers(0, 11))
        entries.append(ttr.TailEntry(wide[:, 3 * k : 3 * k + (1 << log2n)], log2n, bool(k % 3 == 0)))
    out = torch.empty((len(entries), 8), dtype=torch.int32)
    tables = ttr.tail_tables(entries, out)
    assert [t.n for t in tables] == [32, 8]
    rows = [t.b[j] for t in tables for j in range(t.n)]
    order = sorted(range(40), key=lambda k: -entries[k].log2n)
    assert [r.out_row for r in rows] == order
    for r in rows:
        e = entries[r.out_row]
        assert (r.log2n, bool(r.bitrev), r.x, r.ld) == (e.log2n, e.bitrev, e.cols.data_ptr(), 4096)
    assert all(t.out == out.data_ptr() for t in tables)


def test_tail_reduce_blocks_rejects_bad_tables():
    x = torch.zeros((8, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        ttr.tail_reduce_blocks([])
    with pytest.raises(ValueError):
        ttr.tail_reduce_blocks([ttr.TailEntry(x, 3, False)])  # 16 columns are not 2^3
    with pytest.raises(ValueError):
        ttr.tail_reduce_blocks([ttr.TailEntry(torch.zeros((8, 2048), dtype=torch.int32), 11, True)])
    with pytest.raises(ValueError):
        ttr.tail_reduce_blocks([ttr.TailEntry(x.to(torch.int64), 4, False)])
    with pytest.raises(ValueError):
        ttr.tail_reduce_blocks([ttr.TailEntry(torch.zeros((8, 32), dtype=torch.int32)[:, ::2], 4, False)])
    with pytest.raises(ValueError):
        ttr.tail_reduce_blocks([ttr.TailEntry(torch.zeros((4, 16), dtype=torch.int32), 4, False)])


def test_tail_table_matches_csrc():
    """TailBlock and TailTable of ops/tree_reduce.py declare the fields of
    csrc/tail_reduce.cuh's, in order."""
    import re
    from pathlib import Path

    text = re.sub(r"//[^\n]*", "", (Path(ttr.__file__).resolve().parent.parent / "csrc" / "tail_reduce.cuh").read_text())
    structs = {name: re.findall(r"(\w+)(?:\[\w+\])?;", body) for name, body in re.findall(r"struct (\w+) \{(.*?)\};", text, re.S)}
    assert structs["TailBlock"] == [f for f, _ in ttr._TailBlock._fields_]
    assert structs["TailTable"] == [f for f, _ in ttr.TailTable._fields_]


@pytest.mark.parametrize("log2n,k", [(4, 2), (6, 6), (8, 4), (10, 10), (11, 8), (12, 9)])
def test_reduce_grouped_runs_no_gather(monkeypatch, log2n, k):
    """A grouped slice's group roots reach the tail kernel's wrapper as one
    natural-order block, with no index_select before it (the plain version
    behind the wrapper bit-reverses on the CPU; the kernel reads natural
    order as it lies); the root is the JAX package's and the oracle's."""
    n = 1 << log2n
    digs = np.random.default_rng(log2n * 16 + k).integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    x = np.ascontiguousarray(_store_grouped(digs, k).T)
    gathers, tables = [], []
    index_select, blocks = torch.Tensor.index_select, ttr.tail_reduce_blocks

    def counted(self, *args, **kwargs):
        gathers.append(1)
        return index_select(self, *args, **kwargs)

    def tail(entries):
        tables.append([(e.log2n, e.bitrev) for e in entries])
        monkeypatch.setattr(torch.Tensor, "index_select", index_select)
        return blocks(entries)

    monkeypatch.setattr(ttr, "tail_reduce_blocks", tail)
    monkeypatch.setattr(torch.Tensor, "index_select", counted)
    got = words_to_digest(_np(ttr.reduce_grouped_body(_t(x), log2n, k)))
    monkeypatch.undo()
    assert not gathers
    assert tables == [[(log2n - k, False)]] if k < log2n else tables == [[(log2n, True)]]
    assert got == oracle.merkle_root_of_digests([words_to_digest(digs[i]) for i in range(n)])
    if log2n <= 8:
        assert got == words_to_digest(np.asarray(jtr.reduce_grouped_block(x, log2n, k, "xla")))
