"""The hypothesis properties of ``tests/test_properties.py`` on the port:
slice decomposition is invisible (through the port's streaming engine, held
against the JAX engine and the oracle), proofs verify for every index
(through the port's oracle and ``CudaSha256D(keep_digests=True).Proof``),
``pack_spans`` matches scalar padding (through ``Bucket.leaf_words``) and the
phantom height equals padding with self-pairs.

Every property runs derandomized with no example database, so each run draws
the same examples and counts the same passes."""

import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from vk_merkle_roots_tpu.config import EngineConfig as JaxEngineConfig
from vk_merkle_roots_tpu.models.tpu import TpuSha256D
from vk_merkle_roots_tpu_torch import oracle
from vk_merkle_roots_tpu_torch.config import EngineConfig
from vk_merkle_roots_tpu_torch.models.cuda import CudaSha256D
from vk_merkle_roots_tpu_torch.packing import pack_spans, reference_padded_words

torch.set_num_threads(1)

leaf = st.binary(min_size=0, max_size=300)


def fixed(max_examples: int):
    return settings(max_examples=max_examples, deadline=None, derandomize=True, database=None)


@fixed(40)
@given(st.lists(leaf, min_size=1, max_size=64), st.integers(1, 7), st.sampled_from([0, 8192]))
def test_slice_decomposition_invisible(leaves, slice_log2, host_tail):
    want = oracle.merkle_root(leaves)
    assert oracle.merkle_root_sliced(leaves, slice_log2) == want
    kw = dict(slice_log2=slice_log2, batch_leaves=8, host_tail_leaves=host_tail)
    ours = CudaSha256D(device="cpu", config=EngineConfig(**kw))
    ref = TpuSha256D(name="ref", config=JaxEngineConfig(backend="xla", **kw))
    assert ours.AddMany(leaves) and ref.AddMany(leaves)
    assert ours.Root() == ref.Root() == want.hex()


@fixed(40)
@given(st.lists(leaf, min_size=1, max_size=32))
def test_proofs_verify_for_every_index(leaves):
    root = oracle.merkle_root(leaves)
    e = CudaSha256D(device="cpu", config=EngineConfig(slice_log2=3, batch_leaves=4, keep_digests=True))
    assert e.AddMany(leaves) and e.Root() == root.hex()
    for i in range(len(leaves)):
        digest = oracle.leaf_hash(leaves[i])
        assert oracle.verify_proof(digest, oracle.merkle_proof(leaves, i)) == root
        assert oracle.verify_proof(digest, e.Proof(i)) == root


@fixed(40)
@given(st.lists(leaf, min_size=1, max_size=40), st.integers(1, 16))
def test_pack_spans_matches_scalar_padding(leaves, max_device_blocks):
    lengths = np.array([len(x) for x in leaves], np.int64)
    offsets = np.concatenate(([0], np.cumsum(lengths)[:-1]))
    data = np.frombuffer(b"".join(leaves), np.uint8) if lengths.sum() else np.zeros(0, np.uint8)
    packed = pack_spans(data, offsets, lengths, max_device_blocks=max_device_blocks)
    # Each leaf's padded words from its bucket row, via order, against the
    # scalar padding; host-routed leaves carry no words.
    row = 0
    rows_by_leaf = {}
    for b in packed.buckets:
        for r in range(b.count):
            rows_by_leaf[int(packed.order[row])] = b.leaf_words(r)
            row += 1
    for i, lf in enumerate(leaves):
        want_blocks = (len(lf) + 9 + 63) // 64
        if want_blocks > max_device_blocks:
            assert i not in rows_by_leaf
        else:
            # Exact buckets hold exactly the padded message; stream rungs
            # zero-extend the row to the rung's capacity.
            want = reference_padded_words(lf)
            got = rows_by_leaf[i]
            np.testing.assert_array_equal(got[: want.size], want)
            assert not got[want.size :].any()
    if packed.host_spans is not None:
        _, _, hlens = packed.host_spans
        long_idx = [i for i, lf in enumerate(leaves) if (len(lf) + 9 + 63) // 64 > max_device_blocks]
        assert list(hlens) == [len(leaves[i]) for i in long_idx]


@fixed(30)
@given(st.lists(leaf, min_size=1, max_size=24), st.integers(0, 6))
def test_phantom_height_equals_padding_with_self_pairs(leaves, extra):
    """reduce_slice(digests, height) == the ragged count's root raised
    ``extra`` phantom levels by self-pairing."""
    digests = [oracle.leaf_hash(x) for x in leaves]
    base = (len(digests) - 1).bit_length()
    want = oracle.merkle_root_of_digests(digests)
    for _ in range(extra):
        want = oracle.node_hash(want, want)
    assert oracle.reduce_slice(digests, base + extra) == want
