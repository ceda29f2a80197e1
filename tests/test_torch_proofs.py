"""The oracle and tool cases of ``tests/test_proofs.py`` on the port's
``oracle.merkle_proof`` and ``tools/verify.py``, each proof also held equal
to the JAX package's.  The engine cases have their counterparts in
``tests/test_torch_journal.py`` and ``tests/test_torch_host.py``."""

import json

import numpy as np
import pytest

from tests.conftest import random_leaves
from vk_merkle_roots_tpu import oracle as jax_oracle
from vk_merkle_roots_tpu_torch import oracle
from vk_merkle_roots_tpu_torch.tools import verify


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 64, 100])
def test_oracle_proof_roundtrip_every_index(n):
    leaves = random_leaves(np.random.default_rng(n), n, maxlen=40)
    root = oracle.merkle_root(leaves)
    for i in range(n):
        path = oracle.merkle_proof(leaves, i)
        assert path == jax_oracle.merkle_proof(leaves, i)
        assert oracle.verify_proof(oracle.leaf_hash(leaves[i]), path) == root


def test_proof_with_phantom_height():
    digests = [oracle.leaf_hash(x) for x in random_leaves(np.random.default_rng(23), 5, maxlen=20)]
    root = oracle.reduce_slice(digests, 4)
    for i in range(5):
        path = oracle.merkle_proof_of_digests(digests, i, height=4)
        assert len(path) == 4
        assert oracle.verify_proof(digests[i], path) == root


def test_proof_rejects_bad_index():
    with pytest.raises(IndexError):
        oracle.merkle_proof([b"a", b"b"], 2)


def test_tampered_proof_fails():
    leaves = random_leaves(np.random.default_rng(37), 8, maxlen=20)
    root = oracle.merkle_root(leaves)
    path = oracle.merkle_proof(leaves, 3)
    bad = [(bytes(32), path[0][1])] + path[1:]
    assert oracle.verify_proof(oracle.leaf_hash(leaves[3]), bad) != root


def test_verify_tool_roundtrip(tmp_path, capsys):
    """A proof record as the CLI prints it, through the port's verify tool:
    the valid path is accepted, a tampered root and a wrong leaf refused."""
    leaves = random_leaves(np.random.default_rng(68), 9, maxlen=30)
    root = oracle.merkle_root(leaves)
    record = {"leaf_index": 4, "root": root.hex(),
              "path": [{"sibling": s.hex(), "side": side} for s, side in oracle.merkle_proof(leaves, 4)]}
    pj = tmp_path / "proof.json"
    pj.write_text(json.dumps(record))
    assert verify.main([str(pj), "--leaf-hex", leaves[4].hex()]) == 0
    assert capsys.readouterr().out.startswith(f"OK {root.hex()}")
    pj.write_text(json.dumps(dict(record, root="00" * 32)))
    assert verify.main([str(pj), "--leaf-hex", leaves[4].hex()]) == 1
    pj.write_text(json.dumps(record))
    assert verify.main([str(pj), "--leaf-hex", leaves[5].hex()]) == 1
