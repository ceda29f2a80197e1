"""The plain reference against a naive hashlib tree, and the frozen
generators."""

import hashlib

import numpy as np
import pytest

from portbench import gen_rndm, reference


def _h(b: bytes) -> bytes:
    return hashlib.sha256(hashlib.sha256(b).digest()).digest()


def _naive(leaves: list[bytes], slice_log2: int, leaf=_h) -> str:
    """The stated semantics, written out level by level."""

    def levels(level, n):
        for _ in range(n):
            level = [_h(level[i] + (level[i + 1] if i + 1 < len(level) else level[i])) for i in range(0, len(level), 2)]
        return level

    def natural(level):
        while len(level) > 1:
            level = levels(level, 1)
        return level[0]

    digests = [leaf(x) for x in leaves]
    cap = 1 << slice_log2
    slices = [digests[i : i + cap] for i in range(0, len(digests), cap)]
    if len(slices) == 1:
        return natural(slices[0]).hex()
    return natural([levels(s, slice_log2)[0] for s in slices]).hex()


def _stream(leaves: list[bytes]) -> bytes:
    return b"".join(x + b"\n" for x in leaves)


def _leaves(n: int, seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(32, 127, size=int(k), dtype=np.uint8)) for k in rng.integers(1, 130, size=n)]


COUNTS = [1, 2, 3, 7, 8, 9, 15, 16, 17, 31, 32, 33, 8 * 3 + 5, 8 * 4, 8 * 5 + 1]


@pytest.mark.parametrize("n", COUNTS)
@pytest.mark.parametrize("block_log2", [1, 2, 14])
def test_reference_matches_naive_tree(monkeypatch, n, block_log2):
    monkeypatch.setattr(reference, "BLOCK_LOG2", block_log2)
    leaves = _leaves(n, n)
    (root,) = reference.stream_roots([_stream(leaves)], 3)
    assert root == _naive(leaves, 3)


def test_reference_several_streams(monkeypatch):
    monkeypatch.setattr(reference, "BLOCK_LOG2", 2)
    pool = [_leaves(n, 100 + n) for n in (5, 29, 64, 70)]
    roots = reference.stream_roots([_stream(x) for x in pool], 4)
    assert roots == [_naive(x, 4) for x in pool]


def test_reference_skips_empty_lines_and_takes_a_last_line_without_newline():
    leaves = _leaves(11, 3)
    stream = b"\n".join(leaves[:5]) + b"\n\n" + b"\n".join(leaves[5:])
    assert reference.stream_roots([stream], 2) == [_naive(leaves, 2)]


@pytest.mark.parametrize("n", [1, 8, 29, 8 * 3 + 5, 1024])
def test_control_hashes_leaves_once_and_differs_from_reference(n):
    leaves = _leaves(n, n)
    control = reference.stream_roots([_stream(leaves)], 3, single_hash=True)
    assert control == [_naive(leaves, 3, leaf=lambda b: hashlib.sha256(b).digest())]
    assert control != reference.stream_roots([_stream(leaves)], 3)


def test_canonical_rndm_root():
    stream = gen_rndm.generate_glibc(1712489279, 1024, 127)
    assert stream.count(b"\n") == 1024
    (root,) = reference.stream_roots([stream], 20)
    assert root.startswith("050194bb")


def test_glibc_mode_is_the_ports_stream():
    from vk_merkle_roots_tpu_torch.tools.rndm import GlibcRand

    ours, theirs = gen_rndm.GlibcRand(987654321), GlibcRand(987654321)
    assert [ours.rand() for _ in range(2000)] == [theirs.rand() for _ in range(2000)]


@pytest.mark.parametrize("maxlen", [2, 127, 4096])
def test_numpy_stream(maxlen):
    a = gen_rndm.numpy_stream([2**31 + 11, 0], 3000, maxlen)
    assert a == gen_rndm.numpy_stream([2**31 + 11, 0], 3000, maxlen)
    assert a != gen_rndm.numpy_stream([2**31 + 11, 1], 3000, maxlen)
    lines = a.split(b"\n")
    assert lines[-1] == b"" and len(lines) == 3001
    lens = np.array([len(x) for x in lines[:-1]])
    assert lens.min() >= 1 and lens.max() <= maxlen - 1
    body = np.frombuffer(a.replace(b"\n", b""), np.uint8)
    assert body.min() >= 32 and body.max() <= 95
