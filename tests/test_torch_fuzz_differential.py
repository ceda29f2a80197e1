"""The randomized differential sweep of ``tests/test_fuzz_differential.py``
on the port: the same seeds and generators, each root held equal three ways,
by the port's streaming engine on the CPU device (``CudaSha256D(device=
"cpu")``, the plain PyTorch paths), by the JAX engine (``TpuSha256D`` on its
``xla`` backend, same config) and by ``oracle.merkle_root``."""

import numpy as np
import pytest
import torch

from tests.conftest import random_leaves
from vk_merkle_roots_tpu.config import EngineConfig as JaxEngineConfig
from vk_merkle_roots_tpu.models.tpu import TpuSha256D
from vk_merkle_roots_tpu_torch import oracle
from vk_merkle_roots_tpu_torch.config import EngineConfig
from vk_merkle_roots_tpu_torch.models.cuda import CudaSha256D

torch.set_num_threads(1)

# Cuts of the JAX file's trials, made after every draw so each trial keeps
# its seed's config: the port's plain paths on the CPU cost ~40 ms a node
# level and ~15 ms a compression of a flush whatever its width, so a trial
# costs about its flushes and slices, and a long leaf its block count.  At
# the JAX file's sizes the slowest trial took ~17 s on one CPU thread (both
# engines); with these cuts every trial takes about 3 s or less.
MAX_LEAVES = 64  # short leaves kept per trial (the JAX file draws up to 499)
MAX_LONG = 1300  # bytes of a long leaf (the JAX file draws up to 3999: 63 blocks)
MAX_CHUNK = 30  # leaves of a churn chunk (the JAX file draws up to 89)


def _engines(**kw):
    """The port's engine on the CPU device and the JAX engine, one config."""
    return CudaSha256D(device="cpu", config=EngineConfig(**kw)), TpuSha256D(
        name="ref", config=JaxEngineConfig(backend="xla", **kw))


def _roots_agree(leaves, chunks=None, **kw):
    """Feed ``leaves`` to both engines (in one ``AddMany`` or in the given
    chunk sizes) and hold both roots against the oracle's."""
    want = oracle.merkle_root(leaves).hex()
    for e in _engines(**kw):
        if chunks is None:
            assert e.AddMany(leaves)
        else:
            i = 0
            for step in chunks:
                assert e.AddMany(leaves[i : i + step])
                i += step
        assert e.Root() == want, f"{type(e).__name__} {kw} n={len(leaves)}"


@pytest.mark.parametrize("trial", range(8))
def test_randomized_stream_all_engines_agree(trial):
    rng = np.random.default_rng(1000 + trial)
    n = int(rng.integers(1, 400))
    maxlen = int(rng.integers(2, 300))
    leaves = [
        rng.integers(0, 256, size=int(rng.integers(1, maxlen)), dtype=np.uint8).tobytes()
        for _ in range(n)
    ]
    # Long leaves on odd trials (stream rungs at the default
    # device_max_blocks), drawn as in the JAX file and cut to MAX_LONG bytes.
    if trial % 2:
        for i in rng.integers(0, n, size=3):
            leaves[int(i)] = rng.integers(0, 256, size=int(rng.integers(600, 4000)), dtype=np.uint8).tobytes()
    slice_log2 = int(rng.integers(3, 9))
    batch = int(rng.integers(5, 200))
    leaves = [x[:MAX_LONG] for k, x in enumerate(leaves) if k < MAX_LEAVES or len(x) >= 600]
    _roots_agree(leaves, slice_log2=slice_log2, batch_leaves=batch)


def test_pathological_lengths():
    """All leaves exactly at block boundaries, interleaved."""
    leaves = [bytes([i]) * [1, 55, 56, 64, 119, 120][i % 6] for i in range(60)]
    _roots_agree(leaves, slice_log2=4, batch_leaves=7)


def test_single_byte_leaves_large_count():
    leaves = [bytes([i & 0xFF]) for i in range(1000)]
    _roots_agree(leaves, slice_log2=7, batch_leaves=333)


@pytest.mark.parametrize("trial", range(6))
def test_randomized_grouped_stream(trial):
    """Pow-2 batches (group-bitrev storage) with randomized chunked ingest:
    chunk boundaries fall anywhere relative to groups, fuzzing the merge,
    the partial flush into a grouped slice and the mixed-layout paths."""
    rng = np.random.default_rng(7000 + trial)
    n = int(rng.integers(1, 500))
    leaves = [rng.integers(0, 256, size=int(rng.integers(1, 200)), dtype=np.uint8).tobytes() for _ in range(n)]
    slice_log2 = int(rng.integers(3, 8))
    batch = 1 << int(rng.integers(2, 7))
    chunks = []
    while sum(chunks) < n:
        chunks.append(int(rng.integers(1, 2 * batch)))
    _roots_agree(leaves[:MAX_LEAVES], chunks, slice_log2=slice_log2, batch_leaves=batch)


def test_pack_ahead_churn_fuzz(rng):
    """Random interleavings of AddMany / Drain / mid-stream Root / Reset
    across pack-ahead depths 0-3, both engines fed the same operations: the
    flush pipeline stays oracle-exact through every churn pattern."""
    for trial in range(6):
        depth = int(rng.integers(0, 4))
        kw = dict(slice_log2=int(rng.integers(4, 7)), batch_leaves=int(1 << rng.integers(3, 6)), pack_ahead=depth)
        engines = _engines(**kw)
        leaves: list[bytes] = []
        for _ in range(int(rng.integers(6, 14))):
            op = int(rng.integers(0, 10))
            if op < 6:
                chunk = random_leaves(rng, int(rng.integers(1, 90)), maxlen=50)[:MAX_CHUNK]
                leaves.extend(chunk)
                assert all(e.AddMany(chunk) for e in engines)
            elif op < 8:
                assert all(e.Drain() for e in engines)
            elif op == 8 and leaves:
                want = oracle.merkle_root(leaves).hex()
                assert [e.Root() for e in engines] == [want, want], (trial, kw, len(leaves))
            else:
                assert all(e.Reset() for e in engines)
                leaves = []
        if leaves:
            want = oracle.merkle_root(leaves).hex()
            assert [e.Root() for e in engines] == [want, want], (trial, kw)
