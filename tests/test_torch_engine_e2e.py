"""The cases of ``tests/test_engine_e2e.py`` that had no counterpart on the
port, run on the port's streaming engine on the CPU device against the
oracle: the empty and one-leaf streams, grow-after-root, multi-slice streams,
bulk spans, long leaves, the leaf-size refusal, stats, an idempotent
``Root()``, the host pending budget, tiny budgets, pack-ahead depths, the
device-side ragged tail, and the automatic slice height of ``test_cli.py``."""

import numpy as np
import pytest
import torch

from tests.conftest import random_leaves
from vk_merkle_roots_tpu_torch import oracle
from vk_merkle_roots_tpu_torch.config import EngineConfig
from vk_merkle_roots_tpu_torch.constants import MAX_LEAF_BYTES
from vk_merkle_roots_tpu_torch.models.cpu import CpuSha256D
from vk_merkle_roots_tpu_torch.models.cuda import CudaSha256D

torch.set_num_threads(1)


def _engine(slice_log2=6, batch_leaves=50, **kw):
    return CudaSha256D(device="cpu", config=EngineConfig(slice_log2=slice_log2, batch_leaves=batch_leaves, **kw))


def test_empty_stream():
    assert _engine().Root() == ""
    assert CpuSha256D().Root() == ""


def test_single_leaf():
    e = _engine()
    assert e.Add(b"hello")
    assert e.Root() == oracle.merkle_root([b"hello"]).hex()


@pytest.mark.parametrize("n1,n2", [(3, 4), (70, 5), (100, 200), (64, 64), (130, 1)])
def test_grow_after_root(n1, n2):
    """Root(), more leaves, Root() again: the provisional ragged tail is
    reopened, not frozen."""
    leaves = random_leaves(np.random.default_rng(n1 * 1000 + n2), n1 + n2, maxlen=60)
    e = _engine()
    assert e.AddMany(leaves[:n1])
    assert e.Root() == oracle.merkle_root(leaves[:n1]).hex()
    assert e.AddMany(leaves[n1:])
    assert e.Root() == oracle.merkle_root(leaves).hex()


@pytest.mark.parametrize("n", [1, 2, 63, 64, 65, 200, 333])
def test_multi_slice_stream_matches_oracle(n):
    """Fewer, as many and more leaves than one 64-leaf slice, ragged too."""
    leaves = random_leaves(np.random.default_rng(n), n, maxlen=100)
    e = _engine()
    assert e.AddMany(leaves)
    assert e.Root() == oracle.merkle_root(leaves).hex()


def test_addspans_bulk():
    leaves = random_leaves(np.random.default_rng(70), 150, maxlen=60)
    lengths = np.array([len(x) for x in leaves])
    offsets = np.concatenate(([0], np.cumsum(lengths)[:-1]))
    e = _engine()
    assert e.AddSpans(np.frombuffer(b"".join(leaves), np.uint8), offsets, lengths)
    assert e.Root() == oracle.merkle_root(leaves).hex()


def test_long_leaves_route_to_host_hasher():
    """Leaves past device_max_blocks hash on the host but land in stream
    order.  The JAX case keeps the default bound, under which its 600 B to
    70 KB leaves take the stream kernel; here the bound is 16 blocks, so
    they take the host hasher the test is named for (the 70 KB leaf on the
    plain stream path would cost ~15 s)."""
    rng = np.random.default_rng(112)
    small = random_leaves(rng, 40, maxlen=100)
    big = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes() for n in (600, 5_000, 70_000)]
    leaves = small[:5] + big[:1] + small[5:20] + big[1:2] + small[20:35] + big[2:] + small[35:]
    e = _engine(slice_log2=5, batch_leaves=16, device_max_blocks=16)
    assert e.AddMany(leaves)
    assert e.Root() == oracle.merkle_root(leaves).hex()


def test_all_leaves_long():
    rng = np.random.default_rng(125)
    leaves = [rng.integers(0, 256, size=1000, dtype=np.uint8).tobytes() for _ in range(10)]
    e = _engine()
    assert e.AddMany(leaves)
    assert e.Root() == oracle.merkle_root(leaves).hex()


def test_oversized_leaf_rejected():
    e = _engine()
    # The span is made without allocating 512 MB.
    assert not e.AddSpans(np.zeros(1, np.uint8), np.zeros(1, np.int64), np.array([MAX_LEAF_BYTES + 1]))


def test_stats_shape():
    e = _engine()
    e.AddMany(random_leaves(np.random.default_rng(149), 80, maxlen=30))
    e.Root()
    stats = e.Stats()
    assert stats["leaves"] == 80
    assert "stages" in stats and "pack" in stats["stages"]


def test_root_is_idempotent():
    """Root() may be called again without folding the ragged tail twice."""
    leaves = random_leaves(np.random.default_rng(158), 200, maxlen=40)  # 3 full 64-leaf slices and a tail
    e = _engine()
    e.AddMany(leaves)
    first = e.Root()
    assert first == oracle.merkle_root(leaves).hex()
    assert e.Root() == first
    assert e.Root() == first


def test_host_pending_budget_bounds_queue():
    """The host pending queue never holds more than host_pending_bytes when
    AddSpans returns: a tiny budget forces extra flushes, the root stays."""
    leaves = random_leaves(np.random.default_rng(239), 400, maxlen=64)
    e = _engine(batch_leaves=1 << 12, batch_bytes=64 << 20, host_pending_bytes=512)
    for i in range(0, 400, 40):
        assert e.AddMany(leaves[i : i + 40])
        assert e._pending.nbytes <= 512
    assert e.Root() == oracle.merkle_root(leaves).hex()


@pytest.mark.parametrize("trial", range(6))
def test_tiny_budgets_fuzz(trial):
    """Tiny slice, batch and host budgets compose to the oracle root.  The
    JAX case draws up to 259 leaves; they are cut to 80 here, as a flush of
    a leaf or two costs the plain path ~40 ms."""
    rng = np.random.default_rng(260 + trial)
    n = int(rng.integers(1, 260))
    leaves = random_leaves(rng, n, maxlen=48)[:80]
    cfg = EngineConfig(
        slice_log2=int(rng.integers(2, 7)),
        batch_leaves=int(rng.integers(2, 60)),
        batch_bytes=int(rng.integers(64, 4096)),
        host_pending_bytes=int(rng.integers(32, 2048)),
    )
    e = CudaSha256D(device="cpu", config=cfg)
    step = max(1, len(leaves) // 7)
    for i in range(0, len(leaves), step):
        assert e.AddMany(leaves[i : i + step])
    assert e.Root() == oracle.merkle_root(leaves).hex(), f"trial {trial}: {cfg}"


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_pack_ahead_depths_match_oracle(depth):
    """Inline (0), single (1) and deep (3) pack-ahead give the oracle root
    over a multi-slice stream with a ragged tail and chunks that straddle
    batches and slices, and again after Reset()."""
    leaves = random_leaves(np.random.default_rng(281), 700, maxlen=60)
    e = _engine(slice_log2=7, batch_leaves=64, pack_ahead=depth)
    for lo in range(0, 700, 37):
        assert e.AddMany(leaves[lo : lo + 37])
    assert e.Root() == oracle.merkle_root(leaves).hex()
    assert e.Reset()
    assert e.AddMany(leaves[:10])
    assert e.Root() == oracle.merkle_root(leaves[:10]).hex()


@pytest.mark.parametrize("slice_log2", [6, 10])
def test_device_tail_finalize_matches_oracle(slice_log2):
    """host_tail_leaves=0 pins the device-side ragged tail: a multi-slice
    ragged tail (2^6) and a single slice (2^10)."""
    leaves = random_leaves(np.random.default_rng(300), 333, maxlen=60)
    e = _engine(slice_log2=slice_log2, host_tail_leaves=0)
    assert e.AddMany(leaves)
    assert e.Root() == oracle.merkle_root(leaves).hex()


def test_auto_slice_log2_math(monkeypatch):
    """The counterpart of ``tests/test_cli.py::test_auto_slice_log2_math``:
    the slice from the card's free memory (1/8 of it at 32 B a leaf, floor
    2^10, cap 2^26), the default off CUDA."""
    from vk_merkle_roots_tpu_torch.config import auto_slice_log2

    card = torch.device("cuda", 0)
    for free, want in ((16 << 30, 26), (1 << 30, 22), (80 << 30, 26), (1 << 20, 12), (1 << 10, 10)):
        monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device, free=free: (free, 80 << 30))
        assert auto_slice_log2(card) == want
    assert auto_slice_log2("cpu") == 20
