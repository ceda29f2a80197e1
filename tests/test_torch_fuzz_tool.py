"""The randomized differential of ``chip_smoke.py``'s phase 9
(``tools/fuzz.py``) on the CPU device: its trials cover what the phase
promises, CPU-sized trials pass against the native host root, a wrong root
counts as a mismatch that names the trial's seed and config, and the
launch site records the kernels' tables and K3's cluster launches."""

import contextlib

import pytest
import torch

from vk_merkle_roots_tpu_torch import _build
from vk_merkle_roots_tpu_torch.models.cuda import CudaSha256D
from vk_merkle_roots_tpu_torch.ops import leaf_hash as lh
from vk_merkle_roots_tpu_torch.ops import tree_reduce as tr
from vk_merkle_roots_tpu_torch.tools import fuzz

torch.set_num_threads(1)


def test_card_trials_cover_the_phase():
    trials = [fuzz.draw_trial(i) for i in range(48)]
    assert all(3 <= t.slice_log2 <= 16 and t.host_tail_leaves in (0, 8192) and 0 <= t.pack_ahead <= 3 for t in trials)
    grouped = [t for t in trials if t.batch_leaves & (t.batch_leaves - 1) == 0 and 4 <= t.batch_leaves <= 4096]
    assert grouped and all(5 <= t.batch_leaves <= 5000 for t in trials if t not in grouped)
    assert len(grouped) < len(trials)
    assert sum(t.long_leaves for t in trials) >= 16 and sum(t.keep_digests for t in trials) >= 3
    assert sum(t.device_max_blocks < 2048 for t in trials) >= 3 and sum(t.reset for t in trials) >= 3
    assert [t.kind for t in trials].count("mesh round robin") == [t.kind for t in trials].count("mesh sharded") == 3
    many, cluster = trials[0], trials[1]
    tail = many.count % (1 << many.slice_log2)
    assert many.host_tail_leaves == 0 and tail == (1 << 14) - 1 and not many.reset
    tail = cluster.count % (1 << cluster.slice_log2)
    assert cluster.host_tail_leaves == 0 and 1 << (tail.bit_length() - 1) > 1 << fuzz.SOLO_MAX_LOG2


@pytest.mark.parametrize("start", [0, 4, 8])
def test_cpu_trials_match_the_host_root(start):
    trials = [fuzz.draw_trial(i, max_slice_log2=5, max_leaves=64) for i in range(start, start + 4)]
    summary = fuzz.run(trials, ["cpu", "cpu"], long_max=700, log=lambda line: None)
    assert summary["trials"] == 4 and summary["mismatches"] == 0 and summary["failures"] == []
    assert summary["roots"] >= 4 and summary["leaves"] == sum(t.count for t in trials)
    assert summary["devices"] == ["cpu", "cpu"] and summary["tail_launches"] == 0  # the plain paths launch nothing


def test_a_wrong_root_fails_with_the_seed(monkeypatch, capsys):
    real = CudaSha256D.Root
    monkeypatch.setattr(CudaSha256D, "Root", lambda self: real(self)[::-1])
    trial = fuzz.draw_trial(5, max_slice_log2=5, max_leaves=64)
    got = fuzz.run_trial(trial, ["cpu", "cpu"], long_max=700)
    assert got["roots"] >= 1 and len(got["failures"]) == got["roots"]  # every root checked, each one wrong
    assert all(f"'seed': {trial.seed}" in line and "native host root" in line for line in got["failures"])
    assert fuzz.main(["--trials", "1", "--start", "5", "--device", "cpu"]) == 1
    assert "MISMATCH final Root()" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert fuzz.main(["--trials", "1"]) == 2  # the default device is a card: no CPU run in its place


class _Launcher:
    """Stands in for the kernel library: every C launcher accepts."""

    def __getattr__(self, fn):
        return lambda *args: 0


def test_table_audit_records_tables(monkeypatch):
    """The wrappers' launch sites record each table's size and K3's cluster
    launches in ``_build``, beside the launch counts (launched here into a
    stand-in library, on CPU tensors)."""
    monkeypatch.setattr(_build, "load", _Launcher)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    out = torch.zeros((8, 4096), dtype=torch.int32)
    words = torch.zeros((1, 16, 8, 128), dtype=torch.int32)
    exact = [lh.LeafBucket(words, 1, 5, 0), lh.LeafBucket(words, 1, 7, 5)]
    stream = [lh.LeafBucket(words, 1, 3, 12, torch.ones(3, dtype=torch.int32))]
    cols = torch.zeros((8, 1024), dtype=torch.int32)
    small = [tr.TailEntry(cols[:, :4], 2, False)] * 3
    big = small + [tr.TailEntry(cols[:, :256], 8, False)]
    _build.reset_counts()
    lh._launch("leaf_hash_exact", "vkmr_leaf_hash_exact", exact, out, 128)
    lh._launch("leaf_hash_stream", "vkmr_leaf_hash_stream", stream, out, 1)
    tr._launch_tail(small, out)
    tr._launch_tail(big * 10, out)  # 40 blocks, largest first: the 256-digest ones all in the first table
    assert _build.table_max == {"leaf_hash_exact": 2, "leaf_hash_stream": 1, "tail_reduce": 32}
    assert _build.cluster_launches == {"tail_reduce": 1}
    assert _build.launches == {"leaf_hash_exact": 1, "leaf_hash_stream": 1, "tail_reduce": 3}
    _build.reset_counts()
    assert not _build.table_max and not _build.cluster_launches
