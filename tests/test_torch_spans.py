"""The engine's stage spans (``StageTimes.span``) on the CPU device (the TORCH
engine): what each stage counts, its bytes, which ragged tail takes which
stage, the ``vkmr.<stage>`` ranges a running profiler records, and that no
range is opened while no profiler runs."""

import json

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from vk_merkle_roots_tpu_torch import oracle
from vk_merkle_roots_tpu_torch.config import EngineConfig
from vk_merkle_roots_tpu_torch.models.cuda import CudaSha256D
from vk_merkle_roots_tpu_torch.models.mesh import MeshCudaSha256D
from vk_merkle_roots_tpu_torch.ops import leaf_hash
from vk_merkle_roots_tpu_torch.utils.timing import StageTimes

torch.set_num_threads(1)


def _leaves(seed, count, lo=1, hi=100):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes() for n in rng.integers(lo, hi + 1, size=count)]


def _root(engine, leaves, slice_log2):
    assert engine.AddMany(leaves)
    root = engine.Root()
    assert root == oracle.merkle_root_sliced(leaves, slice_log2).hex()
    return engine.Stats()["stages"]


def _engine(**kw):
    kw = {"slice_log2": 4, "batch_leaves": 8, **kw}
    return CudaSha256D(device="cpu", config=EngineConfig(**kw))


def test_span_adds_as_add_does_and_skips_a_raising_block():
    times = StageTimes()
    with times.span("upload", 64):
        pass
    with times.span("drain"):
        pass
    with pytest.raises(ValueError):
        with times.span("upload", 1000):
            raise ValueError("not recorded")
    got = times.summary()
    assert {k: v["count"] for k, v in got.items()} == {"upload": 1, "drain": 1}
    assert got["upload"]["bytes"] == 64 and "GB_per_s" not in got["upload"]
    assert set(got["drain"]) == {"count", "ms"} and got["drain"]["ms"] >= 0


@pytest.mark.parametrize("pack_ahead", [0, 2])
def test_pack_wait_counts_one_a_flush(pack_ahead):
    stages = _root(_engine(pack_ahead=pack_ahead, host_tail_leaves=8192), _leaves(1, 44), 4)
    flushes = -(-44 // 8)
    assert stages["pack_wait"]["count"] == stages["map_dispatch"]["count"] == stages["pack"]["count"] == flushes
    assert stages["pack"]["bytes"] == stages["map_dispatch"]["bytes"]
    assert "bytes" not in stages["pack_wait"]


@pytest.mark.parametrize("long_every", [0, 5])
def test_upload_bytes_are_the_flushes_words_and_counts(monkeypatch, long_every):
    """``upload`` holds what a flush copies, one span a flush: a compact
    unit's slot bytes in use (its row table and raw bytes), or a declined
    flush's packed words and block counts that ``flush_buckets`` copies; the
    host-hashed digests of leaves past ``device_max_blocks`` and the inverse
    order are copied after the kernels are launched, outside it, so the host
    hashes while the device runs."""
    copied, calls = [], []
    flush_buckets, host_cols = leaf_hash.flush_buckets, leaf_hash.host_leaf_digest_cols
    exact_into, stream_into = leaf_hash.exact_hash_buckets_into, leaf_hash.stream_hash_buckets_into
    wire_into = leaf_hash.wire_hash_into

    def counting_wire_into(unit, *args, **kw):
        calls.append("upload")
        copied.append(unit.nbytes)
        return wire_into(unit, *args, **kw)

    def counting_flush_buckets(packed, *args, **kw):
        calls.append("upload")
        exact, stream = flush_buckets(packed, *args, **kw)
        copied.extend(b.words.numel() * 4 for b in exact + stream)
        copied.extend(b.counts.numel() * 4 for b in stream)
        return exact, stream

    def logged(name, fn):
        def call(*args, **kw):
            calls.append(name)
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(leaf_hash, "flush_buckets", counting_flush_buckets)
    monkeypatch.setattr(leaf_hash, "wire_hash_into", counting_wire_into)
    monkeypatch.setattr(leaf_hash, "host_leaf_digest_cols", logged("host", host_cols))
    monkeypatch.setattr(leaf_hash, "exact_hash_buckets_into", logged("exact", exact_into))
    monkeypatch.setattr(leaf_hash, "stream_hash_buckets_into", logged("stream", stream_into))
    leaves = _leaves(2, 30)
    if long_every:
        for i in range(0, len(leaves), long_every):  # 9..14 blocks: a stream rung or the host
            leaves[i] = bytes(range(256)) * 2 + bytes(i % 7 * 60)
    stages = _root(_engine(host_tail_leaves=8192, device_max_blocks=9), leaves, 4)
    assert stages["upload"]["bytes"] == sum(copied) > 0
    assert stages["upload"]["count"] == stages["map_dispatch"]["count"] == calls.count("upload")
    assert ("host" in calls) == bool(long_every)
    assert stages.get("pack_one_pass", {"count": 0})["count"] == (0 if long_every else stages["upload"]["count"])
    for i, name in enumerate(calls):  # each flush: its upload, then K1 and K4, then the host digests
        if name == "host":
            assert calls[i - 3 : i] == ["upload", "exact", "stream"]


def test_one_drain_and_finalize_per_root():
    e = _engine(host_tail_leaves=8192)
    leaves = _leaves(3, 20)
    stages = _root(e, leaves[:12], 4)
    assert stages["drain"]["count"] == stages["finalize"]["count"] == 1
    assert e.AddMany(leaves[12:]) and e.Root() == oracle.merkle_root_sliced(leaves, 4).hex()  # the stream grew
    stages = e.Stats()["stages"]
    assert stages["drain"]["count"] == stages["finalize"]["count"] == 2
    assert "bytes" not in stages["drain"]
    e.Reset()
    assert "drain" not in e.Stats()["stages"]


# (leaves, slice_log2, host_tail_leaves, tail stage or None)
TAILS = [
    (12, 4, 12, "tail_host"),    # the whole stream, at host_tail_leaves
    (12, 4, 11, "tail_device"),  # the whole stream, one past it
    (21, 4, 8192, "tail_host"),  # a full slice and a 5-leaf tail
    (21, 4, 4, "tail_device"),
    (32, 4, 0, None),            # full slices only: no tail
]


@pytest.mark.parametrize("count,slice_log2,host_tail,stage", TAILS)
def test_tail_takes_the_host_or_the_device_stage(count, slice_log2, host_tail, stage):
    stages = _root(_engine(slice_log2=slice_log2, host_tail_leaves=host_tail), _leaves(4, count), slice_log2)
    tails = {k: v for k, v in stages.items() if k.startswith("tail_")}
    if stage is None:
        assert not tails
        return
    assert set(tails) == {stage}
    assert tails[stage]["count"] == 1 and tails[stage]["bytes"] == (count % (1 << slice_log2)) * 32


def test_no_device_event_stages():
    stages = _root(_engine(host_tail_leaves=0), _leaves(5, 37), 4)
    assert not {"map_device", "reduce_device"} & set(stages)
    assert stages["reduce_dispatch"]["count"] == 2
    assert stages["materialize"]["bytes"] == 2 * 32  # the slice roots, in one readback; the tail's is its own


class _CountingRange:
    """Stands in for ``record_function`` and keeps the engine's ranges."""

    seen: list = []

    def __init__(self, name, args=None):
        if name.startswith("vkmr."):
            self.seen.append(name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_no_range_without_a_profiler_and_ranges_with_one(monkeypatch):
    monkeypatch.setattr(autograd_profiler, "record_function", _CountingRange)
    monkeypatch.setattr(_CountingRange, "seen", [])
    e = _engine(host_tail_leaves=8192, device_max_blocks=1)
    leaves = _leaves(6, 12, lo=60, hi=200)  # every leaf hashes on the host: no plain kernel under the profiler
    _root(e, leaves, 4)
    assert _CountingRange.seen == []
    e.Reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _root(e, leaves, 4)
    names = set(_CountingRange.seen)
    assert {"vkmr.pack_wait", "vkmr.map_dispatch", "vkmr.upload", "vkmr.drain", "vkmr.tail_host",
            "vkmr.finalize"} <= names
    assert "vkmr.pack" not in names  # the pack thread's time stays in memory: its range would not reach a trace


def test_profiler_trace_holds_the_ranges_inside_the_callers(tmp_path):
    e = _engine(host_tail_leaves=8192, device_max_blocks=1)
    leaves = _leaves(7, 12, lo=60, hi=200)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            _root(e, leaves, 4)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [ev for ev in json.loads(path.read_text())["traceEvents"] if ev.get("ph") == "X"]
    (caller,) = [ev for ev in events if ev["name"] == "caller"]
    ranges = [ev for ev in events if ev["name"].startswith("vkmr.")]
    names = {ev["name"] for ev in ranges}
    assert {"vkmr.pack_wait", "vkmr.upload", "vkmr.drain", "vkmr.tail_host"} <= names
    end = lambda ev: ev["ts"] + ev["dur"]  # noqa: E731
    for ev in ranges:
        assert ev["tid"] == caller["tid"]
        assert caller["ts"] <= ev["ts"] and end(ev) <= end(caller), ev["name"]
    (drain,) = [ev for ev in ranges if ev["name"] == "vkmr.drain"]
    assert any(drain["ts"] <= ev["ts"] and end(ev) <= end(drain) for ev in ranges if ev["name"] == "vkmr.pack_wait")
    for up in (ev for ev in ranges if ev["name"] == "vkmr.upload"):
        assert any(d["ts"] <= up["ts"] and end(up) <= end(d) for d in ranges if d["name"] == "vkmr.map_dispatch")


def test_mesh_records_upload_on_each_device():
    e = MeshCudaSha256D(["cpu", "cpu"], config=EngineConfig(slice_log2=4, batch_leaves=8, host_tail_leaves=8192))
    stages = _root(e, _leaves(8, 26), 4)
    assert stages["upload"]["count"] == stages["map_dispatch"]["count"] == stages["pack_wait"]["count"] == 4
    assert stages["upload"]["bytes"] > 0
    assert not {"map_device", "reduce_device"} & set(stages)
