"""The trace, roofline, idle and H2D arithmetic on a small synthetic Chrome
trace, and the metric readers on a synthetic run."""

import pytest

from portbench import harness, roofline, trace
from portbench.streams import Pool

EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "portbench.window", "ts": 1000, "dur": 1000},
    {"ph": "X", "cat": "user_annotation", "name": "portbench.AddSpans", "ts": 1000, "dur": 400},
    {"ph": "X", "cat": "user_annotation", "name": "portbench.Root", "ts": 1500, "dur": 300},
    {"ph": "X", "cat": "kernel", "name": "(anonymous namespace)::leaf_hash_exact_kernel(LeafTable)", "ts": 1100,
     "dur": 50},
    {"ph": "X", "cat": "kernel", "name": "fold_level_kernel(unsigned int const*, long)", "ts": 1120, "dur": 60},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 1300, "dur": 100,
     "args": {"bytes": 1000000}},
    {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "ts": 1600, "dur": 10},
    {"ph": "X", "cat": "kernel", "name": "tail_reduce_kernel(TailTable, unsigned int)", "ts": 2500, "dur": 10},
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1200},
]


def test_summary_busy_idle_h2d_kernels():
    s = trace.summarize(EVENTS)
    assert s.window_s == pytest.approx(1000e-6)
    assert s.busy_s() == pytest.approx(190e-6)  # [1100,1180] + [1300,1400] + [1600,1610]
    assert s.h2d() == (1000000, pytest.approx(100e-6))
    assert s.kernel_s(["leaf_hash_exact_kernel"]) == pytest.approx(50e-6)
    assert s.kernel_s(["fold_level_kernel", "tail_reduce_kernel"]) == pytest.approx(60e-6)  # the tail lies outside


def test_breakdown_attributes_idle_time_to_the_host_span():
    b = trace.summarize(EVENTS).breakdown()
    idle = dict(b["idle_gaps"])
    assert idle["AddSpans"] == pytest.approx(220e-6)
    assert idle["Root"] == pytest.approx(290e-6)
    assert idle["outside bench spans"] == pytest.approx(300e-6)
    assert sum(idle.values()) == pytest.approx(810e-6)
    ops = dict(b["device_ops"])
    assert ops["Memcpy HtoD (Pageable -> Device)"] == pytest.approx(100e-6)
    assert ops["leaf_hash_exact_kernel"] == pytest.approx(50e-6)
    assert len(b["device_ops"]) <= trace.BREAKDOWN_ENTRIES


def test_no_window_no_summary_and_h2d_without_bytes():
    assert trace.summarize(EVENTS[1:]) is None
    events = [dict(e) for e in EVENTS]
    del events[5]["args"]
    assert trace.summarize(events).h2d() is None


def test_union():
    assert trace.union_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.union_us([]) == 0


def test_leaf_work_counts():
    lengths = [1, 55, 56, 119, 120, 5000]
    assert list(roofline.padded_blocks(lengths)) == [1, 1, 2, 2, 3, 79]
    ops, nbytes = roofline.leaf_work(lengths, 64)  # the 79-block leaf hashes on the host
    assert ops == 14 * 896 - 2 * 5 * 12
    assert nbytes == 1 + 55 + 56 + 119 + 120 + 5 * 32
    assert roofline.OPS_PER_COMPRESSION == 896


def _engine_nodes(n, slice_log2, host_tail):
    """Nodes by walking the engine's rule level by level."""
    cap, nodes = 1 << slice_log2, 0
    for s0 in range(0, n, cap):
        m, full = min(cap, n - s0), n - s0 >= cap
        if not full and m <= host_tail:
            continue
        levels = slice_log2 if (full or n > cap) else max(0, (m - 1).bit_length())
        for _ in range(levels):
            m = (m + 1) // 2
            nodes += m
    return nodes


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9, 16, 19, 35, 64, 100])
@pytest.mark.parametrize("host_tail", [0, 2, 5])
def test_device_nodes(n, host_tail):
    assert roofline.device_nodes(n, 3, host_tail) == _engine_nodes(n, 3, host_tail)


def test_reduce_work_and_share():
    ops, nbytes = roofline.reduce_work(10)
    assert ops == 30 * 896 - 20 * 12 and nbytes == 960
    t = roofline.least_seconds(ops, nbytes)
    assert t == pytest.approx(max(ops / 1.67270e13, nbytes / 3.35e12), rel=1e-4)
    assert roofline.share_percent(ops, nbytes, 2 * t) == pytest.approx(50.0)
    assert roofline.share_percent(ops, nbytes, 0.0) is None


def _run(summary):
    lines = [b"a" * 60, b"b" * 130, b"c"]
    pool = Pool([b"\n".join(lines) + b"\n"], [3])
    config = {"device_max_blocks": 2048, "slice_log2": 1, "host_tail_leaves": 0}
    cell = harness.Cell("x", config, {}, [])
    rec = harness.StreamRecord(0, len(pool.streams[0]), 3, latency_s=0.25, root="00")
    rec.spans.update({"ingest_next": 0.01, "Root": 0.002, "Reset": 0.003})
    rec.stages = {"pack": {"count": 2, "ms": 4.0, "bytes": 191}, "map_dispatch": {"count": 2, "ms": 1.0}}
    return harness.Run(cell, 7.5, 0.5, [rec, rec], pool, summary), lines


def test_metric_readers_on_a_synthetic_run():
    summary = trace.summarize(EVENTS)
    run, lines = _run(summary)
    read = lambda name: harness.load_reader(name)(run)  # noqa: E731
    nbytes = 2 * len(run.pool.streams[0])
    assert read("payload_gbps") == pytest.approx(nbytes / 0.5 / 1e9)
    assert read("setup_s") == 7.5
    assert read("ingest_gbps") == pytest.approx(nbytes / 0.02 / 1e9)
    assert read("pack_gbps") == pytest.approx(382 / 8e6)
    assert read("flush_dispatch_ms") == pytest.approx(0.5)
    assert read("root_ms") == pytest.approx(2.0)
    assert read("reset_ms") == pytest.approx(3.0)
    assert read("device_idle") == pytest.approx(81.0)
    assert read("h2d_gbps") == pytest.approx(10.0)
    ops, b = roofline.leaf_work([len(x) for x in lines], 2048)
    assert read("leaf_hash_roofline") == pytest.approx(100 * roofline.least_seconds(2 * ops, 2 * b) / 50e-6)
    nodes = 2 * roofline.device_nodes(3, 1, 0)
    ops, b = roofline.reduce_work(nodes)
    assert read("reduce_roofline") == pytest.approx(100 * roofline.least_seconds(ops, b) / 60e-6)


def test_trace_readers_read_nothing_without_a_trace():
    run, _ = _run(None)
    for name in ("device_idle", "h2d_gbps", "leaf_hash_roofline", "reduce_roofline"):
        assert harness.load_reader(name)(run) is None
