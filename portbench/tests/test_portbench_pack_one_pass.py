"""``pack_one_pass_share``: its reader on synthetic runs and on the stages of
the port's plain ``TORCH`` engine, and its ``BENCHMARK.json`` entry."""

import json
from pathlib import Path

import pytest

from portbench import harness
from portbench.streams import Pool

ROOT = Path(__file__).resolve().parents[2]


def _run(*stages):
    records = []
    for s in stages:
        rec = harness.StreamRecord(0, 10, 3, latency_s=0.1, root="00")
        rec.stages = s
        records.append(rec)
    return harness.Run(harness.Cell("x", {}, {}, []), 1.0, 0.5, records, Pool([b"a\n"], [1]), None)


def _read(run):
    return harness.load_reader("pack_one_pass_share")(run)


ALL = {"pack": {"count": 4, "ms": 2.0, "bytes": 400}, "pack_one_pass": {"count": 4, "ms": 2.0, "bytes": 400}}
NONE = {"pack": {"count": 2, "ms": 1.0, "bytes": 900}}
PARENT = {"pack": {"count": 3, "ms": 1.0, "bytes": 300}, "pack_wait": {"count": 3, "ms": 0.5}}


@pytest.mark.parametrize("stages,want", [
    ((ALL, ALL), 100.0),
    ((ALL, NONE), 100.0 * 4 / 6),  # a stream whose flushes all took the general path
    ((PARENT,), None),  # a program without the stage: nothing, not 0
    ((), None),
])
def test_share_of_flushes_over_the_window(stages, want):
    got = _read(_run(*stages))
    assert got == (None if want is None else pytest.approx(want))


def test_entry():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = {x["name"]: x for x in bench["per_layer"]}["pack_one_pass_share"]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
        "%", "higher", "program_span", "host packer", "payload_gbps")
    assert m["workloads"] == ["rndm127.stream", "rndm127.readme"]
    for cell in m["workloads"]:
        assert "pack_one_pass_share" in [x["name"] for x in harness.resolve(bench, cell, True).metrics]
        assert "pack_one_pass_share" not in [x["name"] for x in harness.resolve(bench, cell, False).metrics]


def test_reads_100_from_the_engine_on_short_leaves():
    """rndm-127 streams through the plain engine, as the window drives them:
    every flush takes the one pass."""
    from vk_merkle_roots_tpu_torch.config import EngineConfig
    from vk_merkle_roots_tpu_torch.models.cuda import CudaSha256D
    from vk_merkle_roots_tpu_torch.native.lib import native_rndm_stream

    streams = [native_rndm_stream(seed, 21, 127) for seed in (5, 6)]
    pool = Pool(streams, [21, 21])
    engine = CudaSha256D(device="cpu", config=EngineConfig(slice_log2=4, batch_leaves=4, host_tail_leaves=4))
    span = harness.Spans(False)
    records = []
    for i in (0, 1):
        records.append(harness.run_stream(engine, pool, i, span))
        engine.Reset()
    assert all(r.error is None for r in records)
    assert _read(harness.Run(harness.Cell("x", {}, {}, []), 1.0, 0.5, records, pool, None)) == 100.0
