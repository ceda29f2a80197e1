"""``ingest_native_share``: its reader on the program's count of reads by
path, on a program without the count, on the port's ``iter_line_spans``
through the harness, and its ``BENCHMARK.json`` entry."""

import json
import sys
import types
from collections import Counter
from pathlib import Path

import pytest

from portbench import harness
from portbench.streams import Pool

ROOT = Path(__file__).resolve().parents[2]
MODULE = "vk_merkle_roots_tpu_torch.ingest"


def _read():
    run = harness.Run(harness.Cell("x", {}, {}, []), 1.0, 0.5, [], Pool([b"a\n"], [1]), None)
    return harness.load_reader("ingest_native_share")(run)


@pytest.mark.parametrize("counts,want", [
    (Counter(native=17), 100.0),
    (Counter(native=3, numpy=1), 75.0),
    (Counter(numpy=4), 0.0),
    (Counter(), None),  # no read split yet
    (None, None),  # a program without the count: nothing, not 0
])
def test_share_of_the_reads_split_natively(monkeypatch, counts, want):
    program = types.ModuleType(MODULE)
    if counts is not None:
        program.split_reads = counts
    monkeypatch.setitem(sys.modules, MODULE, program)
    got = _read()
    assert got == (None if want is None else pytest.approx(want))


def test_none_before_the_program_is_imported(monkeypatch):
    monkeypatch.delitem(sys.modules, MODULE, raising=False)
    assert _read() is None


def test_entry():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = {x["name"]: x for x in bench["per_layer"]}["ingest_native_share"]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
        "%", "higher", "program_span", "ingest", "payload_gbps")
    assert m["workloads"] == ["rndm127.stream", "rndm127.readme"]
    for cell in m["workloads"]:
        assert "ingest_native_share" in [x["name"] for x in harness.resolve(bench, cell, True).metrics]
        assert "ingest_native_share" not in [x["name"] for x in harness.resolve(bench, cell, False).metrics]


def test_reads_100_from_the_engine_on_short_leaves(monkeypatch):
    """rndm-127 streams through the plain engine, as the window drives them:
    the native scan splits every read."""
    from vk_merkle_roots_tpu_torch import ingest
    from vk_merkle_roots_tpu_torch.config import EngineConfig
    from vk_merkle_roots_tpu_torch.models.cuda import CudaSha256D
    from vk_merkle_roots_tpu_torch.native.lib import native_rndm_stream

    monkeypatch.setattr(ingest, "split_reads", Counter())
    streams = [native_rndm_stream(seed, 21, 127) for seed in (5, 6)]
    pool = Pool(streams, [21, 21])
    engine = CudaSha256D(device="cpu", config=EngineConfig(slice_log2=4, batch_leaves=4, host_tail_leaves=4))
    span = harness.Spans(False)
    for i in (0, 1):
        assert harness.run_stream(engine, pool, i, span).error is None
        engine.Reset()
    assert ingest.split_reads == Counter(native=2)
    assert _read() == 100.0
