"""The control of ``correct`` at a size a test run holds: the reference
with an odd node carried up unchanged, judged as a run is, comes out not
correct; the reference itself comes out correct."""

import json
from pathlib import Path

import pytest

from portbench import control, harness, reference
from portbench.streams import make_pool

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture()
def small_root(tmp_path):
    bench = harness.load_bench(ROOT)
    (tmp_path / "portbench/configs").mkdir(parents=True)
    (tmp_path / "portbench/traffic").mkdir()
    for w in bench["workloads"]:
        config = json.loads((ROOT / f"portbench/configs/{w['config']}.json").read_text())
        config["slice_log2"] = 6
        (tmp_path / f"portbench/configs/{w['config']}.json").write_text(json.dumps(config))
        traffic = json.loads((ROOT / f"portbench/traffic/{w['traffic']}.json").read_text())
        # a power-of-two count (the README's 1024) stays one, with no odd node for a control to miss
        traffic["leaves"] = {"fixed": min(traffic["leaves"]["fixed"], 1024)}
        (tmp_path / f"portbench/traffic/{w['traffic']}.json").write_text(json.dumps(traffic))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


@pytest.mark.parametrize("workload", ["rndm127.stream", "rndm127.readme"])
@pytest.mark.parametrize("seed", [3, 2**31 + 17, 2**33 + 1])
def test_control_is_not_correct(small_root, workload, seed):
    out = control.control(small_root, workload, seed)
    assert not out["correct"] and out["checks"]["wrong_roots"]["value"] > 0


def test_reference_in_the_programs_place_is_correct(small_root):
    cell = harness.resolve(harness.load_bench(small_root), "rndm127.readme", False, small_root / "portbench")
    pool = make_pool(cell.config, cell.traffic, 5)
    roots = reference.stream_roots(pool.streams, 6)
    records = [harness.StreamRecord(i, len(s), n, root=r) for i, (s, n, r) in enumerate(zip(pool.streams,
                                                                                              pool.leaves, roots))]
    assert harness.judge(records, dict(enumerate(roots))) == {"wrong_roots": {"value": 0, "limit": 0},
                                                               "missing_roots": {"value": 0, "limit": 0}}
