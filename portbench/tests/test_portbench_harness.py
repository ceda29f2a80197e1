"""The harness on the CPU: BENCHMARK.json against the contract, cells,
mixes and metrics found as new files, the window's loop with the port's
plain ``TORCH`` engine at a tiny size, and the faults ``correct`` has to
catch.  This checks plumbing: ``run.py`` itself refuses to run without a
card."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_meets_the_contract():
    b = harness.load_bench(ROOT)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"] == ["python3", "portbench/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = set()
    configs = {}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"portbench/configs/{c['name']}.json" and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert all(k in body for k in c["reduced"])
        assert body["source_values"].keys() <= set(c["reduced"])
        configs[c["name"]] = c
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"]) and w["chips"] in (1, 4)
        assert w["config"] in configs and (ROOT / "portbench/traffic" / f"{w['traffic']}.json").is_file()
        assert w["name"] not in names
        names.add(w["name"])
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(b["workloads"])
    assert {c["name"] for c in b["configs"]} == {w["config"] for w in b["workloads"]}
    cells = {w["name"] for w in b["workloads"]}
    e2e = {}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        e2e[m["name"]] = set(m.get("workloads", cells))
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= e2e[m["moves"]]
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "portbench/metrics" / f"{m['name']}.py").is_file()
    for cell in cells:  # setup_s, another end-to-end metric and a per-layer metric in every cell
        reported = {m["name"] for m in harness.resolve(b, cell, False).metrics}
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.resolve(b, cell, True).metrics
    assert len(json.dumps(b)) < 64 << 10


def _digest_tree(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark with a tiny cell, its mix and a metric added
    as new files and new entries, and nothing else changed."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest_tree(root / "portbench")
    config = json.loads((root / "portbench/configs/rndm127.json").read_text())
    config.update(name="tiny", maxlen=40, slice_log2=3, batch_leaves=4, host_tail_leaves=2)
    (root / "portbench/configs/tiny.json").write_text(json.dumps(config))
    (root / "portbench/traffic/tiny.json").write_text(json.dumps({"pool": 2, "leaves": {"fixed": 21}}))
    (root / "portbench/metrics/streams_done.py").write_text("def read(run):\n    return float(len(run.records))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "test", "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.stream", "config": "tiny", "traffic": "tiny", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "streams_done", "unit": "1", "better": "higher", "source": "host_clock",
                               "layer": "engine", "moves": "payload_gbps", "workloads": ["tiny.stream"]})
    for m in bench["per_layer"]:
        if "rndm127.stream" in m.get("workloads", ()):
            m["workloads"].append("tiny.stream")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest_tree(root / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before
    return root


def test_new_config_mix_and_metric_are_found_by_name(tiny_root):
    bench = harness.load_bench(tiny_root)
    cell = harness.resolve(bench, "tiny.stream", True, tiny_root / "portbench")
    assert cell.config["name"] == "tiny" and cell.traffic["leaves"] == {"fixed": 21}
    assert "streams_done" in [m["name"] for m in cell.metrics]
    assert harness.load_reader("streams_done", tiny_root / "portbench") is not None
    assert "streams_done" not in [m["name"] for m in harness.resolve(bench, "rndm127.stream", True,
                                                                      tiny_root / "portbench").metrics]


def _run(root, seconds=0.3, traced=False, make_engine=harness.default_engine, seed=2**31 + 5):
    return harness.run_cell(root, "tiny.stream", seed, seconds, traced, device="cpu", engine_name="TORCH",
                            make_engine=make_engine)


def test_window_loop_on_the_cpu(tiny_root):
    result, checks = _run(tiny_root)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"payload_gbps", "setup_s"}
    assert list(result)[-1] == "checks" and checks[-1] == "check missing_roots 0 limit 0"
    assert isinstance(result["build_s"], dict)
    assert result["checks"]["wrong_roots"] == {"value": 0, "limit": 0}


def _children() -> set[int]:
    return {int(pid) for task in Path("/proc/self/task").iterdir() for pid in (task / "children").read_text().split()}


def test_run_leaves_no_child_process(tiny_root):
    before = _children()
    result, _ = _run(tiny_root)
    assert result["correct"]
    assert _children() <= before


def test_traced_window_on_the_cpu(tiny_root):
    result, _ = _run(tiny_root, traced=True)
    assert result["correct"]
    metrics = result["metrics"]
    assert {"ingest_gbps", "pack_gbps", "flush_dispatch_ms", "streams_done"} <= set(metrics)
    assert "device_idle" not in metrics and "leaf_hash_roofline" not in metrics  # no device ops on the CPU
    assert result["device"]["window_s"] > 0 and "breakdown" in result


class _Fault:
    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)


class _StateUnchanged(_Fault):
    """Root() hands back the root of the stream before."""

    last = None

    def Root(self):
        root = self.inner.Root()
        out, self.last = (self.last or root), root
        return out


class _HalfBatch(_Fault):
    """Half of each batch of leaves left out."""

    def AddSpans(self, data, offs, lens):
        keep = max(1, len(lens) // 2)
        return self.inner.AddSpans(data, offs[:keep], lens[:keep])


class _Altered(_Fault):
    """The answer altered where it is produced."""

    def Root(self):
        root = self.inner.Root()
        return ("1" if root[0] == "0" else "0") + root[1:]


@pytest.mark.parametrize("fault", [_StateUnchanged, _HalfBatch, _Altered])
def test_faults_make_the_run_not_correct(tiny_root, fault):
    make = lambda name, config: fault(harness.default_engine(name, config))  # noqa: E731
    result, checks = _run(tiny_root, seconds=0.8, make_engine=make)
    assert result["attempted"] >= 2
    assert not result["correct"] and result["checks"]["wrong_roots"]["value"] > 0


def test_failed_stream_is_counted_not_raised(tiny_root):
    class Refuses(_Fault):
        calls = 0

        def AddSpans(self, *args):
            Refuses.calls += 1
            return Refuses.calls <= 1 and self.inner.AddSpans(*args)  # the warm-up passes

    make = lambda name, config: Refuses(harness.default_engine(name, config))  # noqa: E731
    result, _ = _run(tiny_root, seconds=0.3, make_engine=make)
    assert not result["correct"] and result["failed"] >= 1 and result["checks"]["missing_roots"]["value"] >= 1


def _run_py(root: Path, env_extra: dict) -> subprocess.CompletedProcess:
    env = {**os.environ, **env_extra}
    return subprocess.run([sys.executable, str(root / "portbench/run.py"), "--workload", "rndm127.stream",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, env=env, timeout=300)


def test_run_py_refuses_without_a_card():
    proc = _run_py(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA card" in proc.stderr


def test_run_py_refuses_in_a_checkout_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_py(tmp_path, {"CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": ""})
    assert proc.returncode != 0 and proc.stdout == ""
