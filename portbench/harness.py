"""The benchmark's harness: one run of one cell of ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix or metric is
found by its name: ``configs/<config>.json``, ``traffic/<traffic>.json``
and ``metrics/<metric>.py`` beside this file (a metric's file defines
``read(run) -> float | None``).  A later cell, mix or metric is new files
and new entries; no file here needs an edit.

One run: set-up (the kernels, the cell's pool of streams from the seed, the
engine, one warm-up stream of each leaf count in the pool), then a closed loop
with one client for ``seconds``: streams back to back, each the calls that
``cli.run`` makes (``iter_line_spans`` over the stream's bytes,
``AddSpans`` per chunk, ``Root()``), ``Reset()`` between them.  The window
opens at the first stream's first chunk and closes when the root of the
last stream started inside it returns.  Then the program is freed, and
every root of the window is judged against the plain reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path

from . import reference, trace
from .streams import Pool, make_pool

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vk_merkle_roots_tpu")


def load_bench(root: Path) -> dict:
    with open(Path(root) / "BENCHMARK.json") as fh:
        return json.load(fh)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    metrics: list[dict]  # the end-to-end or the per-layer metrics this run reports


def _applies(metric: dict, cell: str, e2e_names: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def resolve(bench: dict, workload: str, traced: bool, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell named ``workload``, its files and the metrics its run
    reports: the end-to-end ones, or with ``traced`` the per-layer ones."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[workload]
    with open(bench_dir / "configs" / f"{w['config']}.json") as fh:
        config = json.load(fh)
    with open(bench_dir / "traffic" / f"{w['traffic']}.json") as fh:
        traffic = json.load(fh)
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload, set())]
    metrics = e2e
    if traced:
        names = {m["name"] for m in e2e}
        metrics = [m for m in bench["per_layer"] if _applies(m, workload, names)]
    return Cell(workload, config, traffic, metrics)


def load_reader(name: str, bench_dir: Path = BENCH_DIR):
    """``read`` of ``metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclass
class StreamRecord:
    index: int  # in the pool
    nbytes: int  # as piped: leaf bytes and newlines
    leaves: int
    latency_s: float = 0.0
    spans: Counter = field(default_factory=Counter)  # bench span -> seconds
    stages: dict = field(default_factory=dict)  # the engine's Stats()["stages"]
    root: str | None = None
    error: str | None = None


@dataclass
class Run:
    """What a metric's reader reads."""

    cell: Cell
    setup_s: float
    window_s: float
    records: list[StreamRecord]
    pool: Pool
    trace: trace.TraceSummary | None


class Spans:
    """The bench's own spans around each call into a layer: host clocks,
    and ``record_function`` ranges in a traced run."""

    def __init__(self, traced: bool) -> None:
        self._rf = None
        if traced:
            from torch.profiler import record_function

            self._rf = record_function

    @contextlib.contextmanager
    def __call__(self, rec: StreamRecord | None, name: str):
        rf = self._rf(trace.SPAN_PREFIX + name) if self._rf else contextlib.nullcontext()
        with rf:
            t = time.perf_counter()
            try:
                yield
            finally:
                if rec is not None:
                    rec.spans[name] += time.perf_counter() - t


def run_stream(engine, pool: Pool, i: int, span: Spans) -> StreamRecord:
    """One stream through the engine as ``cli.run`` drives it; a stream the
    engine refuses or fails on is recorded with its error, not raised."""
    from vk_merkle_roots_tpu_torch.ingest import iter_line_spans

    stream = pool.streams[i]
    rec = StreamRecord(i, len(stream), pool.leaves[i])
    t0 = time.perf_counter()
    try:
        chunks = iter_line_spans(io.BytesIO(stream))
        while True:
            with span(rec, "ingest_next"):
                chunk = next(chunks, None)
            if chunk is None:
                break
            data, offs, lens = chunk
            nonempty = lens > 0
            if not nonempty.all():
                offs, lens = offs[nonempty], lens[nonempty]
            if lens.size == 0:
                continue
            with span(rec, "AddSpans"):
                ok = engine.AddSpans(data, offs, lens)
            if not ok:
                raise RuntimeError("AddSpans refused the stream")
        with span(rec, "Root"):
            rec.root = engine.Root()
        rec.latency_s = time.perf_counter() - t0
        rec.stages = engine.Stats()["stages"]
    except Exception as exc:  # noqa: BLE001 - the run goes on and counts the stream as failed
        rec.latency_s = time.perf_counter() - t0
        rec.error = f"{type(exc).__name__}: {exc}"
    return rec


def engine_config(config: dict):
    from vk_merkle_roots_tpu_torch.config import EngineConfig

    names = {f.name for f in dataclasses.fields(EngineConfig)}
    return EngineConfig(**{k: v for k, v in config.items() if k in names})


def default_engine(name: str, config: dict):
    from vk_merkle_roots_tpu_torch.models import registry

    return registry.Get(name, engine_config(config))


def judge(records: list[StreamRecord], want: dict[int, str]) -> dict:
    """Each number compared, with its limit: roots that differ from the
    reference's, and streams whose root never came."""
    wrong = sum(1 for r in records if r.root is not None and r.root != want[r.index])
    missing = sum(1 for r in records if r.root is None)
    return {"wrong_roots": {"value": wrong, "limit": 0}, "missing_roots": {"value": missing, "limit": 0}}


def check_lines(checks: dict) -> list[str]:
    return [f"check {k} {v['value']} limit {v['limit']}" for k, v in checks.items()]


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def build_seconds() -> dict[str, float]:
    """Seconds this process spent building the program's libraries (the
    kernels with ``nvcc``, the host library with ``g++``): a checkout's
    first run builds, later runs find them built.  ``setup_s`` includes
    them; they are reported apart beside it."""
    from vk_merkle_roots_tpu_torch import _build

    built = {"nvcc": _build.build_seconds, "g++": _build.host_build_seconds}
    return {k: v for k, v in built.items() if v is not None}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(root: Path, workload: str, seed: int, seconds: float, traced: bool, *,
             device: str = "cuda:0", engine_name: str = "GPU", make_engine=default_engine,
             t_start: float | None = None) -> tuple[dict, list[str]]:
    """One run; returns the result object and its check lines."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    import vk_merkle_roots_tpu_torch.models.registry  # noqa: F401 - the program's import is set-up's too

    bench_dir = Path(root) / BENCH_DIR.name
    cell = resolve(load_bench(root), workload, traced, bench_dir)
    cuda = torch.device(device).type == "cuda"
    t_card = time.perf_counter()
    if cuda:
        from vk_merkle_roots_tpu_torch import _build

        torch.cuda.set_device(torch.device(device))
        torch.empty(1, device=device)
        t_kernels = time.perf_counter()
        _build.load()
    else:
        t_kernels = t_card
    t_pool = time.perf_counter()
    pool = make_pool(cell.config, cell.traffic, seed)
    t_engine = time.perf_counter()
    engine = make_engine(engine_name, cell.config)
    span = Spans(traced)
    for i in pool.warmup():
        rec = run_stream(engine, pool, i, span)
        if rec.error:
            raise RuntimeError(f"warm-up stream {i} failed: {rec.error}")
        engine.Reset()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    build_s = build_seconds()
    print(f"set-up {setup_s:.3f} s: imports {t_card - t_start:.3f}, card {t_kernels - t_card:.3f},"
          f" kernels {t_pool - t_kernels:.3f}, pool {t_engine - t_pool:.3f},"
          f" engine and warm-up {t_start + setup_s - t_engine:.3f}; of it built {build_s}", file=sys.stderr)

    records: list[StreamRecord] = []
    summary = None
    with contextlib.ExitStack() as stack:
        if traced:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = stack.enter_context(profile(activities=activities))
        with span(None, "window"):
            t_open = time.perf_counter()
            while True:
                i = len(records) % len(pool.streams)
                if records:
                    with span(records[-1], "Reset"):
                        engine.Reset()
                records.append(run_stream(engine, pool, i, span))
                t_close = time.perf_counter()
                if t_close - t_open >= seconds:
                    break
    if traced:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            summary = trace.summarize(trace.load_events(path))
        del prof
    window_s = t_close - t_open
    print(f"window {window_s:.3f} s, {len(records)} stream(s); the first streams' ms:"
          f" {[round(r.latency_s * 1e3, 1) for r in records[:48]]}", file=sys.stderr)

    dev = {"platform": "gpu" if cuda else "cpu", "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if cuda else 0}
    if cuda:
        dev["power"] = power_limit()
    if summary is not None:
        dev["busy_s"] = summary.busy_s()
        dev["window_s"] = summary.window_s
    del engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    for r in records:
        if r.error:
            print(f"stream {r.index} failed: {r.error}", file=sys.stderr)
    used = sorted({r.index for r in records})
    t_ref = time.perf_counter()
    roots = reference.stream_roots([pool.streams[i] for i in used], int(cell.config["slice_log2"]))
    checks = judge(records, dict(zip(used, roots)))
    print(f"judged {len(records)} root(s) of {len(used)} distinct stream(s) against the reference"
          f" in {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)

    run = Run(cell, setup_s, window_s, records, pool, summary)
    metrics = {}
    for m in cell.metrics:
        value = load_reader(m["name"], bench_dir)(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(records),
        "failed": checks["missing_roots"]["value"],
        "metrics": metrics,
        "device": dev,
    }
    if summary is not None:
        result["breakdown"] = summary.breakdown()
    result["build_s"] = build_s
    result["checks"] = checks
    return result, check_lines(checks)
