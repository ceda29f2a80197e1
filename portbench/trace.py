"""Arithmetic over a ``torch.profiler`` Chrome trace of one window.

Device busy time is the union of the intervals of every kernel, memcpy and
memset the profiler recorded inside the window (the arithmetic of the
port's ``tools/profile_engine.py``, copied so that the yardstick stays put).
The window and the bench's own spans are ``record_function`` ranges named
``portbench.<name>``; they lie on the same clock as the device events.
"""

from __future__ import annotations

import collections
import json
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "portbench."
WINDOW = SPAN_PREFIX + "window"
BREAKDOWN_ENTRIES = 10


def short_name(name: str) -> str:
    """A kernel's name without its namespace and signature."""
    return name.replace("(anonymous namespace)::", "").split("(")[0].strip()


def merged(intervals) -> list[list[float]]:
    """The union of intervals, as sorted disjoint intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def union_us(intervals) -> float:
    return sum(b - a for a, b in merged(intervals))


@dataclass
class DeviceOp:
    cat: str
    name: str
    ts: float  # us
    dur: float  # us
    nbytes: int | None


@dataclass
class TraceSummary:
    t0: float  # window start, us
    t1: float  # window end, us
    ops: list[DeviceOp] = field(default_factory=list)
    spans: list[tuple[str, float, float]] = field(default_factory=list)  # (name, ts, end), us

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_s(self) -> float:
        return union_us((max(o.ts, self.t0), min(o.ts + o.dur, self.t1)) for o in self.ops) / 1e6

    def kernel_s(self, names) -> float:
        """Summed time of the kernels with these short names."""
        names = set(names)
        return sum(o.dur for o in self.ops if o.cat == "kernel" and short_name(o.name) in names) / 1e6

    def h2d(self) -> tuple[int, float] | None:
        """(bytes, seconds) of the host-to-device copies; None where the
        trace gives no byte count."""
        copies = [o for o in self.ops if o.cat == "gpu_memcpy" and o.name.startswith("Memcpy HtoD")]
        if not copies or any(o.nbytes is None for o in copies):
            return None
        return sum(o.nbytes for o in copies), sum(o.dur for o in copies) / 1e6

    def breakdown(self) -> dict:
        """The device operations that took most time, and the device's idle
        time inside the window by the bench span the host was in."""
        by_op: dict = collections.Counter()
        for o in self.ops:
            label = short_name(o.name) if o.cat == "kernel" else o.name
            by_op[label] += o.dur / 1e6
        busy = merged((max(o.ts, self.t0), min(o.ts + o.dur, self.t1)) for o in self.ops)
        gaps, cur = [], self.t0
        for a, b in busy:
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if cur < self.t1:
            gaps.append((cur, self.t1))
        idle: dict = collections.Counter()
        spans = sorted(self.spans, key=lambda s: s[1])  # sequential: ends are sorted too
        j = 0
        for a, b in gaps:
            covered = 0.0
            while j < len(spans) and spans[j][2] <= a:
                j += 1
            for k in range(j, len(spans)):
                name, s0, s1 = spans[k]
                if s0 >= b:
                    break
                part = min(b, s1) - max(a, s0)
                idle[name] += part / 1e6
                covered += part
            if b - a > covered:
                idle["outside bench spans"] += (b - a - covered) / 1e6
        top = lambda c: [[k, v] for k, v in c.most_common(BREAKDOWN_ENTRIES)]  # noqa: E731
        return {"device_ops": top(by_op), "idle_gaps": top(idle)}


def summarize(events: list[dict]) -> TraceSummary | None:
    """The window's device operations and bench spans (None when the trace
    holds no window range)."""
    windows = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"]
    if not windows:
        return None
    w = windows[0]
    t0, t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    summary = TraceSummary(t0, t1)
    for e in events:
        if e.get("ph") != "X":
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if e.get("cat") in DEVICE_CATS:
            if ts + dur > t0 and ts < t1:
                nbytes = (e.get("args") or {}).get("bytes")
                summary.ops.append(DeviceOp(e["cat"], e["name"], ts, dur,
                                            None if nbytes is None else int(nbytes)))
        elif e.get("name", "").startswith(SPAN_PREFIX) and e["name"] != WINDOW:
            summary.spans.append((e["name"][len(SPAN_PREFIX):], ts, ts + dur))
    return summary


def load_events(path: str) -> list[dict]:
    with open(path) as fh:
        trace = json.load(fh)
    return trace["traceEvents"] if isinstance(trace, dict) else trace
