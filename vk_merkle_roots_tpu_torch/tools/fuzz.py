"""Seeded randomized differential of the streaming engine on a device.

    python -m vk_merkle_roots_tpu_torch.tools.fuzz [--trials 48] [--start 0] [--device cuda:0 | cpu]

Trial ``i`` draws everything from ``numpy.random.default_rng(9000 + i)``:
the engine's config (``slice_log2`` 3-16; ``batch_leaves`` a power of two
2^2-2^12, which groups slices, or any of 5-5000; ``host_tail_leaves`` 0 or
8192; ``pack_ahead`` 0-3; ``keep_digests`` in about one trial in six;
``device_max_blocks`` cut to 12-40 in about one in six, so that some long
leaves hash on the host), its leaves (1-300 B; in half the trials one leaf in
32 of 1-8 KB, the stream kernel's) and its calls: ``AddMany`` chunks of
random size, a mid-stream ``Root()`` after about one chunk in ten, a
``Drain()`` after one in twenty, one ``Reset()`` in a quarter of the trials.
Every ``Root()`` is held against the native host root of the same leaves
(``CpuSha256D`` fed the same spans), and with ``keep_digests`` the proofs of
a few leaves against it through :func:`..oracle.verify_proof`.

Some trials are fixed on purpose: trial 0 ends in a ragged tail of 2^14 - 1
leaves reduced on the device (14 blocks in one tail launch), trial 1 in a
tail whose largest block has 256 digests (the tail kernel's cluster form),
and trials 2 and 3 of every 16 run ``MeshCudaSha256D`` over the device list,
round robin and with ``sharded_reduce``.

Every check of a trial runs; each that fails counts as a mismatch and
prints a line with the trial's seed and config (``--start <index> --trials
1`` runs it again), and the tool then exits 1.  It runs on ``cuda:0`` unless
``--device`` names another device, and exits 2 if that is a card and none is
visible; ``--device cpu`` runs CPU-sized trials on the plain paths.  The
last line is one JSON summary, with the devices.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import asdict, dataclass, replace

import numpy as np

from .. import _build, oracle
from ..config import EngineConfig
from ..ops.tree_reduce import SOLO_MAX_LOG2

SEED = 9000


@dataclass
class Trial:
    index: int
    seed: int
    kind: str  # "one device", "mesh round robin" or "mesh sharded"
    slice_log2: int
    batch_leaves: int
    host_tail_leaves: int
    pack_ahead: int
    device_max_blocks: int
    keep_digests: bool
    count: int
    long_leaves: bool
    reset: bool  # one Reset() after a chunk drawn in run_trial

    def config(self) -> EngineConfig:
        return EngineConfig(slice_log2=self.slice_log2, batch_leaves=self.batch_leaves,
                            host_tail_leaves=self.host_tail_leaves, pack_ahead=self.pack_ahead,
                            device_max_blocks=self.device_max_blocks, keep_digests=self.keep_digests,
                            sharded_reduce=self.kind == "mesh sharded")


# Trials fixed on purpose (see the module docstring).
FIXED = {
    0: dict(slice_log2=14, batch_leaves=1 << 12, host_tail_leaves=0, count=3 * (1 << 14) - 1, reset=False),
    1: dict(slice_log2=10, batch_leaves=300, host_tail_leaves=0, count=3 * 1024 + 300, reset=False),
}


def draw_trial(index: int, max_slice_log2: int = 16, max_leaves: int = 200_000) -> Trial:
    """Trial ``index``'s config, from ``default_rng(SEED + index)``;
    ``max_slice_log2`` and ``max_leaves`` cut it for the CPU device."""
    rng = np.random.default_rng(SEED + index)
    slice_log2 = int(rng.integers(3, max_slice_log2 + 1))
    batch = int(1 << rng.integers(2, 13)) if rng.random() < 0.5 else int(rng.integers(5, 5001))
    host_tail = int(rng.choice([0, 8192]))
    pack_ahead = int(rng.integers(0, 4))
    host_routed = rng.random() < 1 / 6
    keep_digests = bool(rng.random() < 1 / 6)
    long_leaves = host_routed or bool(rng.random() < 0.5)
    # Bounded so a trial is a few hundred flushes and slices at most.
    count = int(rng.integers(1, min(8 << slice_log2, 200 * batch, max_leaves) + 1))
    reset = bool(rng.random() < 0.25)
    kind = {2: "mesh round robin", 3: "mesh sharded"}.get(index % 16, "one device")
    trial = Trial(index, SEED + index, kind, slice_log2, batch, host_tail, pack_ahead,
                  int(rng.integers(12, 41)) if host_routed else 2048, keep_digests, count, long_leaves, reset)
    trial = replace(trial, **FIXED.get(index, {}))
    return replace(trial, slice_log2=min(trial.slice_log2, max_slice_log2), count=min(trial.count, max_leaves))


def _leaves(trial: Trial, rng, long_max: int):
    """(data, offsets, lengths, leaves) of the trial's stream."""
    lengths = rng.integers(1, 301, trial.count)
    if trial.long_leaves:
        long = rng.random(trial.count) < 1 / 32
        lengths[long] = rng.integers(min(1024, long_max), long_max + 1, int(long.sum()))
    offsets = np.concatenate(([0], np.cumsum(lengths)[:-1])).astype(np.int64)
    data = rng.integers(0, 256, int(lengths.sum()), dtype=np.uint8)
    buf = data.tobytes()
    return data, offsets, lengths.astype(np.int64), [buf[o : o + n] for o, n in zip(offsets.tolist(), lengths.tolist())]


def run_trial(trial: Trial, devices, long_max: int = 8192) -> dict:
    """Drive one trial on ``devices`` (the first for a one-device trial,
    the whole list for a mesh) and hold every root against the native host
    root; returns what it checked and, under ``failures``, a line naming
    each check that failed and the trial."""
    from ..models.cpu import CpuSha256D
    from ..models.cuda import CudaSha256D
    from ..models.mesh import MeshCudaSha256D

    rng = np.random.default_rng([trial.seed, 1])
    data, offsets, lengths, leaves = _leaves(trial, rng, long_max)
    cfg = trial.config()
    engine = CudaSha256D(device=devices[0], config=cfg) if trial.kind == "one device" else \
        MeshCudaSha256D(list(devices), config=cfg)
    ref = CpuSha256D()
    chunks, i = [], 0
    while i < trial.count:
        step = int(rng.integers(1, 3 * min(trial.batch_leaves, trial.count) + 1))
        chunks.append((i, min(trial.count, i + step)))
        i += step
    reset_at = int(rng.integers(0, len(chunks))) if trial.reset else None
    checked = {"roots": 0, "proofs": 0}
    failures = []
    base = 0  # first leaf since the last Reset()

    def fail(what: str) -> None:
        failures.append(f"{what}; trial {asdict(trial)}")

    def check_root(where: str) -> str:
        want, got = ref.Root(), engine.Root()
        checked["roots"] += 1
        if got != want:
            fail(f"{where}: root {got} != native host root {want}")
        return want

    for k, (lo, hi) in enumerate(chunks):
        if not engine.AddMany(leaves[lo:hi]):
            fail(f"AddMany of leaves [{lo}, {hi}) refused")
        ref.AddSpans(data, offsets[lo:hi], lengths[lo:hi])
        u = rng.random()
        if u < 0.1:
            check_root(f"mid-stream Root() after {hi - base} leaves")
        elif u < 0.15 and not engine.Drain():
            fail("Drain() refused")
        if k == reset_at:
            engine.Reset()
            ref.Reset()
            base = hi
    root = check_root(f"final Root() of {trial.count - base} leaves")
    if trial.keep_digests and trial.count > base:
        for j in rng.integers(base, trial.count, 4).tolist():
            got = oracle.verify_proof(oracle.leaf_hash(leaves[j]), engine.Proof(j - base)).hex()
            checked["proofs"] += 1
            if got != root:
                fail(f"the proof of leaf {j - base} folds to {got}, not {root}")
    return dict(checked, leaves=trial.count, failures=failures)


def run(trials, devices, long_max: int = 8192, log=print) -> dict:
    """Run every trial in order and return the summary: trials by kind,
    leaves, roots and proofs checked, the mismatches and their lines, and
    from the kernel counts of :mod:`.._build` (reset first) the most buckets
    in one K1 and one K4 table, the most blocks in one K3 table, and K3's
    launches, those in clusters of CTAs (a block above 2^SOLO_MAX_LOG2
    digests) apart."""
    totals = {"trials": 0, "leaves": 0, "roots": 0, "proofs": 0, "mismatches": 0}
    kinds: dict[str, int] = {}
    failures: list[str] = []
    _build.reset_counts()
    t0 = time.perf_counter()
    for trial in trials:
        t_trial = time.perf_counter()
        got = run_trial(trial, devices, long_max)
        totals["trials"] += 1
        for key in ("leaves", "roots", "proofs"):
            totals[key] += got[key]
        totals["mismatches"] += len(got["failures"])
        failures += got["failures"]
        kinds[trial.kind] = kinds.get(trial.kind, 0) + 1
        log(f"trial {trial.index} (seed {trial.seed}, {trial.kind}): slice 2^{trial.slice_log2}, batch"
            f" {trial.batch_leaves}, host tail {trial.host_tail_leaves}, pack ahead {trial.pack_ahead}, device max"
            f" blocks {trial.device_max_blocks}, keep digests {trial.keep_digests}, {trial.count} leaves"
            f"{' with 1-8 KB ones' if trial.long_leaves else ''}{', reset' if trial.reset else ''}:"
            f" {got['roots']} roots, {got['proofs']} proofs, {len(got['failures'])} mismatches,"
            f" {time.perf_counter() - t_trial:.2f} s")
        for line in got["failures"]:
            log(f"MISMATCH {line}")
    return dict(totals, kinds=kinds, failures=failures, wall_s=time.perf_counter() - t0,
                devices=[str(d) for d in devices],
                leaf_table_max=_build.table_max["leaf_hash_exact"],
                stream_table_max=_build.table_max["leaf_hash_stream"],
                tail_table_max=_build.table_max["tail_reduce"],
                tail_cluster_launches=_build.cluster_launches["tail_reduce"],
                tail_launches=_build.launches["tail_reduce"])


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--trials", type=int, default=48)
    p.add_argument("--start", type=int, default=0, help="index of the first trial")
    p.add_argument("--device", default="cuda:0", help="a card, or cpu for CPU-sized trials on the plain paths")
    a = p.parse_args(argv)
    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"fuzz: no CUDA device visible for {dev}; pass --device cpu for the CPU-sized trials", file=sys.stderr)
        return 2
    small = dev.type == "cpu"  # the plain paths: CPU-sized trials
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    # The mesh trials' devices: every card, or the one device named twice.
    devices = [torch.device("cuda", i) for i in range(cards)] if cards >= 2 else [dev, dev]
    trials = [draw_trial(i, *((5, 64) if small else ())) for i in range(a.start, a.start + a.trials)]
    summary = run(trials, devices, long_max=700 if small else 8192)
    print(json.dumps(summary))
    return 1 if summary["mismatches"] else 0


if __name__ == "__main__":
    sys.exit(main())
