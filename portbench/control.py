"""The control of ``correct``: the reference with one stated guarantee
broken, put in the program's place and judged as a run is judged.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

The configurations state a byte-exact SHA-256d root.  The control hashes
each leaf once, SHA256(line) (``reference.stream_roots(...,
single_hash=True)``): the shortcut that would halve the leaf kernels' work.
It breaks every stream, a power-of-two leaf count with no odd node
included.  For each seed it makes the cell's pool at the cell's
own sizes, roots every stream of it both ways, and judges the control's
roots with the harness's ``judge``.  One JSON line per seed; the exit code
is 0 only when every seed's control comes out not correct.  Benchmark runs
do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control(root: Path, workload: str, seed: int) -> dict:
    from portbench import harness, reference
    from portbench.streams import make_pool

    cell = harness.resolve(harness.load_bench(root), workload, False, Path(root) / harness.BENCH_DIR.name)
    pool = make_pool(cell.config, cell.traffic, seed)
    height = int(cell.config["slice_log2"])
    want = reference.stream_roots(pool.streams, height)
    got = reference.stream_roots(pool.streams, height, single_hash=True)
    records = [harness.StreamRecord(i, len(s), n, root=r)
               for i, (s, n, r) in enumerate(zip(pool.streams, pool.leaves, got))]
    checks = harness.judge(records, dict(enumerate(want)))
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return {"workload": workload, "seed": seed, "judged": len(records), "correct": correct, "checks": checks}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    failed_all = True
    for seed in args.seeds:
        t = time.perf_counter()
        out = control(ROOT, args.workload, seed)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
        failed_all = failed_all and not out["correct"]
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
