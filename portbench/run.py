"""One run of one cell of the port's benchmark on ``cuda:0``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result object; the numbers
compared for ``correct`` are the last lines of standard error.  Without a
CUDA card, without the program in the checkout, or with JAX or the JAX
package loaded once the window has closed, the run prints no result and
exits non-zero.  Nothing falls back to the CPU.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    chips = next((w["chips"] for w in harness.load_bench(ROOT)["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible", file=sys.stderr)
        return 2
    try:
        import vk_merkle_roots_tpu_torch as program
    except ImportError as exc:
        print(f"portbench: the program is not in this checkout: {exc}", file=sys.stderr)
        return 2
    if not Path(program.__file__).resolve().is_relative_to(ROOT):
        print(f"portbench: {program.__name__} was loaded from {program.__file__}, outside {ROOT}", file=sys.stderr)
        return 2

    result, checks = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                                      t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    print("\n".join(checks), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
