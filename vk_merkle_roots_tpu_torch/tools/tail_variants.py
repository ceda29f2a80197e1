"""Time variants of the tail kernel K3 beside the one the port ships.

    python -m vk_merkle_roots_tpu_torch.tools.tail_variants    # one CUDA card

Builds ``tools/tail_variants.cu`` with ``nvcc`` into ``_build/`` and times,
with CUDA events, each variant and the shipped kernel (through
:func:`..ops.tree_reduce.tail_reduce_blocks`) on the shapes ``chip_smoke.py``
times: the 16 natural-order group roots of a full grouped slice, one block of
1024 bit-reversed digests, and the ragged tail of 12345 digests that smoke
stream 1 leaves (blocks 8192 + 4096 + 32 + 16 + 8 + 1; the two large blocks
folded to 1024 bit-reversed digests through K2 beforehand, untimed).  The
variants (``tools/tail_variants.cu``): (a) the port's first K3, one CTA a
block and one launch a block, on bit-reversed copies of the natural-order
blocks made beforehand; (b) the cluster kernel with plain node hashes; (c)
(b) with a schedule warp beside each round warp; (d) (c) with the round's
two-input adds on the FMA pipe; (f) (c) with its rounds in one 16-round body
looped 12 times a node; (g) (c) with one unrolled 64-round body looped over
a node's three blocks; (h) (c) with d + h + W[t] + K[t] summed off the
round's chain through e.  (e), a block of more than 1024 digests, is not
built.  Two launch configurations of (c) also run: one CTA
an SM (dynamic shared memory that leaves no room for a second) and clusters
of 8 even where no block is cut.  Then (c), (g) and (h) run once more from a
library built with the kernel's clock stamps (``VKMR_TAIL_STAMP``), which
show where a launch's SM clocks go, level by level and in the cluster
exchange; the timed library carries no stamps.

The calls run in turns, shipped first and last and each variant twice
(shipped, the variants in order, then in reverse, shipped), each into an
output of its own filled with -1, and every variant's roots must equal the
shipped kernel's byte for byte; the shipped roots are held against the plain
version.  The shipped kernel is launched from the port's library on the
tables that :func:`..ops.tree_reduce.tail_reduce_blocks` builds.  Prints one line per shape and, last, one JSON object with every turn's ms
per call, the card's name and power limit and ptxas's registers and shared
memory for each kernel.  Exits 1 without a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from .leaf_variants import REPS, SEED, cuda_ms

_SOURCE = Path(__file__).resolve().parent / "tail_variants.cu"
RAGGED = 12345
PAD_ONE_CTA_AN_SM = 100 * 1024  # dynamic shared memory that leaves room for one CTA an SM
# name -> (form number of vkmrt_launch: vkmr_tail::kTailPlain, kTailPairs,
# kTailPairsImad, kTailPairsRolled, kTailPairsLooped, kTailPairsShortE; dynamic shared memory a
# CTA; clusters of 8 even for blocks of <= 128 digests), or None for (a),
# launched through vkmrt_one_cta.
FORMS = {
    "(a) one CTA a block": None,
    "(b) cluster, plain nodes": (1, 0, 0),
    "(c) cluster + schedule warp": (2, 0, 0),
    "(d) (c) + IMAD adds": (3, 0, 0),
    "(c), one CTA an SM": (2, PAD_ONE_CTA_AN_SM, 0),
    "(c), clusters of 8 always": (2, 0, 1),
    "(f) (c), rolled rounds": (4, 0, 0),
    "(g) (c), one 64-round body": (5, 0, 0),
    "(h) (c), d + h + W + K off the chain": (6, 0, 0),
}
STAMPED = ("(c) cluster + schedule warp", "(g) (c), one 64-round body", "(h) (c), d + h + W + K off the chain")
STAMP_POINTS = {0: "start", 1: "loaded", **{2 + k: f"level {k + 1}" for k in range(10)}, 12: "gather in",
                13: "gather out", 14: "end"}


def build(stamped: bool = False) -> tuple[ctypes.CDLL, str]:
    """The variant library (with the clock stamps when ``stamped``), compiled
    first if no library of the current sources exists, and the compiler's
    output."""
    from .. import _build

    lib, log = _build.build_tool_library(_SOURCE, ("-DVKMRT_STAMPS",) if stamped else ())
    vp = ctypes.c_void_p
    lib.vkmrt_launch.argtypes = [ctypes.c_int, vp, ctypes.c_uint, ctypes.c_int, ctypes.c_int, vp]
    lib.vkmrt_one_cta.argtypes = [vp, ctypes.c_longlong, ctypes.c_int, vp, vp]
    lib.vkmrt_set_stamps.argtypes = [vp]
    for fn in (lib.vkmrt_launch, lib.vkmrt_one_cta, lib.vkmrt_tail_table_bytes, lib.vkmrt_set_stamps):
        fn.restype = ctypes.c_int
    return lib, log


def shapes(dev) -> dict:
    """name -> tail entries of the timed shapes."""
    import torch

    from ..ops import tree_reduce as tr

    rng = np.random.default_rng(SEED)

    def digests(n: int) -> torch.Tensor:
        return torch.from_numpy(rng.integers(0, 2**32, size=(8, n), dtype=np.uint32).view(np.int32)).to(dev)

    out = {f"{1 << k} digests, bit-reversed": [tr.TailEntry(digests(1 << k), k, True)] for k in (0, 1, 4, 7, 8, 10)}
    out["16 group roots, natural"] = [tr.TailEntry(digests(16), 4, False)]
    out[f"{RAGGED}-digest ragged tail"] = tr.ragged_entries(digests(RAGGED), RAGGED)[0]
    return out


def stamps(lib, form, entries, stream) -> list[dict]:
    """One launch of ``form`` with the clock stamps on: for warp 0 of the
    first block's CTAs, the SM and the SM clocks since the CTA's start at
    each point it reached."""
    import torch

    from ..ops import tree_reduce as tr

    dev = entries[0].cols.device
    ctas = len(entries) * (8 if any(e.log2n > 7 for e in entries) else 1)
    buf = torch.zeros((ctas, 4, 16), dtype=torch.int64, device=dev)
    out = torch.full((len(entries), 8), -1, dtype=torch.int32, device=dev)
    if lib.vkmrt_set_stamps(buf.data_ptr()) != 0:
        raise RuntimeError("could not set the stamp buffer")
    try:
        for table in tr.tail_tables(entries, out):
            if lib.vkmrt_launch(form[0], ctypes.addressof(table), 1, form[1], form[2], stream) != 0:
                raise RuntimeError(f"form {form} failed to launch")
        torch.cuda.synchronize()
    finally:
        lib.vkmrt_set_stamps(None)
    rows = []
    for cta in buf[: ctas // len(entries), 0].cpu().numpy():
        if cta[0]:
            rows.append({"sm": int(cta[15]), **{name: int(cta[k] - cta[0]) for k, name in STAMP_POINTS.items()
                                              if k and cta[k]}})
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tail_variants: no CUDA device visible", file=sys.stderr)
        return 1
    from .. import _build
    from ..ops import tree_reduce as tr
    from .perf_model import card

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:  # three nvcc processes at once
        builds = [pool.submit(build, stamped) for stamped in (False, True)] + [pool.submit(_build.load)]
        (lib, log), (stamped_lib, _), _ = [f.result() for f in builds]
    if lib.vkmrt_tail_table_bytes() != ctypes.sizeof(tr.TailTable):
        raise RuntimeError("TailTable of tools/tail_variants.cu differs from ops/tree_reduce.py's")
    build_s = time.perf_counter() - t0
    stream = torch.cuda.current_stream(dev).cuda_stream
    result = {"card": card(dev), "build_seconds": build_s, "ptxas": _build.ptxas_usage(log), "reps": REPS,
              "shapes": {}}

    for title, entries in shapes(dev).items():
        rev = [e.cols if e.bitrev else tr.bitrev_fold_words(e.cols, e.log2n).contiguous() for e in entries]

        def run_form(form, out):
            """Launches of ``form`` (a FORMS value, or "shipped") into ``out``."""
            if form is None:
                def run():
                    for k, x in enumerate(rev):
                        rc = lib.vkmrt_one_cta(x.data_ptr(), x.stride(0), entries[k].log2n, out[k].data_ptr(), stream)
                        if rc != 0:
                            raise RuntimeError(f"the one-CTA kernel failed to launch (error {rc})")
                return run
            tables = tr.tail_tables(entries, out)

            def run():
                for table in tables:
                    if form == "shipped":
                        _build.launch("tail_reduce", "vkmr_tail_reduce", ctypes.addressof(table), stream)
                    elif lib.vkmrt_launch(*form[:1], ctypes.addressof(table), 1, *form[1:], stream) != 0:
                        raise RuntimeError(f"form {form} failed to launch")
            return run

        order = ["shipped", *FORMS, *reversed(FORMS), "shipped"]
        turns: dict[str, list[float]] = {}
        want = None
        for name in order:
            out = torch.full((len(entries), 8), -1, dtype=torch.int32, device=dev)
            turns.setdefault(name, []).append(cuda_ms(run_form(FORMS.get(name, name), out)))
            got = out.cpu().numpy()
            if want is None:
                want = got
                plain = tr.tail_reduce_blocks_plain([e._replace(cols=e.cols.cpu()) for e in entries]).numpy()
                if not np.array_equal(want, plain):
                    raise RuntimeError(f"{title}: the shipped kernel differs from the plain version")
            elif not np.array_equal(got, want):
                raise RuntimeError(f"{title}: variant {name!r} differs from the shipped kernel")
        result["shapes"][title] = {"blocks": [e.log2n for e in entries], "ms": turns,
                                   "stamps": {name: stamps(stamped_lib, FORMS[name], entries, stream) for name in STAMPED}}
        print(f"{title} (blocks 2^{', 2^'.join(str(e.log2n) for e in entries)}): "
              + "; ".join(f"{k} {', '.join(f'{t:.4f}' for t in v)}" for k, v in turns.items()) + " ms", flush=True)
    for title, shape in result["shapes"].items():
        for name, rows in shape["stamps"].items():
            print(f"stamps, {title}, {name} (SM clocks since the CTA's start, warp 0):")
            for row in rows:
                print("   ", json.dumps(row))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
