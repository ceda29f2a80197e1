"""Time variants of the leaf kernels K1 and K4 beside the ones the port ships.

    python -m vk_merkle_roots_tpu_torch.tools.leaf_variants    # one CUDA card

Builds ``tools/leaf_variants.cu`` with ``nvcc`` into ``_build/`` and times,
with CUDA events, each variant and the shipped kernel (through
:func:`..ops.leaf_hash.exact_hash_buckets_into` /
:func:`..ops.leaf_hash.stream_hash_buckets_into`) on the shapes
``chip_smoke.py`` times: a 2^16-leaf ``rndm`` 127 B flush packed bit-reversed
(K1), 2^18 such leaves in one launch (K1), the same flush with one leaf in 64
replaced by 1-8 KB (K4's stream rungs), and one 64-block leaf alone (K4's
chain floor).  The variants: both kernels with ``vkmr::compress`` (shipped)
and with ``compress_ahead`` (h + K[t] + W[t] summed a round early); K1 with
one leaf a thread (shipped) and with two; K4 with the next block loaded into
registers and with ``cp.async`` into double-buffered shared memory
(shipped).  The variants the port ships run here too, from this library, as
a check that the library times what the port's does.

The calls run in turns, shipped first and last and each variant twice
(shipped, v1, v2, ..., v2, v1, shipped), each into an output of its own
filled with -1, and every variant's digests must equal the shipped kernel's
byte for byte.  Prints one line per shape and, last, one JSON object with
every turn's ms per call, the card's name and power limit and ptxas's
registers and shared memory for each variant kernel.  Exits 1 without a
CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import sys
import time
from pathlib import Path

import numpy as np

_SOURCE = Path(__file__).resolve().parent / "leaf_variants.cu"
SEED = 1712489279
REPS = 20

# name -> variant number in leaf_variants.cu's vkmrv_launch
EXACT_VARIANTS = {"one leaf, compress": 0, "one leaf, compress_ahead": 1,
                  "two leaves, compress": 2, "two leaves, compress_ahead": 3}
STREAM_VARIANTS = {"registers, compress": 4, "registers, compress_ahead": 5,
                   "cp.async, compress": 6, "cp.async, compress_ahead": 7}
TWO_LEAVES = (2, 3)


def build() -> tuple[ctypes.CDLL, str]:
    """The variant library, compiled first if no library of the current
    sources exists, and the compiler's output."""
    from .. import _build

    lib, log = _build.build_tool_library(_SOURCE)
    lib.vkmrv_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.vkmrv_launch.restype = ctypes.c_int
    lib.vkmrv_leaf_table_bytes.restype = ctypes.c_int
    return lib, log


def cuda_ms(fn, reps: int = REPS) -> float:
    """Mean ms per call over ``reps`` calls after 50 ms of warm-up.  The card
    spins before the window opens, and the window counts only if every
    launch was queued while it still spun (the start event not yet reached);
    else it runs again after a spin four times as long."""
    import torch

    t_warm = time.perf_counter()
    while time.perf_counter() - t_warm < 0.05:
        fn()
        torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for spin in (5_000_000, 20_000_000, 80_000_000, 320_000_000):  # ~2.5 ms to ~160 ms
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_in_time = not start.query()
        end.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / reps
    raise RuntimeError("the host could not queue a timing window's launches within a ~160 ms spin")


def shapes(dev) -> dict:
    """name -> (buckets, n output columns, exact) of the timed shapes."""
    from ..native.lib import native_rndm_stream
    from ..ops import leaf_hash as lh
    from ..packing import pack_spans, split_lines
    from ..utils.bitmath import bit_reverse_indices

    rng = np.random.default_rng(SEED)
    flush = native_rndm_stream(SEED, 1 << 16, 127)
    data, offs, lens = split_lines(flush)
    perm = bit_reverse_indices(16)
    exact, _ = lh.flush_buckets(pack_spans(data, offs[perm], lens[perm], 2048), dev)
    lines = flush.split(b"\n")[:-1]
    for i, n in enumerate(rng.integers(1024, 8193, 1024)):
        lines[64 * i] = rng.integers(32, 127, size=int(n), dtype=np.uint8).tobytes()
    data2, offs2, lens2 = split_lines(b"\n".join(lines) + b"\n")
    _, rungs = lh.flush_buckets(pack_spans(data2, offs2[perm], lens2[perm], 2048), dev)
    quad, _ = lh.flush_buckets(pack_spans(*split_lines(native_rndm_stream(SEED + 1, 1 << 18, 127)), 2048), dev)
    lone = rng.integers(32, 127, size=64 * 64 - 9, dtype=np.uint8).tobytes() + b"\n"
    _, (one,) = lh.flush_buckets(pack_spans(*split_lines(lone)), dev)
    return {
        "K1 2^16-leaf rndm flush": (exact, 1 << 16, True),
        "K1 2^18 rndm leaves": (quad, 1 << 18, True),
        "K4 stream-2 flush": (rungs, 1 << 16, False),
        "K4 one 64-block leaf": ([one], 1, False),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("leaf_variants: no CUDA device visible", file=sys.stderr)
        return 1
    from .. import _build
    from ..ops import leaf_hash as lh
    from .perf_model import card

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    lib, log = build()
    if lib.vkmrv_leaf_table_bytes() != ctypes.sizeof(lh.LeafTable):
        raise RuntimeError("LeafTable of tools/leaf_variants.cu differs from ops/leaf_hash.py's")
    _build.load()
    build_s = time.perf_counter() - t0
    ptxas = _build.ptxas_usage(log)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    result = {"card": card(dev), "build_seconds": build_s, "ptxas": ptxas, "reps": REPS, "shapes": {}}

    for title, (buckets, n, exact) in shapes(dev).items():
        def fresh():
            return torch.full((8, n), -1, dtype=torch.int32, device=dev)

        def cols(t: torch.Tensor) -> np.ndarray:
            a = t.cpu().numpy()
            return np.concatenate([a[:, b.col : b.col + b.count] for b in buckets], axis=1)

        def shipped(out):
            return lambda: (lh.exact_hash_buckets_into if exact else lh.stream_hash_buckets_into)(buckets, out)

        def variant(number, out):
            per_cta = (2 * lh.EXACT_CTA_THREADS if number in TWO_LEAVES else lh.EXACT_CTA_THREADS) if exact \
                else lh.stream_leaves_per_warp(sum(b.count for b in buckets), sms)
            tables = lh.launch_tables(buckets, out, per_cta)

            def run():
                for table, ctas in tables:
                    rc = lib.vkmrv_launch(number, ctypes.addressof(table), ctas, stream)
                    if rc != 0:
                        raise RuntimeError(f"variant {number} failed to launch (error {rc})")
            return run

        variants = EXACT_VARIANTS if exact else STREAM_VARIANTS
        order = ["shipped", *variants, *reversed(variants), "shipped"]
        turns: dict[str, list[float]] = {}
        want = None
        for name in order:
            out = fresh()
            fn = shipped(out) if name == "shipped" else variant(variants[name], out)
            turns.setdefault(name, []).append(cuda_ms(fn))
            got = cols(out)
            if want is None:
                want = got
                if (want == -1).all(axis=0).any():
                    raise RuntimeError(f"{title}: the shipped kernel left columns unwritten")
            elif not np.array_equal(got, want):
                raise RuntimeError(f"{title}: variant {name!r} differs from the shipped kernel")
        blocks = sum(b.count * b.nblocks for b in buckets) if exact else \
            int(sum(int(b.counts[: b.count].sum()) for b in buckets))
        result["shapes"][title] = {"buckets": len(buckets), "leaves": sum(b.count for b in buckets),
                                   "blocks": blocks, "ms": turns}
        print(f"{title} ({len(buckets)} buckets, {sum(b.count for b in buckets)} leaves, {blocks} blocks): "
              + "; ".join(f"{k} {', '.join(f'{t:.4f}' for t in v)}" for k, v in turns.items()) + " ms", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
