"""The perf model's inputs on the H100: op counts, issue probes, SASS counts.

Port of ``vk_merkle_roots_tpu/ops/perf_probe.py``, which imports JAX at the
top, so its constants are carried over here and held equal to it by the CPU
tests (``tests/test_torch_perf_probe.py``).

* :func:`count_vector_ops`: the JAX package's per-lane uint32 ALU op counts
  of each compression variant, traced there from the kernels' own math.  They
  stay the roofline's work count, the same whatever implements the kernels.
* :func:`alu_probe` / :func:`rot_probe` (``csrc/perf_probe.cu``) replace the
  Pallas probes ``_probe_kernel`` (:117) and ``_rot_probe_kernel`` (:188):
  16 chains of dependent u32 ops with no memory traffic in the loop.  Each
  wrapper launches its kernel for a CUDA tensor and runs its plain PyTorch
  version for a CPU tensor; the bits are the TPU kernels'.
* :func:`alu_issue_probe` / :func:`rot_issue_probe` time them with CUDA
  events, in nominal lane-ops/s (the JAX unit: one op of the Pallas body on
  one of a vreg's 1024 lanes).
* :func:`sass_counts` counts the built library's SASS instructions by opcode
  (``cuobjdump -sass``): what the card really issues for each kernel.
"""

from __future__ import annotations

import copy
import re
import subprocess

import numpy as np
import torch

from .. import _build
from ..constants import TILE, TILE_LANE, TILE_SUB
from . import sha256_core as core

PROBE_ROUNDS = 1024  # nominal ops per chain pass (perf_probe.py:105)
PROBE_PASSES = 32  # passes of the unrolled block per launch (perf_probe.py:106)
PROBE_CHAINS = 16
ALU_PROBE_SEED, ROT_PROBE_SEED = 7, 9  # perf_probe.py:254, :270

# count_vector_ops() of the JAX package (perf_probe.py:63), per primitive.
_OP_COUNTS = {
    "compress": {"xor": 705, "shift_right_logical": 672, "shift_left": 576, "or": 576, "add": 600, "and": 128,
                 "total": 3257},
    "compress_const_schedule": {"xor": 513, "shift_right_logical": 384, "shift_left": 384, "or": 384, "add": 392,
                                "and": 128, "total": 2185},
    "finalize_sha256d": {"add": 623, "shift_right_logical": 636, "shift_left": 550, "or": 550, "xor": 675,
                         "and": 126, "total": 3160},
    "node_hash": {"add": 1665, "shift_right_logical": 1686, "shift_left": 1504, "or": 1504, "xor": 1883,
                  "and": 380, "total": 8622},
    "leaf_127B": {"add": 2473, "shift_right_logical": 2646, "shift_left": 2272, "or": 2272, "xor": 2780,
                  "and": 508, "total": 12951},
}

# Kernels of the built library, by the names in their mangled symbol (K1's
# two forms by the type of their table).
SASS_KERNELS = {
    "leaf_hash_exact": ("leaf_hash_exact_kernel", "LeafTable"),
    "leaf_hash_wire": ("leaf_hash_exact_kernel", "WireTable"),
    "leaf_hash_stream": ("leaf_hash_stream_kernel",),
    "fold_level": ("fold_level_kernel",),
    "tail_reduce": ("tail_reduce_kernel",),
    "alu_probe": ("alu_probe_kernel",),
    "rot_probe": ("rot_probe_kernel",),
}
# Opcodes of the integer pipes (IMAD runs on the FMA pipe, and nvcc issues
# adds and moves as IMAD too).
INTEGER_OPCODES = frozenset({
    "IADD3", "IADD", "IADD32I", "IMAD", "IMUL", "LEA", "LOP3", "LOP", "LOP32I", "SHF", "SHL", "SHR",
    "PRMT", "IABS", "IMNMX", "BMSK", "BREV", "FLO", "POPC", "SGXT",
})


def count_vector_ops() -> dict[str, dict[str, int]]:
    """Per-lane uint32 ALU op counts of each compression variant, as the JAX
    package traces them: ``compress``, ``compress_const_schedule``,
    ``finalize_sha256d``, ``node_hash`` (one interior node) and
    ``leaf_127B`` (one 3-block leaf), each with its per-primitive breakdown
    and ``total``."""
    return copy.deepcopy(_OP_COUNTS)


# ------------------------------------------------------------------ probes

def probe_input(seed: int, tiles: int) -> np.ndarray:
    """The probes' input, ``(tiles, 16, 8, 128)`` uint32 words below 2^30."""
    return np.random.default_rng(seed).integers(0, 1 << 30, (tiles, PROBE_CHAINS, TILE_SUB, TILE_LANE), np.uint32)


def _xor_out(regs) -> torch.Tensor:
    acc = regs[0]
    for r in regs[1:]:
        acc = acc ^ r
    return core.from_words(acc).unsqueeze(1)


def alu_probe_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the ALU probe: ``(tiles, 16, 8, 128)`` int32 ->
    ``(tiles, 1, 8, 128)`` int32, the ops of ``_probe_kernel`` in order."""
    regs = [core.to_words(x[:, j]) for j in range(PROBE_CHAINS)]
    for _ in range(PROBE_PASSES):
        for t in range(PROBE_ROUNDS):
            j, k, op = t % 16, (t + 5) % 16, t % 4
            if op == 0:
                regs[j] = (regs[j] + regs[k]) & core.MASK
            elif op == 1:
                regs[j] = regs[j] ^ regs[k]
            elif op == 2:
                regs[j] = regs[j] >> ((j % 7) + 1)
            else:
                regs[j] = regs[j] | regs[k]
    return _xor_out(regs)


def rot_probe_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the rotate probe: each round ``rotr(x, c) ^ y``, the
    ops of ``_rot_probe_kernel`` in order."""
    regs = [core.to_words(x[:, j]) for j in range(PROBE_CHAINS)]
    for _ in range(PROBE_PASSES):
        for t in range(PROBE_ROUNDS // 4):
            j, k = t % 16, (t + 5) % 16
            regs[j] = core.rotr(regs[j], (t % 7) + 1) ^ regs[k]
    return _xor_out(regs)


def _probe(x: torch.Tensor, name: str, fn: str, plain) -> torch.Tensor:
    if x.dtype != torch.int32 or x.dim() != 4 or x.shape[1:] != (PROBE_CHAINS, TILE_SUB, TILE_LANE):
        raise ValueError(f"want (tiles, 16, 8, 128) int32 words, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("probe input must be contiguous")
    if x.device.type == "cpu":
        _build.plain_calls[name] += 1
        return plain(x)
    tiles = x.shape[0]
    out = torch.empty((tiles, 1, TILE_SUB, TILE_LANE), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        _build.launch(name, fn, x.data_ptr(), out.data_ptr(), tiles, _build.stream_of(x))
    return out


def alu_probe(x: torch.Tensor) -> torch.Tensor:
    """K5: 16 chains of add/xor/shift-right/or, 32 passes of 1024 ops."""
    return _probe(x, "alu_probe", "vkmr_alu_probe", alu_probe_plain)


def rot_probe(x: torch.Tensor) -> torch.Tensor:
    """K6: 16 chains of ``rotr(x, c) ^ y``, 32 passes of 256 rounds."""
    return _probe(x, "rot_probe", "vkmr_rot_probe", rot_probe_plain)


def spread(values) -> dict:
    v = np.asarray(values, np.float64)
    return {"median": float(np.median(v)), "min": float(v.min()), "max": float(v.max()), "n": int(v.size)}


def time_launches(fn, device, iters: int, reps: int = 5) -> list[float]:
    """Seconds per call of ``fn`` on ``device``, CUDA events: one warm-up,
    then ``reps`` times ``iters`` back-to-back calls between two events."""
    with torch.cuda.device(device):
        fn()
        torch.cuda.synchronize()
        secs = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            secs.append(start.elapsed_time(end) / 1e3 / iters)
    return secs


def _issue_probe(probe, seed: int, device, tiles: int, iters: int, reps: int) -> dict:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the issue probes time a CUDA card, not {device}")
    x = torch.from_numpy(probe_input(seed, tiles).view(np.int32)).to(device)
    secs = time_launches(lambda: probe(x), device, iters, reps)
    lane_ops = tiles * PROBE_PASSES * PROBE_ROUNDS * TILE
    return {
        "lane_ops_per_sec": spread([lane_ops / s for s in secs]),
        "ms_per_launch": spread([s * 1e3 for s in secs]),
        "ms_samples": [s * 1e3 for s in secs],
        "lane_ops_per_launch": lane_ops,
        "tiles": tiles,
        "iters": iters,
    }


def alu_issue_probe(device, tiles: int = 256, iters: int = 20, reps: int = 5) -> dict:
    """Nominal lane-ops/s of K5 on a CUDA ``device``, ``{median, min, max, n}``
    over ``reps`` runs of ``iters`` launches; ``tiles * 32 * 1024 * 1024``
    lane-ops a launch."""
    return _issue_probe(alu_probe, ALU_PROBE_SEED, device, tiles, iters, reps)


def rot_issue_probe(device, tiles: int = 256, iters: int = 20, reps: int = 5) -> dict:
    """Nominal lane-ops/s of K6 (4 nominal ops a round: two shifts, an or and
    a xor).  Above :func:`alu_issue_probe`'s rate, the compiler fuses the
    rotate idiom."""
    return _issue_probe(rot_probe, ROT_PROBE_SEED, device, tiles, iters, reps)


# -------------------------------------------------------------------- SASS

_SASS_LINE = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)\s*(.*)$")
_BRANCH_TARGET = re.compile(r"(0x[0-9a-f]+)")


def _tally(instrs) -> dict:
    by_opcode: dict[str, int] = {}
    for _, op, _ in instrs:
        by_opcode[op] = by_opcode.get(op, 0) + 1
    return {
        "total": len(instrs),
        "integer": sum(n for op, n in by_opcode.items() if op in INTEGER_OPCODES),
        "by_opcode": dict(sorted(by_opcode.items(), key=lambda kv: (-kv[1], kv[0]))),
    }


def parse_sass(text: str) -> dict[str, dict]:
    """Instruction counts of each kernel in ``cuobjdump -sass`` output, keyed
    by :data:`SASS_KERNELS`' short names.  Each entry holds ``total``,
    ``integer`` and ``by_opcode`` (base opcode, modifiers dropped) for the
    whole kernel, and ``loop``, the same for its longest backward branch's
    body (the probes' pass loop), or None where the kernel has no loop."""
    functions: dict[str, list] = {}
    current = None
    for line in text.splitlines():
        if "Function : " in line:
            symbol = line.split("Function : ", 1)[1].strip()
            current = next((short for short, names in SASS_KERNELS.items() if all(n in symbol for n in names)), None)
            if current is not None:
                functions[current] = []
            continue
        m = _SASS_LINE.match(line)
        if m and current is not None:
            functions[current].append((int(m.group(1), 16), m.group(2), m.group(4).split(";", 1)[0]))
    out = {}
    for short, instrs in functions.items():
        entry = _tally(instrs)
        loop = None
        for addr, op, args in instrs:
            target = _BRANCH_TARGET.search(args) if op == "BRA" else None
            if target and int(target.group(1), 16) < addr:
                lo = int(target.group(1), 16)
                if loop is None or addr - lo > loop[1] - loop[0]:
                    loop = (lo, addr)
        entry["loop"] = _tally([i for i in instrs if loop[0] <= i[0] <= loop[1]]) if loop else None
        out[short] = entry
    return out


def sass_counts() -> dict[str, dict]:
    """:func:`parse_sass` of ``cuobjdump -sass`` on the built kernel library
    (built first if needed).  Raises if ``cuobjdump`` is missing or fails, or
    if a kernel of :data:`SASS_KERNELS` is not in its output."""
    _build.load()
    proc = subprocess.run([_build.cuda_tool("cuobjdump"), "-sass", str(_build.library_path())],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump -sass failed (exit {proc.returncode}): {proc.stderr[-2000:]}")
    counts = parse_sass(proc.stdout)
    missing = sorted(set(SASS_KERNELS) - set(counts))
    if missing:
        raise RuntimeError(f"cuobjdump -sass shows no code for {missing}")
    return counts
