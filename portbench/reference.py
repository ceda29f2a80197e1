"""The plain reference: the SHA-256d Merkle root of a newline-separated
stream, in ``hashlib`` and NumPy, written apart from the program.

Semantics (upstream ``vkmr``: README.md:87-96, SHA-256plus.cpp:491-561,
Reductions.cpp:293):

* every non-empty line is a leaf, hashed SHA256(SHA256(line)); empty lines
  are skipped;
* an interior node is SHA256(SHA256(left || right)) over raw 32-byte
  digests, and an odd node at the end of a level is paired with itself;
* leaves fall into slices of ``2^slice_log2``; a stream of one slice is
  reduced to its natural height; with several slices, each (the ragged last
  one too) is reduced through exactly ``slice_log2`` levels, pairing a lone
  node with itself (the phantom full height), and the slice roots are then
  merged in order as the leaves of an ordinary tree.

The work is cut into aligned blocks of ``2^BLOCK_LOG2`` leaves, so that
one block's lines and digests are held as Python objects at a time: pairs
never cross an aligned block, and the odd node of a level lies in its last
block, so each block reduces on its own for ``BLOCK_LOG2`` levels and the
parent goes on from the block roots.  Everything runs in the calling
process, which starts no other.

``single_hash=True`` is the control: each leaf is hashed once,
SHA256(line), not SHA-256d, which breaks the stated semantics.
"""

from __future__ import annotations

import hashlib

import numpy as np

BLOCK_LOG2 = 14

_sha = hashlib.sha256


def reduce_levels(level: list[bytes], levels: int | None) -> list[bytes]:
    """Reduce ``levels`` levels (None: until one node is left)."""
    done = 0
    while (len(level) > 1) if levels is None else (done < levels):
        nxt = [_sha(_sha(level[i] + level[i + 1]).digest()).digest() for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(_sha(_sha(level[-1] + level[-1]).digest()).digest())
        level = nxt
        done += 1
    return level


def block_root(chunk: bytes, levels: int | None, single_hash: bool = False) -> bytes:
    """Root of the leaves (lines) in ``chunk`` after ``levels`` levels."""
    lines = [line for line in chunk.split(b"\n") if line]
    digests = [_sha(line).digest() for line in lines] if single_hash else [_sha(_sha(line).digest()).digest() for line in lines]
    (root,) = reduce_levels(digests, levels)
    return root


def line_bounds(stream: bytes) -> tuple[np.ndarray, np.ndarray]:
    """(start, end) byte offsets of the non-empty lines of ``stream``."""
    arr = np.frombuffer(stream, np.uint8)
    nl = np.flatnonzero(arr == 0x0A)
    starts = np.concatenate(([0], nl + 1))
    ends = np.concatenate((nl, [arr.size]))
    keep = ends > starts
    return starts[keep], ends[keep]


def _tasks(stream: bytes, slice_log2: int, single_hash: bool):
    """Per slice: its height (None: natural) and its block tasks."""
    starts, ends = line_bounds(stream)
    n = starts.size
    if n == 0:
        raise ValueError("a stream with no leaf has no root")
    cap = 1 << slice_log2
    several = n > cap
    k = min(BLOCK_LOG2, slice_log2)
    plan = []
    for s0 in range(0, n, cap):
        m = min(cap, n - s0)
        height = slice_log2 if several else None
        if height is None and m <= (1 << k):
            blocks = [(stream[starts[s0] : ends[s0 + m - 1]], None, single_hash)]
            plan.append((0, blocks))
            continue
        blocks = [
            (stream[starts[b0] : ends[min(b0 + (1 << k), s0 + m) - 1]], k, single_hash)
            for b0 in range(s0, s0 + m, 1 << k)
        ]
        plan.append((None if height is None else height - k, blocks))
    return plan


def stream_roots(streams: list[bytes], slice_log2: int, single_hash: bool = False) -> list[str]:
    """Hex roots of ``streams``."""
    plans = [_tasks(s, slice_log2, single_hash) for s in streams]
    block_roots = [block_root(*task) for plan in plans for _, blocks in plan for task in blocks]
    out, i = [], 0
    for plan in plans:
        slice_roots = []
        for rest, blocks in plan:
            level, i = block_roots[i : i + len(blocks)], i + len(blocks)
            (root,) = reduce_levels(level, rest)
            slice_roots.append(root)
        (root,) = reduce_levels(slice_roots, None)
        out.append(root.hex())
    return out
