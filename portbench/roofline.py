"""The least time an H100 could take for the work a window's inputs need.

A layer's roofline share is that least time over the summed device time of
the layer's kernels in the trace.  The least time is the larger of the
integer operations over the chip's integer peak and the bytes over its
memory bandwidth.  Both count what the inputs need, whatever kernel does the
work, so a kernel that issues fewer instructions does not lower its bound.

Operations per SHA-256 compression, at the fewest sm_90 integer
instructions (3-input ``LOP3`` and ``IADD3``, one ``SHF`` funnel shift per
rotate), counting the 64 rounds and not the message schedule (an
implementation may fold it for constant padding blocks):

* Sigma1(e) = ROTR6 ^ ROTR11 ^ ROTR25: 3 SHF + 1 LOP3 = 4
* Sigma0(a) = ROTR2 ^ ROTR13 ^ ROTR22: 3 SHF + 1 LOP3 = 4
* Ch(e, f, g) and Maj(a, b, c): 1 LOP3 each = 2
* T1 = h + Sigma1 + Ch + K + W, five terms: 2 IADD3; e' = d + T1: 1;
  a' = T1 + Sigma0 + Maj: 1 IADD3 = 4

14 a round, 896 a compression.  In a compression that starts from the
initial hash value (a hash's first block), round 0 sees only constants but
W0: T1, e' and a' are W0 plus constants, 2 additions, so that compression
needs 12 fewer.  The final addition of the state is not counted either.

Leaf hashing needs, per leaf hashed on the device, its padded block count
plus one compression (the second hash), two of them from the initial value;
it reads the leaf once and writes a 32-byte digest.  A node needs three
compressions (its 64-byte message, the padding block, the second hash), two
from the initial value, reads 64 bytes and writes 32.

Peaks: 132 SMs x 64 INT32 lanes a clock x 1.98 GHz (the H100 SXM's
published SM count, INT32 lanes and boost clock) = 1.673e13 integer
operations a second; HBM3 at 3.35e12 bytes a second.
"""

from __future__ import annotations

import numpy as np

OPS_PER_ROUND = 14
OPS_PER_COMPRESSION = 64 * OPS_PER_ROUND
IV_ROUND0_SAVING = OPS_PER_ROUND - 2
INT_OPS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
DIGEST_BYTES = 32


def padded_blocks(lengths: np.ndarray) -> np.ndarray:
    """FIPS 180-4 message blocks of each length (the 0x80 byte and the
    64-bit length included)."""
    return (np.asarray(lengths, np.int64) + 9 + 63) // 64


def hash_ops(compressions: int, hashes: int) -> int:
    """Integer operations of ``compressions`` compressions, of which
    ``2 * hashes`` start from the initial value."""
    return compressions * OPS_PER_COMPRESSION - 2 * hashes * IV_ROUND0_SAVING


def leaf_work(lengths: np.ndarray, device_max_blocks: int) -> tuple[int, int]:
    """(operations, bytes) of hashing the leaves with these lengths that the
    engine hashes on the device (those of at most ``device_max_blocks``
    blocks)."""
    blocks = padded_blocks(lengths)
    on_device = blocks <= device_max_blocks
    n = int(on_device.sum())
    compressions = int(blocks[on_device].sum()) + n
    nbytes = int(np.asarray(lengths, np.int64)[on_device].sum()) + DIGEST_BYTES * n
    return hash_ops(compressions, n), nbytes


def level_nodes(m: int, levels: int | None) -> int:
    """Nodes made reducing ``m`` nodes through ``levels`` levels, an odd
    node paired with itself (None: until one node is left)."""
    nodes = done = 0
    while (m > 1) if levels is None else (done < levels):
        m = (m + 1) // 2
        nodes += m
        done += 1
    return nodes


def device_nodes(n: int, slice_log2: int, host_tail_leaves: int) -> int:
    """Nodes the engine reduces on the device for a stream of ``n`` leaves:
    every full slice, and a ragged last slice above ``host_tail_leaves``
    (to its natural height when it is the only slice, else to the phantom
    full height).  The merge of slice roots runs on the host."""
    cap = 1 << slice_log2
    full, tail = divmod(n, cap)
    nodes = full * (cap - 1)
    if tail > host_tail_leaves:
        nodes += level_nodes(tail, slice_log2 if full else None)
    return nodes


def reduce_work(nodes: int) -> tuple[int, int]:
    """(operations, bytes) of ``nodes`` nodes."""
    return hash_ops(3 * nodes, nodes), nodes * (2 * DIGEST_BYTES + DIGEST_BYTES)


def least_seconds(ops: int, nbytes: int) -> float:
    return max(ops / INT_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def share_percent(ops: int, nbytes: int, kernel_seconds: float) -> float | None:
    """The least time as a percentage of the kernels' time (None when the
    trace holds no time for them)."""
    if kernel_seconds <= 0 or ops <= 0:
        return None
    return 100.0 * least_seconds(ops, nbytes) / kernel_seconds
