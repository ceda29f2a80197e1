"""Tree reduction: word-major digest columns -> Merkle root, on the device.

Port of ``vk_merkle_roots_tpu/ops/tree_reduce.py``.  Digests of a 2^k-leaf
block are stored at the bit reversal of their leaf index, so every tree
level is ``out[:, i] = node(x[:, i], x[:, i + n/2])``: an elementwise fold
(``docs/DESIGN.md`` §2).  Two kernels, each behind a wrapper that launches
it for a CUDA tensor and runs the plain PyTorch version for a CPU tensor:

* :func:`fold_level` (``csrc/tree_reduce.cu::fold_level_kernel``) replaces
  the Pallas ``_fold_kernel`` (``tree_reduce.py:91``), flat or per group;
* :func:`tail_reduce_blocks` (``csrc/tail_reduce.cuh::tail_reduce_kernel``)
  replaces the Pallas ``_tail_kernel`` (``tree_reduce.py:157``): every
  perfect block of <= 1024 digests of a table to its root in one launch,
  each block in natural order or bit-reversed; :func:`tail_reduce` is its
  one-block form.

On the card every level above 1024 digests is one :func:`fold_level`
launch and the rest one :func:`tail_reduce_blocks` launch, for blocks of any
size: a fold in plain PyTorch would cost thousands of small launches per
level.  Ragged slices decompose into perfect blocks whose roots all come
from one tail launch and combine on the host (:func:`combine_ragged`), as in
the JAX package.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .. import _build, oracle
from ..utils.bitmath import bit_reverse_indices, ceil_log2, is_pow2
from ..utils.hexutil import words_to_digest
from . import sha256_core as core

TAIL_MAX_LOG2 = 10  # the tail kernel's capacity: 1024 digests a block
MAX_TAIL_BLOCKS = 32  # kMaxTailBlocks of csrc/tail_reduce.cuh; more blocks take more launches
SOLO_MAX_LOG2 = 7  # kSoloMaxLog2 of csrc/tail_reduce.cuh: a table with a larger block runs in clusters of CTAs


class TailEntry(NamedTuple):
    """One perfect block as the tail kernel takes it."""

    cols: torch.Tensor  # (8, 2^log2n) int32 digest columns, unit column stride
    log2n: int
    bitrev: bool  # True: stored bit-reversed (fold input); False: natural order


class _TailBlock(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("ld", ctypes.c_longlong), ("log2n", ctypes.c_int),
                ("bitrev", ctypes.c_int), ("out_row", ctypes.c_int), ("pad", ctypes.c_int)]


class TailTable(ctypes.Structure):
    """``TailTable`` of ``csrc/tail_reduce.cuh``: the kernel's table."""

    _fields_ = [("out", ctypes.c_void_p), ("n", ctypes.c_int), ("pad", ctypes.c_int),
                ("b", _TailBlock * MAX_TAIL_BLOCKS)]


@lru_cache(maxsize=None)
def bitrev_index(log2n: int, device: torch.device) -> torch.Tensor:
    """``out[i]`` = the log2n-bit reversal of i, as an int64 index tensor."""
    return torch.from_numpy(bit_reverse_indices(log2n)).to(device)


def words_to_bytes(words: torch.Tensor) -> bytes:
    """(8,) int32 digest words on any device -> the canonical 32 bytes."""
    return words_to_digest(words.cpu().numpy().view(np.uint32))


def _check_cols(x: torch.Tensor) -> None:
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[0] != 8:
        raise ValueError(f"want (8, n) int32 digest columns, got {x.dtype} {tuple(x.shape)}")
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError("digest columns must have unit column stride")


def fold_level_plain(x: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """Plain version of the fold kernel: (8, n) -> (8, n/2), each of
    ``groups`` contiguous groups folding its own halves."""
    n = x.shape[1]
    y = core.to_words(x).reshape(8, groups, 2, n // (2 * groups))
    left = [y[j, :, 0].reshape(-1) for j in range(8)]
    right = [y[j, :, 1].reshape(-1) for j in range(8)]
    return core.from_words(torch.stack(core.node_hash_words(left, right)))


def fold_level(x: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """One Merkle level over bit-reversed storage: (8, n) -> (8, n/2),
    ``out[:, g*m/2 + i] = node(x[:, g*m + i], x[:, g*m + m/2 + i])`` for each
    of ``groups`` groups of m = n/groups columns (the group-bitrev layout;
    ``groups=1`` is a whole-array level)."""
    _check_cols(x)
    n = x.shape[1]
    if not (is_pow2(n) and is_pow2(groups) and n // groups >= 2):
        raise ValueError(f"fold needs power-of-two n={n} and groups={groups} with n/groups >= 2")
    if x.device.type == "cpu":
        _build.plain_calls["fold_level"] += 1
        return fold_level_plain(x, groups)
    out = torch.empty((8, n // 2), dtype=torch.int32, device=x.device)
    log2_half_group = (n // groups).bit_length() - 2
    with torch.cuda.device(x.device):
        _build.launch(
            "fold_level", "vkmr_fold_level",
            x.data_ptr(), x.stride(0), out.data_ptr(), out.stride(0), n // 2, log2_half_group,
            _build.stream_of(x),
        )
    return out


def tail_reduce_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the tail kernel on one bit-reversed block: fold
    level by level to (8,)."""
    while x.shape[1] > 1:
        x = fold_level_plain(x)
    return x[:, 0].clone()


def tail_reduce_blocks_plain(entries) -> torch.Tensor:
    """Plain version of :func:`tail_reduce_blocks`: each block (natural
    order bit-reversed first) through :func:`tail_reduce_plain`."""
    return torch.stack([tail_reduce_plain(e.cols if e.bitrev else bitrev_fold_words(e.cols, e.log2n))
                        for e in entries])


def _check_entries(entries) -> None:
    if not entries:
        raise ValueError("the tail kernel takes at least one block")
    for e in entries:
        _check_cols(e.cols)
        if not (isinstance(e.log2n, int) and 0 <= e.log2n <= TAIL_MAX_LOG2 and e.cols.shape[1] == 1 << e.log2n):
            raise ValueError(f"the tail takes a power of two <= 1024 digests a block, got {tuple(e.cols.shape)}"
                             f" with log2n={e.log2n}")
        if e.cols.device != entries[0].cols.device:
            raise ValueError(f"blocks on {e.cols.device} and {entries[0].cols.device}")


def tail_tables(entries, out: torch.Tensor) -> list[TailTable]:
    """The kernel tables of ``entries``, one per launch: blocks with the most
    digests first, each with its output row (its index in ``entries``); past
    :data:`MAX_TAIL_BLOCKS` blocks they go on in another table."""
    order = sorted(range(len(entries)), key=lambda k: -entries[k].log2n)
    tables = []
    for lo in range(0, len(order), MAX_TAIL_BLOCKS):
        part = order[lo : lo + MAX_TAIL_BLOCKS]
        table = TailTable(out=out.data_ptr(), n=len(part))
        for j, k in enumerate(part):
            e = entries[k]
            table.b[j] = _TailBlock(e.cols.data_ptr(), e.cols.stride(0), e.log2n, int(e.bitrev), k, 0)
        tables.append(table)
    return tables


def tail_reduce_blocks(entries) -> torch.Tensor:
    """Roots of perfect blocks of <= 1024 digests each: a list of
    :class:`TailEntry` -> (B, 8) int32 root words, row k for ``entries[k]``,
    not yet read back.  One kernel launch on the card (per
    :data:`MAX_TAIL_BLOCKS` blocks), the plain version on the CPU."""
    _check_entries(entries)
    if entries[0].cols.device.type == "cpu":
        _build.plain_calls["tail_reduce"] += 1
        return tail_reduce_blocks_plain(entries)
    out = torch.empty((len(entries), 8), dtype=torch.int32, device=entries[0].cols.device)
    _launch_tail(entries, out)
    return out


def _launch_tail(entries, out: torch.Tensor) -> None:
    with torch.cuda.device(out.device):
        for table in tail_tables(entries, out):
            # A table's largest block comes first.
            _build.launch("tail_reduce", "vkmr_tail_reduce", ctypes.addressof(table), _build.stream_of(out),
                          entries=table.n, cluster=table.b[0].log2n > SOLO_MAX_LOG2)


def tail_reduce(x: torch.Tensor) -> torch.Tensor:
    """(8, n <= 1024) bit-reversed digest columns -> (8,) root words."""
    _check_cols(x)
    return tail_reduce_blocks([TailEntry(x, x.shape[1].bit_length() - 1, True)])[0]


def reduce_words_body(x: torch.Tensor, log2n: int) -> torch.Tensor:
    """(8, 2^log2n) bit-reversed digest columns -> (8,) root words
    (``tree_reduce.py:223``): fold levels down to 1024 digests, then the
    tail."""
    if x.shape[1] != 1 << log2n:
        raise ValueError(f"want 2^{log2n} columns, got {x.shape[1]}")
    while x.shape[1] > 1 << TAIL_MAX_LOG2:
        x = fold_level(x)
    return tail_reduce(x)


def reduce_grouped_body(x: torch.Tensor, log2n: int, group_log2: int) -> torch.Tensor:
    """(8, 2^log2n) columns in the GROUP-BITREV layout -> (8,) root words
    (``tree_reduce.py:247``).

    The array is 2^(log2n - group_log2) contiguous groups in arrival order,
    each holding its digests at the bit reversal of their in-group index.
    The in-group levels fold every group at once down to one root per
    group; the group roots, in natural order, then reduce as a perfect
    block: the tail kernel takes natural order as it is, so handing off at
    one digest per group needs neither the JAX version's handoff transpose
    nor a gather."""
    if group_log2 >= log2n:
        return reduce_words_body(x, log2n)
    groups = 1 << (log2n - group_log2)
    for _ in range(group_log2):
        x = fold_level(x, groups=groups)
    return reduce_perfect_block(x, log2n - group_log2)


def group_bitrev_to_natural(x: torch.Tensor, log2n: int, group_log2: int) -> torch.Tensor:
    """(8, 2^log2n) group-bitrev columns -> natural order
    (``tree_reduce.py:316``): bit reversal is an involution, so each group
    is reversed in place of its index."""
    if group_log2 >= log2n:
        return bitrev_fold_words(x, log2n)
    n = 1 << log2n
    y = x.reshape(8, n >> group_log2, 1 << group_log2)
    return y.index_select(2, bitrev_index(group_log2, x.device)).reshape(8, n)


def bitrev_fold_words(cols_nat: torch.Tensor, log2n: int) -> torch.Tensor:
    """(8, 2^log2n) natural-order columns -> bit-reversed fold input
    (``tree_reduce.py:371``).  One column gather: the JAX version factors
    it into axis gathers and a transpose because random 32-byte-row gathers
    ran far off bandwidth on the TPU."""
    return cols_nat.index_select(1, bitrev_index(log2n, cols_nat.device))


def _tail_entry(cols_nat: torch.Tensor, log2n: int) -> TailEntry:
    """The tail kernel's entry for a perfect block of natural-order columns:
    the columns as they lie up to 1024 digests; above, bit-reversed with one
    gather and folded down to 1024 digests through :func:`fold_level`."""
    if log2n <= TAIL_MAX_LOG2:
        return TailEntry(cols_nat, log2n, False)
    x = bitrev_fold_words(cols_nat, log2n)
    while x.shape[1] > 1 << TAIL_MAX_LOG2:
        x = fold_level(x)
    return TailEntry(x, TAIL_MAX_LOG2, True)


def reduce_perfect_block(cols_nat: torch.Tensor, log2n: int) -> torch.Tensor:
    """Root of a perfect 2^log2n-leaf subtree from natural-order columns
    (``tree_reduce.py:401``); an (8,) int32 tensor on the input's device,
    not yet read back."""
    if log2n == 0:
        return cols_nat[:, 0].clone()
    return tail_reduce_blocks([_tail_entry(cols_nat, log2n)])[0]


def combine_ragged(block_roots: list[tuple[bytes, int]], height: int) -> bytes:
    """Host-side combine of binary-decomposition block roots
    (``tree_reduce.py:418``).

    ``block_roots``: [(digest, block_height)] in leaf order, strictly
    decreasing heights.  The running right subtree self-pairs (the phantom
    rule) up to each sibling's height, then joins it; the result is raised
    to ``height``."""
    cur, cur_h = block_roots[-1]
    for root, h in reversed(block_roots[:-1]):
        while cur_h < h:
            cur = oracle.node_hash(cur, cur)
            cur_h += 1
        cur = oracle.node_hash(root, cur)
        cur_h = h + 1
    while cur_h < height:
        cur = oracle.node_hash(cur, cur)
        cur_h += 1
    return cur


def ragged_entries(cols_nat: torch.Tensor, count: int) -> tuple[list[TailEntry], list[int]]:
    """The tail kernel's entries for the perfect blocks of the binary
    decomposition of ``count`` natural-order columns, largest first, and
    each block's height."""
    entries, heights, start = [], [], 0
    while count:
        k = count.bit_length() - 1
        entries.append(_tail_entry(cols_nat[:, start : start + (1 << k)], k))
        heights.append(k)
        start += 1 << k
        count -= 1 << k
    return entries, heights


def slice_root(cols_nat: torch.Tensor, count: int, height: int) -> bytes:
    """Root of one slice (``tree_reduce.py:439``): ``count`` natural-order
    digest columns reduced through exactly ``height`` levels (phantom full
    height for a ragged slice).  Every perfect block of the binary
    decomposition reduces in one tail launch (blocks above 1024 digests
    fold down to 1024 first) before one readback of the stacked roots."""
    if count < 1 or count > (1 << height):
        raise ValueError(f"count={count} out of range for height={height}")
    if count == 1 << height:
        return words_to_bytes(reduce_perfect_block(cols_nat, height))
    entries, heights = ragged_entries(cols_nat, count)
    stacked = tail_reduce_blocks(entries).cpu().numpy().view(np.uint32)
    return combine_ragged([(words_to_digest(w), k) for w, k in zip(stacked, heights)], height)


def merkle_root_of_digest_cols(cols_nat: torch.Tensor, count: int) -> bytes:
    """Plain Merkle root (odd-self-pair rule) of ``count`` natural-order
    columns (``tree_reduce.py:473``)."""
    return slice_root(cols_nat, count, ceil_log2(count) if count > 1 else 0)
