"""Power-of-two / bit-permutation helpers.

Equivalent role to the reference's math utilities (``Utils.h:19-73``:
``is_pow2``, ``largest_pow2_le``), plus the bit-reversal machinery that the device reduction
layout is built on (the reference has no analog: its adjacent-pair reduction
indexes with strides inside the shader, SHA-256.comp:395, whereas we store
digests in bit-reversed leaf order so every tree level is an elementwise
fold of the first half with the second half, which coalesces on the GPU).
The port's copy of ``vk_merkle_roots_tpu/utils/bitmath.py``.
"""

from __future__ import annotations

import numpy as np


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def largest_pow2_le(n: int) -> int:
    if n < 1:
        raise ValueError("need n >= 1")
    return 1 << (n.bit_length() - 1)


def ceil_log2(n: int) -> int:
    if n < 1:
        raise ValueError("need n >= 1")
    return (n - 1).bit_length()


def bit_reverse_indices(log2n: int) -> np.ndarray:
    """``out[i]`` = the ``log2n``-bit reversal of ``i``.

    With leaves stored at position ``rev(i)``, the parent of natural-order
    pair ``(2i, 2i+1)`` lives at position ``i`` of the next level and its
    children sit at positions ``i`` and ``i + n/2``: every Merkle level
    becomes ``H(first_half, second_half)`` elementwise.  (Proof sketch:
    ``rev_k(2i) = rev_{k-1}(i)`` and ``rev_k(2i+1) = rev_{k-1}(i) + 2^{k-1}``.)
    """
    n = 1 << log2n
    idx = np.arange(n, dtype=np.uint64)
    rev = np.zeros(n, dtype=np.uint64)
    for b in range(log2n):
        rev |= ((idx >> np.uint64(b)) & np.uint64(1)) << np.uint64(log2n - 1 - b)
    return rev.astype(np.int64)
