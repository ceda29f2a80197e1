"""CPU oracle: SHA-256d Merkle semantics in terms of ``hashlib``.

The port's copy of ``vk_merkle_roots_tpu/oracle.py``.  This module is the
port's ground truth — the byte-exact correctness gate
every device path must match.  It mirrors the reference's serial CPU engine
(``SHA-256plus.cpp:491-556``) and its slice
("sub-tree") decomposition semantics (README.md:87-96, Reductions.cpp:293):

* leaf  = SHA256(SHA256(bytes))                       (SHA-256plus.cpp:558-561)
* node  = SHA256(SHA256(L || R)) over raw 32-byte digests
* an odd element at any level is paired with itself   (SHA-256plus.cpp:525-533)
* with multiple pow-2 slices, every slice — including a partially-filled
  trailing one — is reduced to the slices' full height ("phantom full-height"
  rule: keep self-pairing past a single element), and the slice roots are then
  merged as the leaves of an ordinary Merkle tree     (README.md:94,
  Reductions.cpp:293 ``applicable = Number()>1 ? Capacity() : Count()``)
* the root of an empty stream is the empty string     (SHA-256plus.cpp:494-496)
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Sequence


def sha256(data: bytes) -> bytes:
    """Single SHA-256."""
    return hashlib.sha256(data).digest()


def sha256d(data: bytes) -> bytes:
    """Double SHA-256 (Bitcoin-style)."""
    return hashlib.sha256(hashlib.sha256(data).digest()).digest()


def leaf_hash(data: bytes) -> bytes:
    """Hash of one input string (a Merkle leaf)."""
    return sha256d(data)


def node_hash(left: bytes, right: bytes) -> bytes:
    """Hash of an interior node from two raw 32-byte child digests."""
    return sha256d(left + right)


def _reduce_one_level(level: list[bytes]) -> list[bytes]:
    out = []
    for i in range(0, len(level), 2):
        left = level[i]
        right = level[i + 1] if i + 1 < len(level) else left
        out.append(node_hash(left, right))
    return out


def merkle_root_of_digests(digests: Sequence[bytes]) -> bytes:
    """Merkle root over pre-hashed leaves with the odd-self-pair rule at
    every level.  A single digest is its own root."""
    level = list(digests)
    if not level:
        raise ValueError("cannot take the Merkle root of zero digests")
    while len(level) > 1:
        level = _reduce_one_level(level)
    return level[0]


def merkle_root(leaves: Iterable[bytes]) -> bytes:
    """Merkle root of raw byte-string leaves (the whole-stream semantic the
    CLI exposes)."""
    return merkle_root_of_digests([leaf_hash(x) for x in leaves])


def reduce_slice(digests: Sequence[bytes], height: int) -> bytes:
    """Reduce one slice's digests through exactly ``height`` levels.

    This is the phantom-full-height rule: a partially-filled slice keeps
    self-pairing even after it is down to one element, so its root is the
    global tree's node at exactly ``height`` levels above the leaves
    (Reductions.cpp:293, README.md:94).
    """
    if not digests:
        raise ValueError("cannot reduce an empty slice")
    if len(digests) > (1 << height):
        raise ValueError(f"{len(digests)} digests exceed 2^{height} slice capacity")
    level = list(digests)
    for _ in range(height):
        level = _reduce_one_level(level)
    assert len(level) == 1
    return level[0]


def merkle_proof_of_digests(
    digests: Sequence[bytes], index: int, height: int | None = None
) -> list[tuple[bytes, str]]:
    """Authentication path for leaf ``index``: bottom-up list of
    (sibling_digest, side) where side is "L"/"R" = which side the *sibling*
    sits on.  Odd nodes self-pair (the sibling is the node itself), and with
    an explicit ``height`` the phantom full-height levels are included —
    so a path through a ragged slice verifies against the slice's
    phantom-height root.

    The reference lists proof generation as unimplemented future work
    (its README.md:118-120); this provides it.
    """
    if not 0 <= index < len(digests):
        raise IndexError(f"leaf index {index} out of range [0, {len(digests)})")
    level = list(digests)
    idx = index
    path: list[tuple[bytes, str]] = []
    levels = height if height is not None else (len(level) - 1).bit_length()
    for _ in range(levels):
        sib = idx ^ 1
        sibling = level[sib] if sib < len(level) else level[idx]
        path.append((sibling, "L" if idx & 1 else "R"))
        level = _reduce_one_level(level)
        idx //= 2
    assert len(level) == 1
    return path


def verify_proof(leaf_digest: bytes, path: Sequence[tuple[bytes, str]]) -> bytes:
    """Fold an authentication path from a leaf digest up to the root it
    proves membership under."""
    cur = leaf_digest
    for sibling, side in path:
        cur = node_hash(cur, sibling) if side == "R" else node_hash(sibling, cur)
    return cur


def merkle_proof(leaves: Sequence[bytes], index: int) -> list[tuple[bytes, str]]:
    """Authentication path for raw leaf ``index`` of the whole-stream tree."""
    return merkle_proof_of_digests([leaf_hash(x) for x in leaves], index)


def merkle_root_sliced(leaves: Sequence[bytes], slice_log2: int) -> bytes:
    """Merkle root via the reference's slice decomposition: split leaves into
    consecutive 2^slice_log2-leaf slices, reduce each independently, then take
    the Merkle root of the slice roots.

    Identical to ``merkle_root`` for every (len(leaves), slice_log2) — the
    property tests assert this equivalence, which is what makes the device
    pipeline's slice-at-a-time processing sound.
    """
    if not leaves:
        raise ValueError("cannot take the Merkle root of zero leaves")
    cap = 1 << slice_log2
    digests = [leaf_hash(x) for x in leaves]
    slices = [digests[i : i + cap] for i in range(0, len(digests), cap)]
    if len(slices) == 1:
        # Single-slice stream: reduce only as far as needed, like the
        # reference's Count()-levels rule for slice #1 (Reductions.cpp:293).
        return merkle_root_of_digests(slices[0])
    roots = [reduce_slice(s, slice_log2) for s in slices]
    return merkle_root_of_digests(roots)
