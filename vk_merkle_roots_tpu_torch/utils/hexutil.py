"""Hex / digest formatting helpers (role of ``Debug.{h,cpp}`` in the
reference, e.g. ``print_bytes`` at ``Debug.cpp:38-47``
which renders the final root digest)."""

from __future__ import annotations

import numpy as np


def digest_to_hex(digest: bytes) -> str:
    """Lowercase hex of a digest, byte order as-is (the canonical SHA-256
    presentation, matching ``hashlib.sha256().hexdigest()``)."""
    return digest.hex()


def words_to_digest(words: np.ndarray) -> bytes:
    """Serialize 8 big-endian u32 digest words to the canonical 32 bytes."""
    w = np.asarray(words, dtype=np.uint32).reshape(8)
    return w.astype(">u4").tobytes()



def digest_to_words(digest: bytes) -> np.ndarray:
    """Inverse of :func:`words_to_digest`."""
    return np.frombuffer(digest, dtype=">u4").astype(np.uint32)
