"""ctypes loader for the port's native host library (graceful fallback).

The port's copy of ``vk_merkle_roots_tpu/native/lib.py``, with the same
functions over the same C ABI (``vkmr_native.cpp``, ``vkmr_host_util.cpp``
beside this file): the SHA-256d leaf hasher (SHA-NI where the CPU has it),
the host Merkle reduce, the tile-major bucket packers, the line split of a
stream read and the ``rndm`` generator.
:func:`.._build.build_host_library` compiles them with ``g++`` into
``_build/`` at first use, with OpenMP where libgomp links and without it
otherwise.  If no library builds, every entry point returns None and the
callers take their pure-Python/NumPy paths (correctness never depends on the
library).
"""

from __future__ import annotations

import ctypes
import os
from functools import lru_cache

import numpy as np

ABI = 8  # vkmr_native_abi() of vkmr_native.cpp


@lru_cache(maxsize=1)
def tune_host_allocator() -> bool:
    """Keep large freed staging buffers in the malloc arena instead of
    returning them to the kernel.  Every bucket the general packer packs
    allocates a fresh wire-format buffer (several MB for a 2^16-leaf
    flush); with glibc defaults that is a fresh mmap (M_MMAP_THRESHOLD=128
    KB) whose first-touch page faults cost several times the packing work
    itself.  Raising M_MMAP_THRESHOLD alone does not help (the arena top
    gets trimmed back on free, M_TRIM_THRESHOLD, and the faults return), so
    both knobs move together.
    Cost: RSS stays at the staging high-water mark (bounded by
    host_pending_bytes + pack-ahead depth).  Set VKMR_NO_MALLOPT=1 to keep
    glibc defaults."""
    if os.environ.get("VKMR_NO_MALLOPT"):
        return False
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok = libc.mallopt(-3, 256 << 20) == 1  # M_MMAP_THRESHOLD
        ok = libc.mallopt(-1, 1 << 30) == 1 and ok  # M_TRIM_THRESHOLD
        return ok
    except OSError:
        return False


@lru_cache(maxsize=1)
def _load():
    """The library, built first if needed; None when it cannot be built or
    loaded.  Tried once a process."""
    from .._build import build_host_library

    tune_host_allocator()  # the packer path allocates a large buffer per flush
    try:
        path = build_host_library()
    except OSError:  # no writable _build/
        return None
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    if lib.vkmr_native_abi() != ABI:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.vkmr_leaf_hashes.argtypes = [u8p, i64p, i64p, ctypes.c_int64, u8p]
    lib.vkmr_merkle_root.argtypes = [u8p, ctypes.c_int64, ctypes.c_int32, u8p]
    lib.vkmr_merkle_root.restype = ctypes.c_int32
    lib.vkmr_pack_bucket_tiles.argtypes = [
        u8p, i64p, i64p, ctypes.c_int64, ctypes.c_int32, u32p, ctypes.c_int64
    ]
    lib.vkmr_pack_stream_bucket_tiles.argtypes = [
        u8p, i64p, i64p, ctypes.c_int64, ctypes.c_int32, u32p, ctypes.c_int64
    ]
    vp = ctypes.c_void_p
    lib.vkmr_wire_flush.argtypes = [
        ctypes.c_int32, vp, vp, vp, vp, vp, ctypes.c_int32, ctypes.c_int64, vp, ctypes.c_int32, vp,
        ctypes.c_int64, vp,
    ]
    lib.vkmr_wire_flush.restype = ctypes.c_int32
    lib.vkmr_split_lines.argtypes = [vp, ctypes.c_int64, ctypes.c_int64, vp, vp, ctypes.c_int64]
    lib.vkmr_split_lines.restype = ctypes.c_int64
    lib.vkmr_rndm_stream.argtypes = [
        ctypes.c_uint32,
        ctypes.c_int64,
        ctypes.c_int32,
        u8p,
        ctypes.c_int64,
    ]
    lib.vkmr_rndm_stream.restype = ctypes.c_int64
    return lib


def native_available() -> bool:
    return _load() is not None


def native_shani_active() -> bool:
    """True when the library dispatched to the hardware SHA-256 (SHA-NI)
    compression at load time (VKMR_FORCE_SCALAR=1 pins the scalar form)."""
    lib = _load()
    return bool(lib is not None and lib.vkmr_shani_active())


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _aligned_empty(shape, dtype, align=64):
    """Uninitialized aligned ndarray for the ABI-5 packers, which write
    every output row themselves (real rows with data, the quantization
    tail with zeros): a calloc here would cost more than the packing itself
    (a full-buffer read+write memset)."""
    dtype = np.dtype(dtype)
    count = int(np.prod(shape))
    buf = np.empty(count * dtype.itemsize + align, np.uint8)
    off = (-buf.ctypes.data) % align
    return buf[off : off + count * dtype.itemsize].view(dtype).reshape(shape)


def native_leaf_hashes_spans(data: np.ndarray, offsets: np.ndarray, lengths: np.ndarray):
    """(n,) spans -> (n, 32) uint8 digests, or None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, np.uint8)
    offsets = np.ascontiguousarray(offsets, np.int64)
    lengths = np.ascontiguousarray(lengths, np.int64)
    n = int(lengths.size)
    out = np.empty((n, 32), np.uint8)
    lib.vkmr_leaf_hashes(
        _ptr(data, ctypes.c_uint8),
        _ptr(offsets, ctypes.c_int64),
        _ptr(lengths, ctypes.c_int64),
        n,
        _ptr(out, ctypes.c_uint8),
    )
    return out


def native_leaf_hashes(leaves) -> list[bytes] | None:
    lib = _load()
    if lib is None:
        return None
    leaves = list(leaves)
    if not leaves:
        return []
    lengths = np.fromiter((len(x) for x in leaves), np.int64, count=len(leaves))
    offsets = np.concatenate(([0], np.cumsum(lengths)[:-1]))
    data = np.frombuffer(b"".join(leaves), np.uint8)
    out = native_leaf_hashes_spans(data, offsets, lengths)
    return [out[i].tobytes() for i in range(len(leaves))]


def native_merkle_root(digests: np.ndarray, height: int = -1) -> bytes | None:
    """Root of (n, 32) uint8 digest rows; height=-1 reduces to one node,
    height>=0 runs exactly that many levels (phantom rule)."""
    lib = _load()
    if lib is None:
        return None
    digests = np.ascontiguousarray(digests, np.uint8)
    out = np.empty(32, np.uint8)
    rc = lib.vkmr_merkle_root(
        _ptr(digests, ctypes.c_uint8),
        int(digests.shape[0]),
        int(height),
        _ptr(out, ctypes.c_uint8),
    )
    if rc != 0:
        raise ValueError(f"vkmr_merkle_root failed: rc={rc}")
    return out.tobytes()


def native_pack_bucket_tiles(
    data: np.ndarray, offsets: np.ndarray, lengths: np.ndarray, nblocks: int, tiles: int
) -> np.ndarray | None:
    """Pack an exact bucket into the tile-major device wire format
    (tiles, nblocks*16, 8, 128) — see packing.pack_spans.  Rows past
    ``lengths.size`` are zeroed by the packer (ABI 5: the output buffer
    is handed over uninitialized)."""
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, np.uint8)
    offsets = np.ascontiguousarray(offsets, np.int64)
    lengths = np.ascontiguousarray(lengths, np.int64)
    n = int(lengths.size)
    out = _aligned_empty((tiles, nblocks * 16, 8, 128), np.uint32)
    lib.vkmr_pack_bucket_tiles(
        _ptr(data, ctypes.c_uint8),
        _ptr(offsets, ctypes.c_int64),
        _ptr(lengths, ctypes.c_int64),
        n,
        nblocks,
        _ptr(out, ctypes.c_uint32),
        tiles * 1024,
    )
    return out


def native_pack_stream_bucket_tiles(
    data: np.ndarray, offsets: np.ndarray, lengths: np.ndarray, cap_blocks: int, tiles: int
) -> np.ndarray | None:
    """Stream-bucket packer, tile-major: FIPS padding at each leaf's real
    block boundary, zero words up to ``cap_blocks`` blocks
    (packing._pack_stream_tiles contract; the packer writes the zeros —
    the buffer is handed over uninitialized, ABI 5)."""
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, np.uint8)
    offsets = np.ascontiguousarray(offsets, np.int64)
    lengths = np.ascontiguousarray(lengths, np.int64)
    n = int(lengths.size)
    out = _aligned_empty((tiles, cap_blocks * 16, 8, 128), np.uint32)
    lib.vkmr_pack_stream_bucket_tiles(
        _ptr(data, ctypes.c_uint8),
        _ptr(offsets, ctypes.c_int64),
        _ptr(lengths, ctypes.c_int64),
        n,
        cap_blocks,
        _ptr(out, ctypes.c_uint32),
        tiles * 1024,
    )
    return out


def native_wire_flush(chunks, start: int, rev: np.ndarray | None, max_blocks: int, slot):
    """The engine's flush pass onto the compact wire (``vkmr_wire_flush``):
    a flush of ``(data, offsets, lengths)`` chunks written as a row table
    and the chunks' raw bytes into the buffer ``slot.buffer(nbytes)`` gives,
    in one call on this thread, with the interpreter lock released and no
    OpenMP team.  Natural leaf j of the flush lands at column ``start + j``,
    or through ``rev``, a group's bit reversal (see
    :class:`..packing.FlushColumns`).  Returns ``(buf, layout)``, ``layout``
    being ``vkmr_wire_flush``'s (the bytes in use, the byte region's start and
    length, the payload, the rows of the buckets of 1..8 blocks); None when
    the library is not loaded or the pass declines the flush (a leaf of more
    than ``min(max_blocks, 8)`` blocks, a span outside its chunk, a column
    past 32 bits, a ``rev`` entry outside its group)."""
    lib = _load()
    if lib is None:
        return None
    datas = [np.ascontiguousarray(d, np.uint8) for d, _, _ in chunks]
    offs = [np.ascontiguousarray(o, np.int64) for _, o, _ in chunks]
    lens = [np.ascontiguousarray(x, np.int64) for _, _, x in chunks]
    log2 = -1
    if rev is not None:
        rev = np.ascontiguousarray(rev, np.int64)
        log2 = rev.size.bit_length() - 1
        if rev.ndim != 1 or rev.size != 1 << log2:
            raise ValueError(f"a group permutation of {rev.shape} entries, not a power of two")
    tables = [  # kept alive through the call, as the chunks are
        np.array([d.ctypes.data for d in datas], np.uintp), np.array([d.size for d in datas], np.int64),
        np.array([o.ctypes.data for o in offs], np.uintp), np.array([x.ctypes.data for x in lens], np.uintp),
        np.array([x.size for x in lens], np.int64),
    ]
    layout = np.zeros(12, np.int64)
    buf = slot.buffer(0)
    while True:
        rc = lib.vkmr_wire_flush(
            len(chunks), *(t.ctypes.data for t in tables),
            min(int(max_blocks), 8),  # an int32; the pass takes 8 at most
            int(start), None if rev is None else rev.ctypes.data, log2,
            buf.ctypes.data, buf.size, layout.ctypes.data,
        )
        if rc != -1:
            break
        buf = slot.buffer(int(layout[0]))
    if rc == 1:
        return None
    if rc != 0:
        raise RuntimeError(f"vkmr_wire_flush failed: rc={rc}")
    return buf, layout


def native_split_lines(data: np.ndarray, n: int, begin: int = 0, expect: int | None = None):
    """``(starts, lengths)``, int64, of each line of ``data[:n]`` that a
    newline ends, the newline left out and empty lines kept
    (``vkmr_split_lines``, with the interpreter lock released); None when the
    library is not loaded.  ``data`` is C-contiguous uint8 whose first
    ``begin`` bytes hold no newline: the search starts there, the first line
    at 0.  Room is made for ``expect`` lines (default ``n // 16 + 1``); a
    buffer with more is scanned again with room for all."""
    lib = _load()
    if lib is None:
        return None
    if data.dtype != np.uint8 or data.ndim != 1 or not data.flags.c_contiguous:
        raise ValueError("the line split takes a C-contiguous 1-D uint8 buffer")
    if not 0 <= begin <= n <= data.size:
        raise ValueError(f"begin {begin} and n {n} outside a buffer of {data.size} bytes")
    cap = n // 16 + 1 if expect is None else max(int(expect), 1)
    while True:
        starts, lengths = np.empty(cap, np.int64), np.empty(cap, np.int64)
        count = lib.vkmr_split_lines(data.ctypes.data, begin, n, starts.ctypes.data, lengths.ctypes.data, cap)
        if count <= cap:
            return starts[:count], lengths[:count]
        cap = count


def native_rndm_stream(seed: int, count: int, maxlen: int) -> bytes | None:
    lib = _load()
    if lib is None:
        return None
    cap = count * (maxlen + 1)
    out = np.empty(cap, np.uint8)
    written = lib.vkmr_rndm_stream(seed & 0xFFFFFFFF, count, maxlen, _ptr(out, ctypes.c_uint8), cap)
    if written < 0:
        raise ValueError(f"vkmr_rndm_stream failed: rc={written}")
    return out[:written].tobytes()
