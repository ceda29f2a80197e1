"""Stream generators of the upstream ``rndm`` feed, frozen for the benchmark.

Upstream (``src/rndm/Rndm.cpp:20-71`` of viathefalcon/vk_merkle_roots):
``rndm seed count maxlen`` writes ``count`` newline-terminated strings of
printable ASCII, each ``1 + rand() % (maxlen - 1)`` bytes long.

* :func:`generate_glibc` is a pure-Python copy of the port's
  ``tools/rndm.py`` glibc mode (``srand``/``rand``, TYPE_3): byte for byte
  the upstream binary's stream on glibc.  The canonical
  ``rndm 1712489279 1024 127`` comes from it.
* :func:`numpy_stream` makes the cells' streams.  Its lengths are drawn as
  the port's numpy mode draws them (``1 + integers(0, maxlen - 1)``), and
  its bytes are raw PCG64 output mapped to the 64 printable characters
  32..95.  The port's numpy mode draws each byte with a bounded
  ``integers`` call, at ~50 MB/s; this draw takes ~1 s for a 546 MB stream,
  which every run pays in set-up.  SHA-256 costs the same whatever the
  bytes are, so only the lengths shape the work.

Nothing here imports the port: the yardstick must not move when the
program does.
"""

from __future__ import annotations

import numpy as np

NEWLINE = 0x0A


class GlibcRand:
    """glibc ``srand``/``rand`` (TYPE_3 additive feedback).

    State: 34 seeded values; r[i] = r[i-31] + r[i-3] (mod 2^32); the first
    310 outputs after seeding are discarded; each output is the new state
    value shifted right by one.
    """

    def __init__(self, seed: int) -> None:
        seed = seed & 0xFFFFFFFF
        if seed == 0:
            seed = 1
        r = [0] * 344
        r[0] = seed
        # Lehmer LCG seeding of the first 31 entries, with the overflow-free
        # Schrage decomposition of 16807 * x mod (2^31 - 1).
        for i in range(1, 31):
            prev = r[i - 1]
            if prev >= 0x80000000:  # interpret as signed
                prev -= 0x100000000
            hi = int(prev / 127773)  # C division truncates toward zero
            lo = prev - hi * 127773
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 0x7FFFFFFF
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        for i in range(34, 344):
            r[i] = (r[i - 31] + r[i - 3]) & 0xFFFFFFFF
        self._ring = r[344 - 31 :]
        self._pos = 0  # index of r[i-31] within the ring

    def rand(self) -> int:
        ring = self._ring
        pos = self._pos
        val = (ring[pos] + ring[(pos + 28) % 31]) & 0xFFFFFFFF
        ring[pos] = val
        self._pos = (pos + 1) % 31
        return val >> 1


def generate_glibc(seed: int, count: int, maxlen: int) -> bytes:
    """The upstream binary's stream on glibc (slow: for small counts)."""
    if maxlen < 2:
        raise ValueError("maxlen must be >= 2")
    rng = GlibcRand(seed)
    out = bytearray()
    for _ in range(count):
        length = 1 + rng.rand() % (maxlen - 1)
        for _ in range(length):
            out.append(32 + rng.rand() % 94)
        out.append(NEWLINE)
    return bytes(out)


def numpy_stream(seed, count: int, maxlen: int) -> bytes:
    """``count`` newline-terminated lines of 1..maxlen-1 printable bytes,
    the same for the same ``seed`` (an int or a sequence of ints, as
    ``numpy.random.default_rng`` takes it)."""
    if maxlen < 2 or count < 1:
        raise ValueError("need maxlen >= 2 and count >= 1")
    rng = np.random.default_rng(seed)
    lens = 1 + rng.integers(0, maxlen - 1, size=count)
    ends = np.cumsum(lens + 1)
    total = int(ends[-1])
    out = rng.bit_generator.random_raw(-(-total // 8)).view(np.uint8)[:total]
    np.right_shift(out, 2, out=out)
    np.add(out, 32, out=out)
    out[ends - 1] = NEWLINE
    return out.tobytes()
